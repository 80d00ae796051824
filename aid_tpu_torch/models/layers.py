"""UNet building blocks as PyTorch modules (NCHW, diffusers parameter names).

Counterpart of ``aid_tpu.models.layers``. Each module carries the diffusers
parameter names (``attn1.to_q``, ``to_out.0``, ``ff.net.0.proj``,
``time_emb_proj``, ...), so a module's ``state_dict()`` maps 1:1 onto
``aid_tpu.models.params.convert_unet_state_dict`` and onto diffusers
checkpoints. Every attention layer takes an optional :class:`AidContext`:
the AID processor family is a per-call mode plus a per-frame coefficient
vector, not module state.

The fused GroupNorm+SiLU resnet prologue is here as in the JAX package and
off by default as there (``_FUSED_GN_CONV = False``): switched on, every
resnet conv of the classes ``gn_conv_fused`` names runs
``ops.conv.conv3x3_gnsilu`` (its kernel on CUDA, its plain version on the
CPU) with the same parameters, so the ``state_dict`` is the same either way.

A cross-attention layer of a UNet with IP tokens (``ip_num_tokens > 0``)
holds the IP-Adapter's ``to_k_ip`` / ``to_v_ip`` and adds its image-prompt
branch (aid_tpu/models/layers.py:455-493): attention of the layer's queries
over the projected image tokens, in the mode ``AidMode.ip`` names, through
the same ``dispatch_attention`` (its kernel on CUDA).

Frame sharding (aid_tpu/models/layers.py:411-431, 463-476): where the
forward's :class:`AidContext` carries a :class:`FrameShard`, the batch is
one rank's contiguous slice of a longer frame sequence. Every interpolating
attention then takes its endpoints from the GLOBAL frames 0 and N-1 (the
K/V rows all-gathered over the frame group, passed on as shared (H, L, D)
endpoints) and its skip rows from the global frame index. The module needs
no copy for it: PyTorch runs eagerly, so the shard is a per-forward input,
not a traced field.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from aid_tpu_torch.ops.attention import AttnMode, dispatch_attention
from aid_tpu_torch.ops.conv import conv3x3_gnsilu, conv3x3_same


@dataclasses.dataclass(frozen=True)
class AidMode:
    """AID behaviour for one UNet forward pass.

    ``text``: interpolation mode of the native (self/cross text) attention
    branch of every layer.
    ``ip``: the image-prompt branch when an IP-Adapter is loaded: None (no
    branch), ``"own"`` (each frame attends its own IP tokens, the vanilla
    IP-Adapter) or one of the four interpolating modes' names.
    ``ip_coef_scaled``: the IP branch is weighted by the frame's
    coefficient instead of the adapter's scale (scale control).
    ``cfg_split``: batched-CFG split point. When set to N, the batch is
    [N cond frames; N uncond frames] in ONE forward: cond rows take their
    endpoints from cond rows 0 / N-1, uncond rows use their OWN K/V as both
    endpoints, which reduces every AID mode exactly to vanilla attention.
    """

    text: AttnMode = AttnMode.SELF
    ip: Optional[str] = None
    ip_coef_scaled: bool = False
    cfg_split: Optional[int] = None

    @staticmethod
    def vanilla(has_ip: bool = False, scale_control: bool = False) -> "AidMode":
        if scale_control:
            return AidMode(text=AttnMode.SELF, ip="own", ip_coef_scaled=True)
        return AidMode(text=AttnMode.SELF, ip="own" if has_ip else None)

    @staticmethod
    def from_name(name: str, has_ip: bool = False) -> "AidMode":
        """Map the reference's early/late strings to an AidMode;
        ``"scale_control"`` is text ``fused_outer`` with the IP branch
        ``"own"`` and coefficient-scaled."""
        if name == "self":
            return AidMode.vanilla(has_ip=has_ip)
        if name == "scale_control":
            return AidMode(text=AttnMode.FUSED_OUTER, ip="own", ip_coef_scaled=True)
        return AidMode(text=AttnMode(name), ip=name if has_ip else None)


@dataclasses.dataclass(frozen=True)
class FrameShard:
    """One rank's slice of a frame-sharded sequence
    (``parallel.sharded_denoise_sequence``): ``group`` is the process group
    over the frame shards, whose rank r holds the global frames
    [r * B, (r + 1) * B); ``offset`` is the global index of this shard's
    first frame and ``total`` the global frame count."""

    group: Any
    offset: int
    total: int

    def endpoints(self, x: torch.Tensor):
        """The GLOBAL frames 0 and N-1 of ``x`` (this shard's (B, H, S, D))
        as shared (H, S, D) endpoints: every shard's first and last rows are
        all-gathered over the group (two collectives), and group rank 0's
        first row and the last rank's last row kept."""
        import torch.distributed as dist

        n = dist.get_world_size(self.group)
        out = []
        for row in (x[0].contiguous(), x[-1].contiguous()):
            parts = [torch.empty_like(row) for _ in range(n)]
            dist.all_gather(parts, row, group=self.group)
            out.append(parts)
        return out[0][0], out[1][-1]


@dataclasses.dataclass
class AidContext:
    """AID inputs for one UNet forward pass: ``coef`` (B,) per-frame
    interpolation coefficients and the :class:`AidMode`.

    ``force_vanilla``: optional bool, scalar (a Python bool or a 0-d tensor)
    or (B,), rows whose attention is computed as vanilla attention although
    the mode interpolates (the fused denoise loop's late steps).
    ``ip_hidden_states``: (B, T, cross_attention_dim) projected image-prompt
    tokens of this pass, or None (no IP branch).
    ``ip_scale``: the adapter's global scale.
    ``frames``: the :class:`FrameShard` this batch is, or None (the whole
    sequence)."""

    coef: torch.Tensor
    mode: AidMode = AidMode()
    force_vanilla: Optional[Union[bool, torch.Tensor]] = None
    ip_hidden_states: Optional[torch.Tensor] = None
    ip_scale: float = 1.0
    frames: Optional[FrameShard] = None
    _skip: dict = dataclasses.field(default_factory=dict, init=False, repr=False, compare=False)

    def skip_rows(self, n_cond: int) -> torch.Tensor:
        """``skip_mask(coef, n_cond)``, computed on the first attention layer
        that asks and kept for the others of the forward."""
        if n_cond not in self._skip:
            self._skip[n_cond] = skip_mask(self.coef, n_cond)
        return self._skip[n_cond]

    def frame_skip_rows(self) -> torch.Tensor:
        """This shard's skip rows by GLOBAL frame index (``frame_skip_mask``),
        kept apart from the local rows' cache."""
        key = ("frames", self.frames.offset, self.frames.total)
        if key not in self._skip:
            self._skip[key] = frame_skip_mask(self.coef, self.frames.offset, self.frames.total)
        return self._skip[key]

    def endpoint_kv(self, k: torch.Tensor, v: torch.Tensor) -> dict:
        """Under frame sharding, the global endpoint K/V of an interpolating
        attention (four all-gathers), or none where every row is forced
        vanilla: ``force_vanilla`` is the same on every rank (the fused
        loop's step index), so every rank skips the same collectives."""
        if self.force_vanilla is True:
            return {}
        kb, ke = self.frames.endpoints(k)
        vb, ve = self.frames.endpoints(v)
        return dict(k_begin=kb, v_begin=vb, k_end=ke, v_end=ve)


def timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    flip_sin_to_cos: bool = True,
    freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """Sinusoidal timestep embedding (diffusers get_timestep_embedding), f32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """Two-layer MLP over the sinusoidal embedding (linear_1, SiLU, linear_2)."""

    def __init__(self, in_dim: int, out_dim: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, out_dim, device=device, dtype=dtype)
        self.linear_2 = nn.Linear(out_dim, out_dim, device=device, dtype=dtype)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


def conv_lowering(hw: int, cin: int) -> str:
    """"kernel" for the 3x3-conv class the JAX package sends to its Pallas
    kernel (cin >= 512 at hw > 4096: the SDXL up-block convs at 128x128,
    aid_tpu/models/layers.py:153-159), "torch" (F.conv2d) for every other
    class, which the JAX package leaves to XLA."""
    return "kernel" if hw > 4096 and cin >= 512 else "torch"


# Routing flag for the fused GN+SiLU+conv resnet prologue, as
# aid_tpu/models/layers.py:167-171: off by default (the JAX package measured
# it slower on the TPU v5e; on the H100 chip_smoke.py measures both ways).
_FUSED_GN_CONV = False


def gn_conv_fused(hw: int, cin: int) -> bool:
    """The classes whose resnet GN+SiLU prologue fuses into the conv when
    ``_FUSED_GN_CONV`` is on: the UNet's spatial range at cin >= 320
    (aid_tpu/models/layers.py:174-182)."""
    return _FUSED_GN_CONV and 1024 <= hw <= 16384 and cin >= 320


class Conv3x3(nn.Module):
    """3x3 same-padding conv (weight (Cout, Cin, 3, 3) + bias, as nn.Conv2d).

    The wide high-resolution class goes through ``ops.conv.conv3x3_same``:
    its hand-written kernel on CUDA, ``F.conv2d`` on the CPU.
    """

    def __init__(self, in_channels: int, out_channels: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 3, 3, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(out_channels, device=device, dtype=dtype))
        # nn.Conv2d's default init
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        bound = 1.0 / math.sqrt(in_channels * 9)
        nn.init.uniform_(self.bias, -bound, bound)

    def forward(self, x):
        _, cin, H, W = x.shape
        if conv_lowering(H * W, cin) == "kernel":
            return conv3x3_same(x, self.weight, self.bias)
        return F.conv2d(x, self.weight, self.bias, padding=1)


class ResnetBlock2D(nn.Module):
    """diffusers ResnetBlock2D: GN-SiLU-Conv x2 with timestep injection."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: int, norm_num_groups: int = 32,
                 *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = nn.GroupNorm(norm_num_groups, in_channels, eps=1e-5, **kw)
        self.conv1 = Conv3x3(in_channels, out_channels, **kw)
        self.time_emb_proj = nn.Linear(temb_channels, out_channels, **kw)
        self.norm2 = nn.GroupNorm(norm_num_groups, out_channels, eps=1e-5, **kw)
        self.conv2 = Conv3x3(out_channels, out_channels, **kw)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1, **kw)
                              if in_channels != out_channels else None)

    @staticmethod
    def _gn_silu_conv(h, norm: nn.GroupNorm, conv: Conv3x3):
        """norm -> SiLU -> 3x3 conv; one fused op on the ``gn_conv_fused``
        classes (the GroupNorm module then only holds gamma and beta)."""
        _, cin, H, W = h.shape
        if gn_conv_fused(H * W, cin) and cin % norm.num_groups == 0:
            return conv3x3_gnsilu(h, conv.weight, conv.bias, norm.weight, norm.bias, norm.num_groups, norm.eps)
        return conv(F.silu(norm(h)))

    def forward(self, x, temb):
        h = self._gn_silu_conv(x, self.norm1, self.conv1)
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self._gn_silu_conv(h, self.norm2, self.conv2)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv with padding 1."""

    def __init__(self, channels: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1, device=device, dtype=dtype)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest x2 upsample, then a 3x3 conv."""

    def __init__(self, channels: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.conv = Conv3x3(channels, channels, device=device, dtype=dtype)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


def skip_mask(c: torch.Tensor, n_cond: int) -> torch.Tensor:
    """Rows whose endpoint attention segments are provably no-ops: coef-0/1
    frames whose endpoint is their own K/V, and (batched CFG) uncond rows
    whose endpoints are their own."""
    row = torch.arange(c.shape[0], device=c.device)
    cond_skip = ((row == 0) & (c == 0.0)) | ((row == n_cond - 1) & (c == 1.0))
    return torch.where(row < n_cond, cond_skip, torch.ones_like(cond_skip))


def frame_skip_mask(c: torch.Tensor, offset: int, total: int) -> torch.Tensor:
    """``skip_mask`` of one shard of a ``total``-frame sequence whose first
    row is global frame ``offset`` (aid_tpu/models/layers.py:419-424): only
    global frame 0 at coefficient 0 and global frame N-1 at coefficient 1
    attend their own K/V through an endpoint segment. A shard's own first or
    last row at 0 or 1 in the interior of the sequence is not skipped."""
    row = offset + torch.arange(c.shape[0], device=c.device)
    return ((row == 0) & (c == 0.0)) | ((row == total - 1) & (c == 1.0))


def per_row_endpoints(x: torch.Tensor, n: int):
    """Rows [0, n): endpoints = cond rows 0 / n-1; rows [n, 2n): their own."""
    b0 = x[0:1].expand(n, *x.shape[1:])
    e0 = x[n - 1:n].expand(n, *x.shape[1:])
    return torch.cat([b0, x[n:]], dim=0), torch.cat([e0, x[n:]], dim=0)


class CrossAttention(nn.Module):
    """Multi-head attention with the AID interpolation family built in.
    ``has_ip`` (cross-attention layers of a UNet with IP tokens) adds the
    IP-Adapter's bias-free ``to_k_ip`` / ``to_v_ip`` over the
    ``cross_attention_dim``-wide image tokens."""

    def __init__(self, query_dim: int, num_heads: int, head_dim: int, cross_attention_dim: Optional[int] = None,
                 has_ip: bool = False, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        inner = num_heads * head_dim
        kv_dim = cross_attention_dim or query_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False, **kw)
        self.to_k = nn.Linear(kv_dim, inner, bias=False, **kw)
        self.to_v = nn.Linear(kv_dim, inner, bias=False, **kw)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim, **kw)])
        self.has_ip = has_ip
        if has_ip:
            self.to_k_ip = nn.Linear(kv_dim, inner, bias=False, **kw)
            self.to_v_ip = nn.Linear(kv_dim, inner, bias=False, **kw)

    def forward(self, hidden, encoder_hidden=None, aid: Optional[AidContext] = None):
        B, S, _ = hidden.shape
        kv_src = hidden if encoder_hidden is None else encoder_hidden

        def heads(x):  # (B, S, H*D) -> (B, H, S, D) view, no copy
            return x.view(x.shape[0], x.shape[1], self.num_heads, self.head_dim).transpose(1, 2)

        q, k, v = heads(self.to_q(hidden)), heads(self.to_k(kv_src)), heads(self.to_v(kv_src))
        mode = AttnMode.SELF if aid is None else aid.mode.text
        coef = None if aid is None else aid.coef  # self mode reads no coefficients
        eps, skip, force = {}, None, None
        if mode != AttnMode.SELF:
            if aid.frames is not None:
                if aid.mode.cfg_split:
                    raise ValueError("batched CFG is not supported under frame sharding")
                eps = aid.endpoint_kv(k, v)
                skip = aid.frame_skip_rows()
            elif aid.mode.cfg_split:
                n = aid.mode.cfg_split
                kb, ke = per_row_endpoints(k, n)
                vb, ve = per_row_endpoints(v, n)
                eps = dict(k_begin=kb, v_begin=vb, k_end=ke, v_end=ve)
                skip = aid.skip_rows(n)
            else:
                skip = aid.skip_rows(B)
            force = aid.force_vanilla
            if force is not None:  # forced rows drop their endpoint segments too (aid_tpu/models/layers.py:444-445)
                skip = skip | torch.as_tensor(force, dtype=torch.bool, device=skip.device)
        out = dispatch_attention(q, k, v, coef, mode, skip_endpoints=skip, force_vanilla=force, **eps)
        if self.has_ip and aid is not None and aid.mode.ip is not None and aid.ip_hidden_states is not None:
            out = self._add_ip(q, out, aid, heads)
        out = out.transpose(1, 2).reshape(B, S, self.num_heads * self.head_dim)
        return self.to_out[0](out)

    def _add_ip(self, q, out, aid: AidContext, heads):
        """``out`` plus the IP branch (aid_tpu/models/layers.py:463-493): the
        queries over the image tokens' K/V in ``aid.mode.ip``'s mode
        (``"own"``: each frame's own tokens, self mode). Under batched CFG
        the interpolating modes take per-row endpoints as the text branch
        does, but no skip rows: only ``force_vanilla`` drops endpoint
        segments here (``dispatch_attention`` folds it). Under frame
        sharding they take the global endpoints and skip rows, as the text
        branch does (aid_tpu/models/layers.py:468-473). The branch adds
        ``ip_scale`` times its output, the scale in the output's dtype, or
        (scale control) the frame's coefficient times it, summed in f32."""
        ip = aid.ip_hidden_states.to(q.dtype)
        ip_k, ip_v = heads(self.to_k_ip(ip)), heads(self.to_v_ip(ip))
        ip_mode = AttnMode.SELF if aid.mode.ip == "own" else AttnMode(aid.mode.ip)
        eps, skip, force = {}, None, None
        if ip_mode != AttnMode.SELF:
            if aid.frames is not None:
                eps = aid.endpoint_kv(ip_k, ip_v)
                skip = aid.frame_skip_rows()
            elif aid.mode.cfg_split:
                kb, ke = per_row_endpoints(ip_k, aid.mode.cfg_split)
                vb, ve = per_row_endpoints(ip_v, aid.mode.cfg_split)
                eps = dict(k_begin=kb, v_begin=vb, k_end=ke, v_end=ve)
            force = aid.force_vanilla
        ip_out = dispatch_attention(q, ip_k, ip_v, aid.coef, ip_mode, skip_endpoints=skip, force_vanilla=force,
                                    **eps)
        if aid.mode.ip_coef_scaled:
            w = aid.coef.float().reshape(-1, 1, 1, 1)
            return (out.float() + w * ip_out.float()).to(out.dtype)
        # a 0-d CPU tensor enters the CUDA op as a scalar: a device tensor
        # made from the float would be a host-to-device copy, which waits for
        # the stream on every call
        return out + torch.tensor(aid.ip_scale, dtype=out.dtype) * ip_out


class GEGLU(nn.Module):
    """Linear to 2*inner, then x * gelu(gate) with the tanh approximation
    (flax ``nn.gelu`` defaults to approximate=True, unlike diffusers)."""

    def __init__(self, dim: int, inner: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2, device=device, dtype=dtype)

    def forward(self, x):
        x_p, gate = self.proj(x).chunk(2, dim=-1)
        return x_p * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    """GEGLU feed-forward; ``net.0.proj`` and ``net.2`` as in diffusers."""

    def __init__(self, dim: int, mult: int = 4, *, device=None, dtype=torch.float32):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([
            GEGLU(dim, inner, device=device, dtype=dtype),
            nn.Identity(),  # diffusers' dropout slot, keeps net.2's index
            nn.Linear(inner, dim, device=device, dtype=dtype),
        ])

    def forward(self, x):
        for layer in self.net:
            x = layer(x)
        return x


class BasicTransformerBlock(nn.Module):
    """LN->self-attn, LN->cross-attn, LN->GEGLU FF, all residual. AID applies
    to both attn1 and attn2."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, cross_attention_dim: int, has_ip: bool = False,
                 *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5, **kw)
        self.attn1 = CrossAttention(dim, num_heads, head_dim, **kw)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5, **kw)
        self.attn2 = CrossAttention(dim, num_heads, head_dim, cross_attention_dim, has_ip, **kw)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5, **kw)
        self.ff = FeedForward(dim, **kw)

    def forward(self, x, encoder_hidden, aid: Optional[AidContext] = None):
        x = x + self.attn1(self.norm1(x), None, aid)
        x = x + self.attn2(self.norm2(x), encoder_hidden, aid)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """diffusers Transformer2DModel: GN -> proj_in -> blocks -> proj_out + residual."""

    def __init__(self, in_channels: int, num_heads: int, head_dim: int, num_layers: int,
                 cross_attention_dim: int, norm_num_groups: int = 32, use_linear_projection: bool = False,
                 has_ip: bool = False, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        inner = num_heads * head_dim
        self.use_linear_projection = use_linear_projection
        self.norm = nn.GroupNorm(norm_num_groups, in_channels, eps=1e-6, **kw)
        if use_linear_projection:
            self.proj_in = nn.Linear(in_channels, inner, **kw)
            self.proj_out = nn.Linear(inner, in_channels, **kw)
        else:
            self.proj_in = nn.Conv2d(in_channels, inner, 1, **kw)
            self.proj_out = nn.Conv2d(inner, in_channels, 1, **kw)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, num_heads, head_dim, cross_attention_dim, has_ip, **kw)
            for _ in range(num_layers)
        ])

    def forward(self, x, encoder_hidden, aid: Optional[AidContext] = None):
        B, C, H, W = x.shape
        residual = x
        x = self.norm(x)
        if self.use_linear_projection:
            x = self.proj_in(x.permute(0, 2, 3, 1).reshape(B, H * W, C))
        else:
            x = self.proj_in(x)
            x = x.permute(0, 2, 3, 1).reshape(B, H * W, x.shape[1])
        for block in self.transformer_blocks:
            x = block(x, encoder_hidden, aid)
        if self.use_linear_projection:
            x = self.proj_out(x).reshape(B, H, W, C).permute(0, 3, 1, 2)
        else:
            x = self.proj_out(x.reshape(B, H, W, -1).permute(0, 3, 1, 2))
        return x + residual
