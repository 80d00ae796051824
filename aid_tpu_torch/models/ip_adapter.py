"""IP-Adapter image projections: CLIP image embeds -> cross-attention tokens.

Counterpart of ``aid_tpu.models.ip_adapter``. ``ImageProjection`` is the
standard adapter's (h94/IP-Adapter ``ip-adapter_sd15``): a Linear to
``num_tokens`` tokens, then a LayerNorm. ``Resampler`` is IP-Adapter-Plus's
perceiver resampler over the CLIP vision tower's penultimate hidden states
(``ip-adapter-plus_sd15``, ostris/ip-composition-adapter). Both carry the
checkpoint's own parameter names, so an h94-format ``image_proj`` dict loads
with ``load_state_dict(strict=True)``:

  * ``ImageProjection``: ``proj``, ``norm``;
  * ``Resampler``: ``latents``, ``proj_in``, ``proj_out``, ``norm_out``,
    ``layers.<i>.0.{norm1,norm2,to_q,to_kv,to_out}`` (the attention) and
    ``layers.<i>.1.{0,1,3}`` (LayerNorm, fc1, fc2 of the feed-forward).

Two choices of the JAX package that the port keeps:
  * the feed-forward's gelu is the tanh approximation (flax ``nn.gelu``'s
    default), not the original resampler's exact GELU;
  * the attention logits are scaled by ``dim_head ** -0.5`` once (the
    original scales q and k by ``dim_head ** -0.25`` each), accumulated in
    f32 before the probabilities are cast to the input dtype.

The per-layer ``to_k_ip`` / ``to_v_ip`` projections live in the UNet's
cross-attention layers (``models.layers.CrossAttention``). The resampler's
attention is a plain ``torch.matmul`` and softmax: the JAX package leaves it
to XLA, so no kernel stands behind it.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn


class ImageProjection(nn.Module):
    """(B, D) CLIP image embeds -> (B, num_tokens, cross_attention_dim):
    Linear(D, num_tokens * cross_attention_dim), then LayerNorm(eps 1e-5)."""

    def __init__(self, embed_dim: int, cross_attention_dim: int, num_tokens: int = 4, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cross_attention_dim, self.num_tokens = cross_attention_dim, num_tokens
        self.proj = nn.Linear(embed_dim, num_tokens * cross_attention_dim, **kw)
        self.norm = nn.LayerNorm(cross_attention_dim, eps=1e-5, **kw)

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        x = self.proj(image_embeds.to(self.proj.weight.dtype))
        return self.norm(x.reshape(x.shape[0], self.num_tokens, self.cross_attention_dim))


class PerceiverAttention(nn.Module):
    """Latent queries attend over [image features; latents]."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 16, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        inner = dim_head * heads
        self.dim_head, self.heads = dim_head, heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-5, **kw)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5, **kw)
        self.to_q = nn.Linear(dim, inner, bias=False, **kw)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False, **kw)
        self.to_out = nn.Linear(inner, dim, bias=False, **kw)

    def forward(self, x: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
        x, latents = self.norm1(x), self.norm2(latents)
        b, nq, _ = latents.shape
        q = self.to_q(latents)
        k, v = self.to_kv(torch.cat([x, latents], dim=-2)).chunk(2, dim=-1)

        def heads(t):  # (b, n, heads * dim_head) -> (b, heads, n, dim_head)
            return t.reshape(b, t.shape[1], self.heads, self.dim_head).transpose(1, 2)

        q, k, v = heads(q), heads(k), heads(v)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * self.dim_head ** -0.5
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, nq, self.heads * self.dim_head)
        return self.to_out(out)


class Resampler(nn.Module):
    """IP-Adapter-Plus projection: (B, S, embed_dim) penultimate CLIP vision
    hidden states -> (B, num_queries, cross_attention_dim)."""

    def __init__(self, cross_attention_dim: int, embed_dim: int, hidden_dim: int = 768, depth: int = 4,
                 dim_head: int = 64, heads: int = 12, num_queries: int = 16, ffn_mult: int = 4, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.latents = nn.Parameter(torch.randn(1, num_queries, hidden_dim, **kw) * 0.02)
        self.proj_in = nn.Linear(embed_dim, hidden_dim, **kw)
        self.proj_out = nn.Linear(hidden_dim, cross_attention_dim, **kw)
        self.norm_out = nn.LayerNorm(cross_attention_dim, eps=1e-5, **kw)
        self.layers = nn.ModuleList([
            nn.ModuleList([
                PerceiverAttention(hidden_dim, dim_head, heads, **kw),
                nn.Sequential(
                    nn.LayerNorm(hidden_dim, eps=1e-5, **kw),
                    nn.Linear(hidden_dim, hidden_dim * ffn_mult, bias=False, **kw),
                    nn.GELU(approximate="tanh"),
                    nn.Linear(hidden_dim * ffn_mult, hidden_dim, bias=False, **kw),
                ),
            ])
            for _ in range(depth)
        ])

    def forward(self, image_hidden: torch.Tensor) -> torch.Tensor:
        x = self.proj_in(image_hidden.to(self.proj_in.weight.dtype))
        latents = self.latents.expand(x.shape[0], -1, -1)
        for attn, ff in self.layers:
            latents = latents + attn(x, latents)
            latents = latents + ff(latents)
        return self.norm_out(self.proj_out(latents))


def image_projection_from_state_dict(image_proj: Mapping[str, torch.Tensor], cross_attention_dim: int,
                                     num_tokens: int, *, device=None) -> nn.Module:
    """The f32 projection module an h94-format ``image_proj`` dict
    describes, loaded strictly: a Plus ``Resampler`` where the dict has
    ``latents``, else an ``ImageProjection``. A Plus dict's widths are read
    off it (aid_tpu/pipelines/interpolation.py:241-256): hidden width and
    query count from ``latents``, embed width from ``proj_in.weight``, depth
    from the highest ``layers.<i>``, ``heads = max(1, hidden // 64)``. Its
    query count must equal the UNet's ``num_tokens``."""
    if "latents" in image_proj:
        _, nq, hidden = image_proj["latents"].shape
        if nq != num_tokens:
            raise ValueError(f"the Plus checkpoint has {nq} queries; the UNet config expects {num_tokens} "
                             "IP tokens (ip_num_tokens)")
        depth = 1 + max(int(k.split(".")[1]) for k in image_proj if k.startswith("layers."))
        proj = Resampler(cross_attention_dim, image_proj["proj_in.weight"].shape[1], hidden_dim=hidden, depth=depth,
                         heads=max(1, hidden // 64), num_queries=nq, device=device)
    else:
        proj = ImageProjection(image_proj["proj.weight"].shape[1], cross_attention_dim, num_tokens, device=device)
    proj.load_state_dict({k: torch.as_tensor(v) for k, v in image_proj.items()}, strict=True)
    return proj.eval()
