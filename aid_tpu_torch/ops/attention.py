"""Interpolated attention: the core AID/PAID primitive.

PyTorch counterpart of ``aid_tpu.ops.attention``. One function covers the
whole family over batched multi-head tensors with a per-frame coefficient
vector. Modes:

  * ``outer``:  out_i = (1-c_i) * Attn(Q_i, K_b, V_b) + c_i * Attn(Q_i, K_e, V_e)
  * ``inner``:  K_x = (1-c_i) K_b + c_i K_e (same for V), out_i = Attn(Q_i, K_x, V_x)
  * ``fused`` variants put each frame's own K/V in front along the sequence
    axis: Attn(Q_i, [K_i; K_*], [V_i; V_*])

where frame b (begin) and frame e (end) are batch rows 0 and B-1 unless
explicit endpoint tensors are supplied. Softmax is float32 whatever the
input dtype; probabilities are cast to the input dtype for the PV product.

Shapes use the multi-head layout (B, H, S, D). Any strides are accepted.

Routing (``dispatch_attention``): a CPU tensor takes the plain version; a
CUDA tensor takes the hand-written kernel (``ops.flash_attention``) for
EVERY call, the 77-token cross-attention included, at every head dim up to
2048. The JAX package sends own-KV < ``FLASH_MIN_KV`` = 512 to XLA; on the
card there is no such gate. :func:`attention` is plain multi-head attention.
"""

from __future__ import annotations

import enum
from typing import Optional

import torch

from aid_tpu_torch.utils import flops as _flops

# Rows of (q-rows x keys) f32 logits the plain path materializes at once.
# The plain version is the reference the kernel is held against on the card,
# where the full fused logits at S=4096 would be ~9 GB; chunking over the
# independent (batch, head) rows keeps each piece near 1 GiB and changes no
# arithmetic.
_PLAIN_LOGIT_BUDGET = 1 << 28  # f32 elements


class AttnMode(str, enum.Enum):
    """Interpolated-attention mode names (the reference's early/late strings)."""

    SELF = "self"              # vanilla attention (deactivated processor)
    PURE_OUTER = "pure_outer"
    FUSED_OUTER = "fused_outer"
    PURE_INNER = "pure_inner"
    FUSED_INNER = "fused_inner"

    @property
    def is_outer(self) -> bool:
        return self in (AttnMode.PURE_OUTER, AttnMode.FUSED_OUTER)

    @property
    def is_inner(self) -> bool:
        return self in (AttnMode.PURE_INNER, AttnMode.FUSED_INNER)

    @property
    def is_fused(self) -> bool:
        return self in (AttnMode.FUSED_OUTER, AttnMode.FUSED_INNER)


def _softmax_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v with a float32 softmax.

    q: (B, H, Sq, D), k/v: (B, H, Sk, D) (broadcastable over B, H) ->
    (B, H, Sq, D) in q's dtype.
    """
    dtype = q.dtype
    B, H, Sq, D = q.shape
    k = k.expand(B, H, *k.shape[-2:])
    v = v.expand(B, H, *v.shape[-2:])
    Sk = k.shape[-2]
    qf, kf, vf = (x.reshape(B * H, -1, D) for x in (q, k, v))
    step = max(1, _PLAIN_LOGIT_BUDGET // max(1, Sq * Sk))
    outs = []
    for i in range(0, B * H, step):
        logits = torch.matmul(qf[i:i + step].float(), kf[i:i + step].float().transpose(-1, -2)) * scale
        probs = torch.softmax(logits, dim=-1).to(dtype)
        outs.append(torch.matmul(probs.float(), vf[i:i + step].float()).to(dtype))
    return torch.cat(outs).reshape(B, H, Sq, D)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """Plain multi-head attention on (B, H, S, D) tensors: softmax(q k^T *
    scale) v with a float32 softmax, scale D**-0.5 by default."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _softmax_attn(q, k, v, scale)


def interpolated_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    coef: torch.Tensor,
    mode: AttnMode | str,
    k_begin: Optional[torch.Tensor] = None,
    v_begin: Optional[torch.Tensor] = None,
    k_end: Optional[torch.Tensor] = None,
    v_end: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Interpolated attention over a frame batch (the plain version).

    Args:
      q: queries (B, H, Sq, D), one row per frame.
      k, v: per-frame keys/values (B, H, Sk, D).
      coef: (B,) per-frame interpolation coefficients t_i in [0, 1].
      mode: AttnMode (or its string value). ``self`` ignores coef/endpoints.
      k_begin / v_begin / k_end / v_end: optional explicit endpoint K/V of
        shape (H, Le, D) (shared by every row) or (B, H, Le, D) (per row).
        Default: rows 0 and B-1 of k/v.
      scale: attention scale; default D**-0.5.

    Returns:
      (B, H, Sq, D) attention output, same dtype as q.
    """
    mode = AttnMode(mode)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if mode == AttnMode.SELF:
        return _softmax_attn(q, k, v, scale)

    B = q.shape[0]

    def endpoint(x, explicit, row):
        ep = x[row] if explicit is None else explicit
        if ep.dim() == q.dim():  # (B, H, L, D): per-row endpoints
            return ep
        return ep.unsqueeze(0).expand(B, *ep.shape)

    kb, vb = endpoint(k, k_begin, 0), endpoint(v, v_begin, 0)
    ke, ve = endpoint(k, k_end, -1), endpoint(v, v_end, -1)
    c = coef.float().reshape(-1, 1, 1, 1)

    if mode.is_inner:
        k_cross = ((1.0 - c) * kb.float() + c * ke.float()).to(k.dtype)
        v_cross = ((1.0 - c) * vb.float() + c * ve.float()).to(v.dtype)
        if mode.is_fused:
            k_cross = torch.cat([k, k_cross], dim=-2)
            v_cross = torch.cat([v, v_cross], dim=-2)
        return _softmax_attn(q, k_cross, v_cross, scale)

    if mode.is_fused:
        kb, vb = torch.cat([k, kb], dim=-2), torch.cat([v, vb], dim=-2)
        ke, ve = torch.cat([k, ke], dim=-2), torch.cat([v, ve], dim=-2)
    out_begin = _softmax_attn(q, kb, vb, scale)
    out_end = _softmax_attn(q, ke, ve, scale)
    out = (1.0 - c) * out_begin.float() + c * out_end.float()
    return out.to(q.dtype)


def _force_rows(force_vanilla, device) -> torch.Tensor:
    """``force_vanilla`` as a bool tensor that selects whole (B, H, S, D)
    rows: a scalar stays 0-d, a (B,) vector gains three trailing axes."""
    fv = torch.as_tensor(force_vanilla, dtype=torch.bool, device=device)
    return fv if fv.dim() == 0 else fv.reshape(-1, 1, 1, 1)


def _force_vanilla_endpoints(force_vanilla, k, v, k_begin, v_begin, k_end, v_end):
    """Realise ``force_vanilla`` in the pure modes by the duplicated-KV
    identity (aid_tpu/ops/attention.py:229-253): each forced row's own K/V
    stands in for both endpoints, which reduces every mode exactly to
    vanilla attention. Returns the four (B, H, Le, D) endpoints, or None
    where an endpoint's length differs from the own KV's."""
    if any(ep is not None and ep.shape[-2] != x.shape[-2]
           for ep, x in ((k_begin, k), (k_end, k), (v_begin, v), (v_end, v))):
        return None
    fv = _force_rows(force_vanilla, k.device)

    def own_or_endpoint(explicit, x, row):
        ep = x[row] if explicit is None else explicit
        return torch.where(fv, x, ep.expand(x.shape[0], *ep.shape[-3:]))

    return (own_or_endpoint(k_begin, k, 0), own_or_endpoint(v_begin, v, 0),
            own_or_endpoint(k_end, k, -1), own_or_endpoint(v_end, v, -1))


def dispatch_attention(
    q, k, v, coef, mode,
    k_begin=None, v_begin=None, k_end=None, v_end=None,
    scale=None, skip_endpoints=None, force_vanilla=None,
):
    """The model's attention entry: the flash kernel on CUDA, its plain
    version on the CPU (see module docstring).

    ``skip_endpoints``: optional (B,) bool, rows whose endpoint segments
    provably reduce to vanilla attention. Fused modes drop those segments;
    pure modes ignore it (their streams have no own segment to fall back on).

    ``force_vanilla``: optional bool, scalar or (B,), rows computed as
    vanilla attention whatever the mode (aid_tpu/ops/attention.py:312-339).
    Fused modes fold it into ``skip_endpoints``; pure modes substitute each
    forced row's own K/V for both endpoints. Both keep one kernel launch.
    Only where an endpoint's length differs from the own KV's (never on the
    model's path) is the vanilla result computed apart and selected.
    """
    from aid_tpu_torch.ops.flash_attention import flash_interpolated_attention

    mode = AttnMode(mode)
    if _flops.counting():  # counted by its formula (utils/flops.py), as the JAX XLA path computes it
        flops = _flops.attention_flops(q.shape, k.shape, mode.value, None if k_begin is None else k_begin.shape[-2])
        if force_vanilla is not None and mode != AttnMode.SELF and any(
                ep is not None and ep.shape[-2] != k.shape[-2] for ep in (k_begin, v_begin, k_end, v_end)):
            flops += _flops.attention_flops(q.shape, k.shape)  # the vanilla result computed apart
        return _flops.counted_call(flops, dispatch_attention, q, k, v, coef, mode, k_begin, v_begin, k_end, v_end,
                                   scale, skip_endpoints, force_vanilla)
    if force_vanilla is not None and mode.is_fused:
        fv = torch.as_tensor(force_vanilla, dtype=torch.bool, device=q.device).expand(q.shape[0])
        skip_endpoints = fv if skip_endpoints is None else skip_endpoints | fv
    elif force_vanilla is not None and mode != AttnMode.SELF:
        subst = _force_vanilla_endpoints(force_vanilla, k, v, k_begin, v_begin, k_end, v_end)
        if subst is None:
            out = flash_interpolated_attention(q, k, v, coef, mode, k_begin=k_begin, v_begin=v_begin, k_end=k_end,
                                               v_end=v_end, scale=scale, skip_endpoints=skip_endpoints)
            van = flash_interpolated_attention(q, k, v, scale=scale)
            return torch.where(_force_rows(force_vanilla, q.device), van, out)
        k_begin, v_begin, k_end, v_end = subst

    return flash_interpolated_attention(
        q, k, v, coef, mode,
        k_begin=k_begin, v_begin=v_begin, k_end=k_end, v_end=v_end,
        scale=scale, skip_endpoints=skip_endpoints,
    )
