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
card there is no such gate, and ``FLASH_MIN_KV`` only keeps those calls
exact under the static-shift softmax (``static_smax="auto"``, the model
path's default, as in the JAX package). :func:`attention` is plain
multi-head attention; :func:`attention_logit_window` and
``LOGIT_WINDOW_RECORDER`` calibrate the static shift's window.
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


def _softmax_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                  static: Optional[tuple] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v with a float32 softmax.

    q: (B, H, Sq, D), k/v: (B, H, Sk, D) (broadcastable over B, H) ->
    (B, H, Sq, D) in q's dtype. ``static`` = (C, clip): the static-shift
    softmax, exp(min(s * scale - C, clip)) over its own sum (no row max),
    as aid_tpu/ops/flash_attention.py's kernels compute it with
    ``static_smax`` = C; a row whose every key underflows gives 0, as the
    JAX kernels' guarded denominator does.
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
        if static is None:
            probs = torch.softmax(logits, dim=-1).to(dtype)
        else:
            p = torch.exp(torch.clamp_max(logits - static[0], static[1]))
            probs = (p / p.sum(dim=-1, keepdim=True).clamp_min(1e-37)).to(dtype)
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
    *,
    static: Optional[tuple] = None,
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
      static: (C, clip) for the static-shift softmax of every accumulator
        set (``_softmax_attn``), or None for the exact one.

    Returns:
      (B, H, Sq, D) attention output, same dtype as q.
    """
    mode = AttnMode(mode)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if mode == AttnMode.SELF:
        return _softmax_attn(q, k, v, scale, static)

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
        return _softmax_attn(q, k_cross, v_cross, scale, static)

    if mode.is_fused:
        kb, vb = torch.cat([k, kb], dim=-2), torch.cat([v, vb], dim=-2)
        ke, ve = torch.cat([k, ke], dim=-2), torch.cat([v, ve], dim=-2)
    out_begin = _softmax_attn(q, kb, vb, scale, static)
    out_end = _softmax_attn(q, ke, ve, scale, static)
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


#: own-KV length from which the JAX package sends a call to its Pallas kernel
#: (aid_tpu/ops/attention.py:98, 291). Here every call takes a kernel; the
#: gate only resolves ``static_smax="auto"``: a shorter call stays exact, as
#: on the JAX package's XLA path. Module-level so tests can lower it.
FLASH_MIN_KV = 512

#: Static-shift calibration hook (aid_tpu/ops/attention.py:105-118): when set
#: to a callable ``fn(lo, hi)``, every ``dispatch_attention`` call reports the
#: window of PER-ACCUMULATOR-SET row maxes of its scaled logits (0-d f32
#: tensors, on the call's device). Each softmax the kernels evaluate is
#: normalised over its own key set ([kb] and [ke] for pure_outer; [k; kb] and
#: [k; ke] for fused_outer; lerp(kb, ke) / [k; lerp] for the inner modes), so
#: the static shift is exact only while EVERY set's row max lies in the
#: window [C - 72, C + 30] = [-32, +70] at C = 40. The lerped row max is
#: bracketed above by max(rowmax_b, rowmax_e) and below by the row max of the
#: elementwise MIN of the two logit matrices (lerp_j >= min(b_j, e_j) for t
#: in [0, 1]).
LOGIT_WINDOW_RECORDER = None


def _row_maxes(q, k, scale, q_block: int = 512, pair=None) -> torch.Tensor:
    """(B * H, Sq) row maxes of the scaled logits q k^T * scale in f32,
    (B, H) rows of q against k broadcast over them. With ``pair`` (a second
    K of k's shape), the row maxes of the ELEMENTWISE MIN of the two logit
    matrices: the sound lower bound for lerped keys. Chunked over rows and
    query blocks, so the logits held at once stay near
    ``_PLAIN_LOGIT_BUDGET`` elements (aid_tpu/ops/attention.py:121-160)."""
    Sq, D = q.shape[-2:]
    L = k.shape[-2]
    qf = q.reshape(-1, Sq, D)

    def flat_k(x):
        return x.expand(*q.shape[:-2], L, D).reshape(-1, L, D)

    kf = flat_k(k)
    pf = None if pair is None else flat_k(pair)
    step = max(1, _PLAIN_LOGIT_BUDGET // max(1, q_block * L))
    out = []
    for n in range(0, qf.shape[0], step):
        kn = kf[n:n + step].float().transpose(-1, -2)
        pn = None if pf is None else pf[n:n + step].float().transpose(-1, -2)
        rows = []
        for i in range(0, Sq, q_block):
            qs = qf[n:n + step, i:i + q_block].float()
            logits = torch.matmul(qs, kn)
            if pn is not None:
                logits = torch.minimum(logits, torch.matmul(qs, pn))
            rows.append((logits * scale).amax(dim=-1))
        out.append(torch.cat(rows, dim=1))
    return torch.cat(out)


def _probe_logit_window(q, k, v, mode, k_begin, k_end, scale, skip_endpoints=None, force_vanilla=None) -> None:
    """Report the call's per-set row-max window to ``LOGIT_WINDOW_RECORDER``
    (aid_tpu/ops/attention.py:163-232): lo is the least row max of any
    accumulator set, hi the largest. ``force_vanilla`` rows, and in the
    fused modes any skip vector, may reduce to the own-K set, which then
    widens the window (``may_own``); a pure-mode skip vector does not."""
    mode = AttnMode(mode)
    if mode == AttnMode.SELF:
        own = _row_maxes(q, k, scale)
        LOGIT_WINDOW_RECORDER(own.min(), own.max())
        return

    def ep(x, row):
        e = k[row] if x is None else x
        return e if e.dim() == k.dim() else e.unsqueeze(0).expand(k.shape[0], *e.shape)

    may_own = force_vanilla is not None or (mode.is_fused and skip_endpoints is not None)
    kb, ke = ep(k_begin, 0), ep(k_end, -1)
    mb, me = _row_maxes(q, kb, scale), _row_maxes(q, ke, scale)
    mown = _row_maxes(q, k, scale) if (mode.is_fused or may_own) else None
    if mode == AttnMode.PURE_OUTER:  # two softmaxes, over [kb] and [ke]
        low, up = torch.minimum(mb, me), torch.maximum(mb, me)
    elif mode == AttnMode.FUSED_OUTER:  # two softmaxes, over [k; kb] and [k; ke]
        s1, s2 = torch.maximum(mown, mb), torch.maximum(mown, me)
        low, up = torch.minimum(s1, s2), torch.maximum(s1, s2)
    elif mode == AttnMode.FUSED_INNER:  # one over [k; lerp(kb, ke)]; skip rows collapse the lower edge to mown
        up = torch.maximum(mown, torch.maximum(mb, me))
        low = mown if may_own else torch.maximum(mown, _row_maxes(q, kb, scale, pair=ke))
    else:  # PURE_INNER: one softmax over lerp(kb, ke)
        low, up = _row_maxes(q, kb, scale, pair=ke), torch.maximum(mb, me)
    if may_own:
        low = torch.minimum(low, mown)
        if not mode.is_fused:  # the fused upper edge is >= mown already
            up = torch.maximum(up, mown)
    LOGIT_WINDOW_RECORDER(low.min(), up.max())


def attention_logit_window(q: torch.Tensor, k: torch.Tensor, scale: Optional[float] = None,
                           q_block: int = 512) -> tuple:
    """(min_row_max, max_row_max) of the scaled logits q k^T * scale, as 0-d
    f32 tensors: what must lie inside the static-shift window [C - 72, C + 30]
    (C = 40: [-32, +70]) for the static shift to be the exact softmax
    (aid_tpu/ops/attention.py:443-467). Chunked over query blocks."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    m = _row_maxes(q, k, scale, q_block)
    return m.min(), m.max()


def dispatch_attention(
    q, k, v, coef, mode,
    k_begin=None, v_begin=None, k_end=None, v_end=None,
    scale=None, skip_endpoints=None, force_vanilla=None, static_smax="auto",
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

    ``static_smax``: the static-shift softmax (aid_tpu/ops/attention.py:
    256-295), passed to the kernel. The model path's default ``"auto"`` puts
    C = 40 where the JAX package's model path does and the card has an
    instance measured no slower (``flash_attention.resolve_static_smax``); a
    call whose own KV is shorter than ``FLASH_MIN_KV`` stays exact, as the
    JAX package's XLA path is. ``None`` forces the exact softmax end to end;
    a float applies that shift (bf16 and f32 only). Where ``force_vanilla``
    is the Python bool True (every row vanilla: the fused loop's late
    steps), "auto" resolves as the self call the rows compute, so the fused
    loop and the split one launch the same softmax.
    """
    from aid_tpu_torch.ops.flash_attention import flash_interpolated_attention

    mode = AttnMode(mode)
    if _flops.counting():  # counted by its formula (utils/flops.py), as the JAX XLA path computes it
        flops = _flops.attention_flops(q.shape, k.shape, mode.value, None if k_begin is None else k_begin.shape[-2])
        if force_vanilla is not None and mode != AttnMode.SELF and any(
                ep is not None and ep.shape[-2] != k.shape[-2] for ep in (k_begin, v_begin, k_end, v_end)):
            flops += _flops.attention_flops(q.shape, k.shape)  # the vanilla result computed apart
        return _flops.counted_call(flops, dispatch_attention, q, k, v, coef, mode, k_begin, v_begin, k_end, v_end,
                                   scale, skip_endpoints, force_vanilla, static_smax)
    if LOGIT_WINDOW_RECORDER is not None:
        _probe_logit_window(q, k, v, mode, k_begin, k_end, scale or q.shape[-1] ** -0.5,
                            skip_endpoints=skip_endpoints, force_vanilla=force_vanilla)
    if isinstance(static_smax, str) and static_smax == "auto":
        if k.shape[-2] < FLASH_MIN_KV:
            static_smax = None
        elif force_vanilla is True and mode != AttnMode.SELF:
            # every row vanilla (the fused loop's late steps): the self call it
            # computes resolves "auto", so the fused loop runs split's kernels
            from aid_tpu_torch.ops.flash_attention import resolve_static_smax

            static_smax = resolve_static_smax(q, k, AttnMode.SELF)
    if force_vanilla is not None and mode.is_fused:
        fv = torch.as_tensor(force_vanilla, dtype=torch.bool, device=q.device).expand(q.shape[0])
        skip_endpoints = fv if skip_endpoints is None else skip_endpoints | fv
    elif force_vanilla is not None and mode != AttnMode.SELF:
        subst = _force_vanilla_endpoints(force_vanilla, k, v, k_begin, v_begin, k_end, v_end)
        if subst is None:
            out = flash_interpolated_attention(q, k, v, coef, mode, k_begin=k_begin, v_begin=v_begin, k_end=k_end,
                                               v_end=v_end, scale=scale, skip_endpoints=skip_endpoints,
                                               static_smax=static_smax)
            van = flash_interpolated_attention(q, k, v, scale=scale, static_smax=static_smax)
            return torch.where(_force_rows(force_vanilla, q.device), van, out)
        k_begin, v_begin, k_end, v_end = subst

    return flash_interpolated_attention(
        q, k, v, coef, mode,
        k_begin=k_begin, v_begin=v_begin, k_end=k_end, v_end=v_end,
        scale=scale, skip_endpoints=skip_endpoints, static_smax=static_smax,
    )
