"""Analytic FLOP accounting (for MFU reporting).

Counterpart of ``aid_tpu.utils.flops``: :func:`count_flops` returns the
multiply-add FLOPs (2 x MACs) of the matrix products and convolutions of one
call; elementwise, softmax and norm work is not counted, as the JAX module
leaves it out, so an MFU built on it is a floor on the card's utilization.

Two sources make up the count:
  * every torch product the call runs (``nn.Linear``, ``F.conv2d``,
    ``torch.matmul``, ...), through ``torch.utils.flop_counter.FlopCounterMode``;
  * the interpolated attention (``ops.attention.dispatch_attention``) and the
    3x3 convs (``ops.conv.conv3x3_same``, ``conv3x3_gnsilu``) by their
    function's formula, whatever implements them: on the card their kernels
    launch through ctypes, which the counter cannot see, and on the CPU their
    plain versions run products of their own. Each of those entry points
    adds its formula to the open count (:func:`counted_call`) and runs with
    the counter blind to it, so the same program counts the same on the CPU
    and on the card.
The attention's formula is the JAX package's XLA path's (aid_tpu/ops/
attention.py:399-442): 4 * D FLOPs a (query, key) pair (Q K^T and P V) over
every key set the mode's softmax reads, skip rows counted in full; the
conv's 2 * 9 * Cin per output element.
"""

from __future__ import annotations

from typing import Optional

import torch

#: NVIDIA H100 SXM's dense bf16 (and f16) tensor-core peak (NVIDIA's data sheet)
H100_PEAK_BF16_FLOPS = 989e12


class _Count:
    """An open count: the formula FLOPs added so far, and whether a counted
    call is running (its own products are not counted again)."""

    def __init__(self):
        self.flops = 0
        self.inside = False


_OPEN: Optional[_Count] = None


def counting() -> bool:
    """True inside :func:`count_flops`, outside a call it already counts by formula."""
    return _OPEN is not None and not _OPEN.inside


def counted_call(flops: int, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` counted as ``flops``: the open count gains
    them, and the products ``fn`` runs are hidden from the counter."""
    from torch.utils._python_dispatch import _disable_current_modes

    count = _OPEN
    count.flops += int(flops)
    count.inside = True
    try:
        with _disable_current_modes():
            return fn(*args, **kwargs)
    finally:
        count.inside = False


def attention_flops(q_shape, k_shape, mode: str = "self", endpoint_len: Optional[int] = None) -> int:
    """FLOPs of one interpolated attention call on q (B, H, Sq, D) and own
    k (B, H, Lk, D) in ``mode`` (an ``AttnMode`` value), the endpoints
    ``endpoint_len`` keys long (default: Lk, rows 0 and B-1 of k): 4 * D a
    (query, key) pair over the key sets of the mode's softmaxes (self: own;
    outer: [own;] begin and [own;] end; inner: [own;] cross)."""
    B, H, Sq, D = q_shape
    Lk = k_shape[-2]
    Le = Lk if endpoint_len is None else endpoint_len
    own = Lk if mode in ("self", "fused_outer", "fused_inner") else 0
    sets = {"self": 0, "fused_outer": 2, "pure_outer": 2, "fused_inner": 1, "pure_inner": 1}[mode]
    keys = own if sets == 0 else sets * (own + Le) if sets == 2 else own + Le
    return 4 * B * H * Sq * D * keys


def conv3x3_flops(x_shape, w_shape) -> int:
    """FLOPs of a 3x3 SAME conv of x (B, Cin, H, W) with w (Cout, Cin, 3, 3)."""
    B, Cin, H, W = x_shape
    return 2 * B * H * W * w_shape[0] * 9 * Cin


def count_flops(fn, *args, **kwargs) -> int:
    """Matmul+conv FLOPs of ``fn(*args, **kwargs)`` (2 x MACs). Runs the call
    once (PyTorch is eager; the JAX module traces instead), under
    ``torch.no_grad``."""
    from torch.utils.flop_counter import FlopCounterMode

    global _OPEN
    if _OPEN is not None:
        raise RuntimeError("count_flops does not nest")
    _OPEN = count = _Count()
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            fn(*args, **kwargs)
        return int(counter.get_total_flops()) + count.flops
    finally:
        _OPEN = None


def mfu(flops: int, seconds: float, peak: float = H100_PEAK_BF16_FLOPS) -> float:
    """Model FLOPs utilization: analytic matmul+conv FLOPs / time / peak."""
    return flops / seconds / peak
