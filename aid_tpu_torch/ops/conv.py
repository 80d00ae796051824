"""3x3 stride-1 SAME convolution, plain and with a GroupNorm+SiLU prologue:
the hand-written Hopper kernel and its plain versions.

``conv3x3_same`` is the counterpart of ``aid_tpu.ops.conv.conv3x3_same``. On
a CUDA tensor it launches ``csrc/conv3x3.cu`` without its prologue, which
replaces both Pallas TPU kernels behind that function: ``_kernel``
(conv.py:30-44, ``packed=False``, through ``_call_9dot``) and
``_kernel_packed`` (conv.py:47-75, ``packed=True``). Packing K as 3*Cin per
dy was a TPU lane-tiling measure; the CUDA kernel's K loop already runs over
all 9*Cin, so both flags launch the same kernel instance and count in
``conv3x3_same.launches``.

On an f32 CUDA tensor ``conv3x3_same`` routes to :func:`conv3x3_same_f32`,
which launches ``csrc/conv3x3_f32.cu`` (3xTF32 products on tf32 wgmma; the
f32 instance of the same two TPU kernels) and counts in
``conv3x3_same_f32.launches``. On an f16 CUDA tensor it routes to
:func:`conv3x3_same_f16`, the f16 instance of ``csrc/conv3x3.cu`` (the same
design with f16 wgmma, ``aid_conv3x3_f16``), counted in
``conv3x3_same_f16.launches``.

``conv3x3_gnsilu`` is the counterpart of ``aid_tpu.ops.conv.conv3x3_gnsilu``:
conv(silu(group_norm(x))) with the SAME padding applied after the prologue.
On a bf16 CUDA tensor it launches the same kernel with its prologue, which
replaces ``_kernel_packed_gnsilu`` (conv.py:78-121), counted in
``conv3x3_gnsilu.launches``. On an f32 CUDA tensor it routes to
:func:`conv3x3_gnsilu_f32`: the f32 layout pass with the prologue
(``aid_conv3x3_gnsilu_f32`` in ``csrc/conv3x3_f32.cu``, which writes
silu(x * scale + shift) in the 4-channel blocked layout, with its lo part),
then the f32 conv kernel unchanged, counted in ``conv3x3_gnsilu_f32.launches``. On an f16
CUDA tensor it routes to :func:`conv3x3_gnsilu_f16`, the f16 instance of the
bf16 kernel with its prologue (``aid_conv3x3_gnsilu_f16``: silu in f32
rounded once to f16), counted in ``conv3x3_gnsilu_f16.launches``. The GroupNorm
statistics are computed here with plain torch ops, as the JAX package
computes them in XLA outside its kernel.

On a CPU tensor both run their plain versions. The sources' headers say what
bounds the kernel on the card and how the design answers. The interface
keeps PyTorch's NCHW / OIHW layout; the kernel reads activations with
their channels in blocks of 8 and weights tiled by its N tile and K chunk,
so the wrappers convert both (:func:`kernel_operands`) and return
channels-last tensors. The f32 kernel reads channels in blocks of 4 (16
bytes again), each blocked tensor followed by its lo part (what the tensor
cores drop when they read the raw f32 value as tf32), and weights tiled by
its own N tile and K chunk, raw and lo. A weight is tiled once and the tiling
kept for later calls (:func:`tiled_weight`): at inference the weights are constant,
so a call copies only its activation, on the card by the layout kernel of
the same source (:func:`blocked_input`).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from aid_tpu_torch.ops.routing import use_kernel
from aid_tpu_torch.utils import flops as _flops


def conv3x3_same_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y = conv2d(x, w, stride 1, padding 1) + b (the kernel's plain version)."""
    return F.conv2d(x, w, b, padding=1)


#: the kernel's output tile (image rows x columns per block), N tile
#: (output channels per block) and K chunk (input channels per pipeline
#: stage): csrc/conv3x3.cu's kTR, kTW, kBN and kKc. The layouts below
#: follow them.
KERNEL_TILE_ROWS, KERNEL_TILE_COLS = 4, 64
KERNEL_N_TILE, KERNEL_K_CHUNK = 160, 16
#: the same of the f32 kernel, csrc/conv3x3_f32.cu's kTR, kTW, kBN and kKc,
#: and its stages (kStages)
F32_TILE_ROWS, F32_TILE_COLS = 2, 64
F32_N_TILE, F32_K_CHUNK = 160, 8
F32_STAGES = 2

#: weight -> (the weight's storage and version when tiled, its tiling)
_TILED = WeakIdKeyDictionary()


def tf32_rest(x: torch.Tensor) -> torch.Tensor:
    """x - trunc(x) to tf32: the low 13 mantissa bits of an f32 tensor,
    which the tensor cores drop when they read x as tf32 (exact in f32).
    With the raw value as hi, hi*hi + hi*lo + lo*hi is 3xTF32."""
    return x - (x.view(torch.int32) & -8192).view(torch.float32)


def tiled_weight(w: torch.Tensor) -> torch.Tensor:
    """w (Cout, Cin, 3, 3) tiled as the kernel of its dtype reads it, with
    zeros past Cout and Cin, so that each N tile's K chunk is one contiguous
    copy that lands as the wgmma B operands: bf16 and f16 as (ceil(Cout/160),
    ceil(Cin/16), 3, 3, 2, 160, 8); f32 as (ceil(Cout/160), ceil(Cin/8), 2,
    3, 3, 2, 160, 4), the raw weight and its :func:`tf32_rest` of each chunk
    one after the other, 4 channels (16 bytes) a row. The tiling is kept
    while w lives, keyed by w's storage, dtype and version counter: a
    parameter is tiled on its first call, and again only after an in-place
    update (``load_state_dict``, ``copy_`` under ``torch.no_grad``) or a move
    to new storage. Writes that bypass the version counter are not seen:
    those through ``w.data``, and those to an inference tensor, which has no
    counter."""
    key = (w.data_ptr(), w.dtype, None if w.is_inference() else w._version)
    hit = _TILED.get(w)
    if hit is not None and hit[0] == key:
        return hit[1]
    Cout, Cin = w.shape[:2]
    f32 = w.dtype == torch.float32
    bn, kc = (F32_N_TILE, F32_K_CHUNK) if f32 else (KERNEL_N_TILE, KERNEL_K_CHUNK)
    nt, nk = -(-Cout // bn), -(-Cin // kc)
    with torch.no_grad():
        wp = w.new_zeros((nt * bn, nk * kc, 3, 3))
        wp[:Cout, :Cin] = w
        # (N tile, K chunk, dy, dx, channel group, co, ci in the group)
        wt = wp.view(nt, bn, nk, 2, kc // 2, 3, 3).permute(0, 2, 5, 6, 3, 1, 4)
        wt = torch.stack((wt, tf32_rest(wt)), dim=2) if f32 else wt.contiguous()
    _TILED[w] = (key, wt)
    return wt


def silu_affine(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """The prologue: silu(x * scale + shift) in f32 with (B, C) factors,
    rounded to x's dtype."""
    return F.silu(x.float() * scale[:, :, None, None] + shift[:, :, None, None]).to(x.dtype)


def blocked_input_plain(x: torch.Tensor, scale=None, shift=None) -> torch.Tensor:
    """x (B, C, H, W) as (B, C/n, H, W, n) with n channels in a 16-byte
    block (8 in bf16 and f16, 4 in f32), each pixel's block one contiguous run (the
    layout kernels' plain version). f32 returns (2, B, C/4, H, W, 4): that
    and its :func:`tf32_rest`, one after the other. With ``scale``/``shift``
    (B, C) f32, :func:`silu_affine` of x first (the f32 prologue layout's
    plain version)."""
    if scale is not None:
        x = silu_affine(x, scale, shift)
    B, C, H, W = x.shape
    n = 16 // x.element_size()
    xb = x.reshape(B, C // n, n, H, W).permute(0, 1, 3, 4, 2)
    return torch.stack((xb, tf32_rest(xb))) if x.dtype == torch.float32 else xb.contiguous()


#: the layout kernel by dtype: (C entry, channels a 16-byte block)
_LAYOUT = {torch.bfloat16: ("aid_conv3x3_blocked_bf16", 8), torch.float16: ("aid_conv3x3_blocked_f16", 8),
           torch.float32: ("aid_conv3x3_blocked_f32", 4)}


def blocked_input(x: torch.Tensor, scale=None, shift=None) -> torch.Tensor:
    """:func:`blocked_input_plain` of a bf16 or f16 x with C % 8 == 0 or an
    f32 x with C % 4 == 0: on a CUDA tensor by the layout kernel of
    ``csrc/conv3x3.cu`` (bf16, f16) or ``csrc/conv3x3_f32.cu`` (f32), which reads
    x at its own strides (NCHW, channels-last or a view) once and writes the
    result once; on a CPU tensor by the plain version. ``scale``/``shift``
    (f32 x only) apply the GN+SiLU prologue in the same pass
    (``aid_conv3x3_gnsilu_f32``)."""
    factors = () if scale is None else (scale.float().contiguous(), shift.float().contiguous())
    if not use_kernel(x, *factors):
        return blocked_input_plain(x, scale, shift)
    B, C, H, W = x.shape
    entry, n = _LAYOUT.get(x.dtype, (None, 8))
    if entry is None or C % n:
        raise NotImplementedError(f"the layout kernels take bf16 or f16 with C % 8 == 0 or f32 with C % 4 == 0; "
                                  f"got {x.dtype}, C = {C}")
    if factors:
        if x.dtype != torch.float32 or any(f.shape != (B, C) for f in factors):
            raise NotImplementedError(f"the prologue layout takes f32 x and (B, C) factors; got {x.dtype}, "
                                      f"{[tuple(f.shape) for f in factors]}")
        entry = "aid_conv3x3_gnsilu_f32"
    parts = (2,) if x.dtype == torch.float32 else ()  # f32: the raw blocks, then their lo part
    xb = torch.empty((*parts, B, C // n, H, W, n), dtype=x.dtype, device=x.device)
    strides = (ctypes.c_longlong * 4)(*x.stride())

    from aid_tpu_torch.ops import _build

    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = getattr(_build.library(), entry)(x.data_ptr(), xb.data_ptr(), *(f.data_ptr() for f in factors),
                                            B, C, H, W, strides, stream)
    _build.check(code, f"{entry} launch")
    return xb


def kernel_operands(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *factors: torch.Tensor) -> tuple:
    """Check the operands and lay them out as the kernel of their dtype
    reads them: x as (B, Cin/n, H, W, n) by :func:`blocked_input` (channels
    in 16-byte blocks, so that one row of the kernel's input window is one
    contiguous run), w by :func:`tiled_weight`, b and ``factors`` (the
    prologue's scale, shift) f32. bf16 and f16 take Cin % 8 == 0 and pass
    the factors on to the kernel; f32 takes Cin % 4 == 0 and applies them in the
    layout pass, so its tuple has none. Returns the tuple
    :func:`launch_kernel` takes (f32: x as (2, B, Cin/4, H, W, 4), raw then
    lo)."""
    B, Cin, H, W = x.shape
    Cout = w.shape[0]
    if w.shape != (Cout, Cin, 3, 3) or b.shape != (Cout,):
        raise ValueError(f"weight {tuple(w.shape)} / bias {tuple(b.shape)} do not fit input {tuple(x.shape)}")
    if x.dtype not in _LAYOUT or w.dtype != x.dtype:
        raise NotImplementedError(f"conv kernels take bf16, f16 or f32 x and w of one dtype; got x {x.dtype}, "
                                  f"w {w.dtype}")
    n = _LAYOUT[x.dtype][1]
    if Cin % n or Cout % 2:
        raise NotImplementedError(f"conv kernel needs Cin % {n} == 0 and Cout % 2 == 0; got {Cin}, {Cout}")
    if factors and x.dtype == torch.float32:
        return blocked_input(x, *factors), tiled_weight(w), b.float().contiguous(), ()
    return blocked_input(x), tiled_weight(w), b.float().contiguous(), tuple(f.float().contiguous() for f in factors)


def launch_kernel(entry: str, xb: torch.Tensor, wt: torch.Tensor, bf: torch.Tensor, factors: tuple) -> torch.Tensor:
    """Launch the C entry point ``entry`` on operands from
    :func:`kernel_operands`; returns a channels-last (B, Cout, H, W) tensor.
    Counts nothing: the wrappers below count their launches."""
    B, G, H, W, n = xb.shape[-5:]
    Cout = bf.shape[0]
    out = torch.empty((B, Cout, H, W), dtype=xb.dtype, device=xb.device, memory_format=torch.channels_last)

    from aid_tpu_torch.ops import _build

    stream = torch.cuda.current_stream(xb.device).cuda_stream
    code = getattr(_build.library(), entry)(xb.data_ptr(), wt.data_ptr(), bf.data_ptr(), out.data_ptr(),
                                            *(f.data_ptr() for f in factors), B, H, W, n * G, Cout, stream)
    _build.check(code, f"{entry} launch")
    return out


def _launch_counted(wrapper, dtype, entry: str, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    gn: tuple = ()) -> torch.Tensor:
    """One launch of ``entry`` on x (which must be ``dtype``), w and b laid
    out by :func:`kernel_operands`, counted on ``wrapper``. ``gn``: the
    prologue's (gamma, beta, num_groups, eps), whose statistics are taken
    once x's dtype has been checked."""
    if x.dtype != dtype:
        raise NotImplementedError(f"{entry} takes {dtype}; got {x.dtype} (the conv kernels take bf16, f16 or f32)")
    factors = gn_scale_shift(x, *gn) if gn else ()
    out = launch_kernel(entry, *kernel_operands(x, w, b, *factors))
    wrapper.launches += 1
    return out


def conv3x3_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, packed: bool = False) -> torch.Tensor:
    """y = conv2d(x, w, stride 1, SAME) + b.

    x: (B, Cin, H, W); w: (Cout, Cin, 3, 3); b: (Cout,). Accumulates in f32
    and returns x's dtype. ``packed`` names the JAX package's packed-K TPU
    kernel; on the card both flags launch the same kernel (module
    docstring). On CUDA the bf16 kernel takes Cin % 8 == 0 and Cout % 2 ==
    0; f32 goes to :func:`conv3x3_same_f32`, f16 to :func:`conv3x3_same_f16`;
    anything else raises.
    """
    del packed  # one kernel serves both TPU contracts
    if _flops.counting():  # counted by its formula (utils/flops.py), whatever computes it
        return _flops.counted_call(_flops.conv3x3_flops(x.shape, w.shape), conv3x3_same, x, w, b)
    if not use_kernel(x, w, b):
        return conv3x3_same_plain(x, w, b)
    if x.dtype == torch.float32:
        return conv3x3_same_f32(x, w, b)
    if x.dtype == torch.float16:
        return conv3x3_same_f16(x, w, b)
    return _launch_counted(conv3x3_same, torch.bfloat16, "aid_conv3x3_bf16", x, w, b)


#: kernel launches since the last reset (chip_smoke.py reads it around each path)
conv3x3_same.launches = 0


def conv3x3_same_f32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """conv3x3_same in f32 at f32 accuracy: ``csrc/conv3x3_f32.cu`` (3xTF32
    products on tf32 wgmma, each K chunk's sum folded in f32) on CUDA tensors with Cin % 4 == 0 and Cout % 2 == 0,
    returning a channels-last tensor; the plain version on CPU tensors."""
    if not use_kernel(x, w, b):
        return conv3x3_same_plain(x, w, b)
    return _launch_counted(conv3x3_same_f32, torch.float32, "aid_conv3x3_f32", x, w, b)


#: kernel launches since the last reset (chip_smoke.py reads it around each path)
conv3x3_same_f32.launches = 0


def conv3x3_same_f16(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """conv3x3_same in f16: the f16 instance of ``csrc/conv3x3.cu`` (f16
    wgmma, f32 accumulation, one rounding of the output to f16) on CUDA
    tensors with Cin % 8 == 0 and Cout % 2 == 0, returning a channels-last
    tensor; the plain version on CPU tensors."""
    if not use_kernel(x, w, b):
        return conv3x3_same_plain(x, w, b)
    return _launch_counted(conv3x3_same_f16, torch.float16, "aid_conv3x3_f16", x, w, b)


#: kernel launches since the last reset (chip_smoke.py reads it around each path)
conv3x3_same_f16.launches = 0


def gn_scale_shift(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, num_groups: int,
                   eps: float) -> tuple:
    """Per-(batch, channel) f32 factors with group_norm(x) * gamma + beta ==
    x * scale + shift, from the one-pass statistics var = E[x^2] - E[x]^2
    (aid_tpu/ops/conv.py:191-197). x: (B, C, H, W) -> two (B, C) f32 tensors."""
    B, C = x.shape[:2]
    if C % num_groups:
        raise ValueError(f"{C} channels do not split into {num_groups} groups")
    xg = x.reshape(B, num_groups, -1)
    # both sums accumulate x's elements in f32 as they are read: no f32
    # copy of x is made (on the card, the reduction reads bf16 directly)
    mean = xg.mean(dim=-1, dtype=torch.float32)
    var = torch.linalg.vector_norm(xg, dim=-1, dtype=torch.float32).square() / xg.shape[-1] - mean.square()
    rstd = torch.rsqrt(var + eps)
    per_group = C // num_groups
    scale = gamma.float()[None] * rstd.repeat_interleave(per_group, dim=1)
    shift = beta.float()[None] - mean.repeat_interleave(per_group, dim=1) * scale
    return scale, shift


def conv3x3_gnsilu_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """The prologue kernel's plain version: the same one-pass statistics,
    silu(x * scale + shift) in f32 rounded to x's dtype, then F.conv2d with
    zero padding (so the halo is zero AFTER the prologue)."""
    return F.conv2d(silu_affine(x, *gn_scale_shift(x, gamma, beta, num_groups, eps)), w, b, padding=1)


def conv3x3_gnsilu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """y = conv2d(silu(group_norm(x, gamma, beta)), w, SAME) + b.

    x: (B, Cin, H, W); w: (Cout, Cin, 3, 3); b: (Cout,); gamma, beta: (Cin,).
    On CUDA the kernel takes bf16 x and w with Cin % 8 == 0 and Cout % 2 ==
    0; f32 goes to :func:`conv3x3_gnsilu_f32`, f16 to
    :func:`conv3x3_gnsilu_f16`; anything else raises.
    """
    if _flops.counting():  # the conv's FLOPs; the prologue is not counted, as the JAX module leaves norms out
        return _flops.counted_call(_flops.conv3x3_flops(x.shape, w.shape), conv3x3_gnsilu, x, w, b, gamma, beta,
                                   num_groups, eps)
    if not use_kernel(x, w, b, gamma, beta):
        return conv3x3_gnsilu_plain(x, w, b, gamma, beta, num_groups, eps)
    if x.dtype == torch.float32:
        return conv3x3_gnsilu_f32(x, w, b, gamma, beta, num_groups, eps)
    if x.dtype == torch.float16:
        return conv3x3_gnsilu_f16(x, w, b, gamma, beta, num_groups, eps)
    return _launch_counted(conv3x3_gnsilu, torch.bfloat16, "aid_conv3x3_gnsilu_bf16", x, w, b,
                           (gamma, beta, num_groups, eps))


#: kernel launches since the last reset (chip_smoke.py reads it around each path)
conv3x3_gnsilu.launches = 0


def conv3x3_gnsilu_f16(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                       num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """conv3x3_gnsilu in f16: the f16 instance of ``csrc/conv3x3.cu`` with its
    prologue (silu(x * scale + shift) in f32 rounded once to f16 in shared
    memory, the halo left zero, then f16 wgmma) on CUDA tensors with Cin % 8
    == 0 and Cout % 2 == 0, returning a channels-last tensor; the plain
    version on CPU tensors."""
    if not use_kernel(x, w, b, gamma, beta):
        return conv3x3_gnsilu_plain(x, w, b, gamma, beta, num_groups, eps)
    return _launch_counted(conv3x3_gnsilu_f16, torch.float16, "aid_conv3x3_gnsilu_f16", x, w, b,
                           (gamma, beta, num_groups, eps))


#: kernel launches since the last reset (chip_smoke.py reads it around each path)
conv3x3_gnsilu_f16.launches = 0


def conv3x3_gnsilu_f32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                       num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """conv3x3_gnsilu in f32: the prologue in the f32 layout pass
    (``aid_conv3x3_gnsilu_f32``), then ``csrc/conv3x3_f32.cu``'s conv (3xTF32
    products, f32 sums) on CUDA tensors with Cin % 4 == 0 and Cout % 2 == 0,
    returning a channels-last tensor; the plain version on CPU tensors."""
    if not use_kernel(x, w, b, gamma, beta):
        return conv3x3_gnsilu_plain(x, w, b, gamma, beta, num_groups, eps)
    return _launch_counted(conv3x3_gnsilu_f32, torch.float32, "aid_conv3x3_f32", x, w, b,
                           (gamma, beta, num_groups, eps))


#: kernel launches since the last reset (chip_smoke.py reads it around each path)
conv3x3_gnsilu_f32.launches = 0
