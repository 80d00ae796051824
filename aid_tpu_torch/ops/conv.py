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

``conv3x3_gnsilu`` is the counterpart of ``aid_tpu.ops.conv.conv3x3_gnsilu``:
conv(silu(group_norm(x))) with the SAME padding applied after the prologue.
On a CUDA tensor it launches the same kernel with its prologue, which
replaces ``_kernel_packed_gnsilu`` (conv.py:78-121), counted in
``conv3x3_gnsilu.launches``. The GroupNorm statistics are computed here with
plain torch ops, as the JAX package computes them in XLA outside its kernel.

On a CPU tensor both run their plain versions. The sources' headers say what
bounds the kernel on the card and how the design answers. The interface
keeps PyTorch's NCHW / OIHW layout; the kernel reads channels-last
activations (NHWC in memory) and (Cout, 3, 3, Cin) weights, so the wrappers
convert both and return channels-last tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from aid_tpu_torch.ops.routing import use_kernel


def conv3x3_same_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y = conv2d(x, w, stride 1, padding 1) + b (the kernel's plain version)."""
    return F.conv2d(x, w, b, padding=1)


def _launch(entry: str, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *factors: torch.Tensor) -> torch.Tensor:
    """Check the operands, lay them out as the kernel reads them and launch
    the C entry point ``entry`` (``factors``: the prologue's scale, shift)."""
    B, Cin, H, W = x.shape
    Cout = w.shape[0]
    if w.shape != (Cout, Cin, 3, 3) or b.shape != (Cout,):
        raise ValueError(f"weight {tuple(w.shape)} / bias {tuple(b.shape)} do not fit input {tuple(x.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise NotImplementedError(f"conv kernel takes bf16 only; got x {x.dtype}, w {w.dtype}")
    if Cin % 8 or Cout % 2:
        raise NotImplementedError(f"conv kernel needs Cin % 8 == 0 and Cout % 2 == 0; got {Cin}, {Cout}")
    xl = x.contiguous(memory_format=torch.channels_last)  # NHWC in memory
    wl = w.permute(0, 2, 3, 1).contiguous()  # (Cout, 3, 3, Cin)
    bf = b.float().contiguous()
    factors = [f.float().contiguous() for f in factors]
    out = torch.empty((B, Cout, H, W), dtype=x.dtype, device=x.device, memory_format=torch.channels_last)

    from aid_tpu_torch.ops import _build

    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = getattr(_build.library(), entry)(xl.data_ptr(), wl.data_ptr(), bf.data_ptr(), out.data_ptr(),
                                            *(f.data_ptr() for f in factors), B, H, W, Cin, Cout, stream)
    _build.check(code, f"{entry} launch")
    return out


def conv3x3_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, packed: bool = False) -> torch.Tensor:
    """y = conv2d(x, w, stride 1, SAME) + b.

    x: (B, Cin, H, W); w: (Cout, Cin, 3, 3); b: (Cout,). Accumulates in f32
    and returns x's dtype. ``packed`` names the JAX package's packed-K TPU
    kernel; on the card both flags launch the same kernel (module
    docstring). The kernel takes bf16 with Cin % 8 == 0 and Cout % 2 == 0
    and raises on anything else.
    """
    del packed  # one kernel serves both TPU contracts
    if not use_kernel(x, w, b):
        return conv3x3_same_plain(x, w, b)
    out = _launch("aid_conv3x3_bf16", x, w, b)
    conv3x3_same.launches += 1
    return out


#: kernel launches since the last reset (chip_smoke.py reads it around each path)
conv3x3_same.launches = 0


def gn_scale_shift(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, num_groups: int,
                   eps: float) -> tuple:
    """Per-(batch, channel) f32 factors with group_norm(x) * gamma + beta ==
    x * scale + shift, from the one-pass statistics var = E[x^2] - E[x]^2
    (aid_tpu/ops/conv.py:191-197). x: (B, C, H, W) -> two (B, C) f32 tensors."""
    B, C = x.shape[:2]
    if C % num_groups:
        raise ValueError(f"{C} channels do not split into {num_groups} groups")
    xf = x.float().reshape(B, num_groups, -1)
    mean = xf.mean(dim=-1)
    var = xf.square().mean(dim=-1) - mean.square()
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
    scale, shift = gn_scale_shift(x, gamma, beta, num_groups, eps)
    a = x.float() * scale[:, :, None, None] + shift[:, :, None, None]
    return F.conv2d(F.silu(a).to(x.dtype), w, b, padding=1)


def conv3x3_gnsilu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """y = conv2d(silu(group_norm(x, gamma, beta)), w, SAME) + b.

    x: (B, Cin, H, W); w: (Cout, Cin, 3, 3); b: (Cout,); gamma, beta: (Cin,).
    On CUDA the kernel takes bf16 x and w with Cin % 8 == 0 and Cout % 2 == 0
    and raises on anything else.
    """
    if not use_kernel(x, w, b, gamma, beta):
        return conv3x3_gnsilu_plain(x, w, b, gamma, beta, num_groups, eps)
    out = _launch("aid_conv3x3_gnsilu_bf16", x, w, b, *gn_scale_shift(x, gamma, beta, num_groups, eps))
    conv3x3_gnsilu.launches += 1
    return out


#: kernel launches since the last reset (chip_smoke.py reads it around each path)
conv3x3_gnsilu.launches = 0
