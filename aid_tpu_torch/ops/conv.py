"""3x3 stride-1 SAME convolution: the hand-written Hopper kernel and its plain version.

``conv3x3_same`` is the counterpart of ``aid_tpu.ops.conv.conv3x3_same``
(packed=False). On a CUDA tensor it launches ``csrc/conv3x3.cu``, which
replaces the Pallas TPU kernel ``aid_tpu/ops/conv.py::_kernel``
(conv.py:30-44, called through ``_call_9dot``, conv.py:226-243); the source's
header says what bounds it on the card and how the design answers. On a CPU
tensor it runs :func:`conv3x3_same_plain` (``F.conv2d``).

The interface keeps PyTorch's NCHW / OIHW layout. The kernel reads
channels-last activations (NHWC in memory) and (Cout, 3, 3, Cin) weights, so
the wrapper converts both, and returns a channels-last tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from aid_tpu_torch.ops.routing import use_kernel


def conv3x3_same_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y = conv2d(x, w, stride 1, padding 1) + b (the kernel's plain version)."""
    return F.conv2d(x, w, b, padding=1)


def conv3x3_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y = conv2d(x, w, stride 1, SAME) + b.

    x: (B, Cin, H, W); w: (Cout, Cin, 3, 3); b: (Cout,). Accumulates in f32
    and returns x's dtype. The kernel takes bf16 with Cin % 8 == 0 and
    Cout % 2 == 0 and raises on anything else.
    """
    if not use_kernel(x, w, b):
        return conv3x3_same_plain(x, w, b)
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
    out = torch.empty((B, Cout, H, W), dtype=x.dtype, device=x.device, memory_format=torch.channels_last)

    from aid_tpu_torch.ops import _build

    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.aid_conv3x3_bf16(xl.data_ptr(), wl.data_ptr(), bf.data_ptr(), out.data_ptr(),
                                B, H, W, Cin, Cout, stream)
    _build.check(code, "conv3x3_same launch")
    conv3x3_same.launches += 1
    return out


#: kernel launches since the last reset (chip_smoke.py reads it around the main path)
conv3x3_same.launches = 0
