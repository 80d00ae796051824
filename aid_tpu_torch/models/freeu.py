"""FreeU (arXiv:2309.11497): backbone scaling and skip low-pass filtering.

Counterpart of ``aid_tpu.models.freeu`` (diffusers' ``enable_freeu``
surface): the first two up blocks scale the first half of the backbone's
channels by ``b`` and scale the low-frequency block of the skip features'
2D spectrum by ``s``. Tensors are NCHW here, so the spectrum is taken over
dims 2 and 3.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class FreeUConfig:
    """Stage-0/1 parameters (diffusers ``enable_freeu(s1, s2, b1, b2)``).

    Recommended values: SD1.x s1=0.9 s2=0.2 b1=1.2 b2=1.4; SDXL s1=0.6
    s2=0.4 b1=1.1 b2=1.2.
    """

    s1: float = 0.9
    s2: float = 0.2
    b1: float = 1.2
    b2: float = 1.4


def fourier_filter(x: torch.Tensor, threshold: int, scale: float) -> torch.Tensor:
    """Scale the low-frequency block of the 2D spectrum of NCHW ``x`` by
    ``scale``, in f32: after the shift, rows and columns in the half-open
    ``[c - threshold, c + threshold)`` around the centre ``c = size // 2``
    (a 2t x 2t block, as diffusers slices it). Returns x's dtype."""
    freq = torch.fft.fftshift(torch.fft.fftn(x.float(), dim=(2, 3)), dim=(2, 3))
    H, W = x.shape[2:]
    rows = torch.arange(H, device=x.device)
    cols = torch.arange(W, device=x.device)
    low = (((rows >= H // 2 - threshold) & (rows < H // 2 + threshold))[:, None]
           & ((cols >= W // 2 - threshold) & (cols < W // 2 + threshold))[None, :])
    freq = freq * torch.where(low, scale, 1.0)
    freq = torch.fft.ifftshift(freq, dim=(2, 3))
    return torch.fft.ifftn(freq, dim=(2, 3)).real.to(x.dtype)


def apply_freeu(up_idx: int, hidden: torch.Tensor, skip: torch.Tensor, cfg: Optional[FreeUConfig]):
    """FreeU on (backbone hidden, skip) before up block ``up_idx``'s concat:
    stage 0 uses (b1, s1), stage 1 (b2, s2), later stages nothing."""
    if cfg is None or up_idx > 1:
        return hidden, skip
    b = cfg.b1 if up_idx == 0 else cfg.b2
    s = cfg.s1 if up_idx == 0 else cfg.s2
    half = hidden.shape[1] // 2
    hidden = torch.cat([hidden[:, :half] * b, hidden[:, half:]], dim=1)
    return hidden, fourier_filter(skip, threshold=1, scale=s)
