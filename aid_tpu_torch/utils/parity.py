"""Read reference-exported latents and embeddings for fixed-seed runs.

Counterpart of ``aid_tpu.utils.parity``. The reference draws its initial
latents with torch's CUDA generator, which no other generator reproduces
bit for bit, so a parity run exports the reference's latents and prompt
embeddings once and feeds them here: both programs then denoise the same
starting state and their images compare directly
(``interpolate_single(latent_start=..., latent_end=...,
prompt_embeds_start=..., ...)``).

Formats: ``.npy`` / ``.npz`` (numpy), ``.safetensors`` (the port's reader),
torch ``.pt`` / ``.bin`` (``weights_only``). Where a file holds several
arrays, ``key`` picks one; without it the first (``.npz``: the first
stored; ``.safetensors``: the first name in sorted order, as the format's
own reader lists them; torch: the first entry). The port is NCHW, as the
reference is, so latents keep their layout unless their channel axis is
last; tensors land on ``device`` ("cuda" unless the caller asks for "cpu")
in f32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _load_array(path: str, key: Optional[str] = None) -> torch.Tensor:
    if path.endswith(".npy"):
        return torch.from_numpy(np.load(path))
    if path.endswith(".npz"):
        with np.load(path) as z:
            return torch.from_numpy(z[key] if key else z[z.files[0]])
    if path.endswith(".safetensors"):
        from aid_tpu_torch.utils.safetensors import load_safetensors

        tensors = load_safetensors(path)
        return tensors[key if key else sorted(tensors)[0]]
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, torch.Tensor):
        return obj
    return torch.as_tensor(obj[key] if key else next(iter(obj.values())))


def load_reference_latents(path: str, key: Optional[str] = None, device="cuda") -> torch.Tensor:
    """Exported latents, (N, C, H, W) or (C, H, W) -> (N, C, H, W) f32 on
    ``device``. An (N, H, W, C) array, told by its channel axis being last
    (at most 8 channels and fewer than the first spatial size: the mirror
    of the JAX package's rule, parity.py:61-63), is turned to NCHW."""
    x = _load_array(path, key).float()
    if x.dim() == 3:
        x = x[None]
    if x.dim() != 4:
        raise ValueError(f"latents must be 3D/4D, got {tuple(x.shape)}")
    if x.shape[-1] <= 8 and x.shape[-1] < x.shape[1]:
        x = x.permute(0, 3, 1, 2)
    return x.contiguous().to(device)


def load_reference_embeds(path: str, key: Optional[str] = None, device="cuda") -> torch.Tensor:
    """Exported prompt or image embeddings -> (N, ..., D) f32 on ``device``
    in their own layout ((N, 77, D) text, (N, D) image; a 1-D vector gains
    a batch axis)."""
    x = _load_array(path, key).float()
    return (x[None] if x.dim() == 1 else x).to(device)


def image_stats(images: np.ndarray) -> dict:
    """Summary statistics of (N, H, W, 3) frames for an offline comparison
    between two programs (parity.py:80-90)."""
    x = np.asarray(images, np.float64)
    return {
        "shape": list(x.shape),
        "mean": float(x.mean()),
        "std": float(x.std()),
        "frame_means": [float(m) for m in x.mean(axis=tuple(range(1, x.ndim)))],
        "corner_patches": x[:, :8, :8, 0].tolist() if x.ndim == 4 else None,
    }
