"""Interpolation math: lerp, numerically-guarded slerp, Beta-PPF schedules.

PyTorch counterpart of ``aid_tpu.ops.interp``. The Beta schedule is host
numpy/scipy and is copied as is; ``lerp``/``slerp`` are torch and
branch-free (``torch.where``), so they run on any device without a sync.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.stats import beta as _beta_dist

#: |dot| above this means the vectors are treated as colinear and lerped.
SLERP_COLINEAR_THRESHOLD = 0.9995


def lerp(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    """Linear interpolation ``a + t * (b - a)`` (torch.lerp semantics)."""
    return a + t * (b - a)


def slerp(v0: torch.Tensor, v1: torch.Tensor, t, threshold: float = SLERP_COLINEAR_THRESHOLD) -> torch.Tensor:
    """Spherical linear interpolation over the last axis.

    Rows whose normalized dot product is NaN (zero vectors) or has magnitude
    above ``threshold`` fall back to lerp; the rest take the great-circle
    path.
    """
    v0_norm = torch.linalg.vector_norm(v0, dim=-1, keepdim=True)
    v1_norm = torch.linalg.vector_norm(v1, dim=-1, keepdim=True)
    dot = torch.sum((v0 / v0_norm) * (v1 / v1_norm), dim=-1, keepdim=True)
    dot_mag = dot.abs()
    gotta_lerp = torch.isnan(dot_mag) | (dot_mag > threshold)

    lerped = lerp(v0, v1, t)

    # Clamp dot into the arccos domain and keep sin(theta_0) away from zero
    # so the unselected branch never poisons the output with NaNs.
    theta_0 = torch.arccos(dot.clamp(-1.0, 1.0))
    sin_theta_0 = torch.sin(theta_0)
    sin_theta_0_safe = torch.where(sin_theta_0.abs() < 1e-12, torch.ones_like(sin_theta_0), sin_theta_0)
    theta_t = theta_0 * t
    s0 = torch.sin(theta_0 - theta_t) / sin_theta_0_safe
    s1 = torch.sin(theta_t) / sin_theta_0_safe
    slerped = s0 * v0 + s1 * v1
    return torch.where(gotta_lerp, lerped, slerped)


def _schedule(ts, size: int, like: torch.Tensor) -> torch.Tensor:
    """``ts`` as an f32 tensor on ``like``'s device, or uniform i/(size-1)."""
    if ts is None:
        return torch.linspace(0.0, 1.0, size, device=like.device)
    return torch.as_tensor(np.asarray(ts, np.float32), device=like.device)


def linear_interpolation(l1: torch.Tensor, l2: torch.Tensor, ts=None, size: int = 5) -> torch.Tensor:
    """Batched lerp between two ``(1, *)`` tensors -> ``(size, *)``; ``ts``,
    when given, is the coefficient schedule (and sets the size)."""
    if l1.shape != l2.shape:
        raise ValueError(f"shapes of l1 and l2 must match: {tuple(l1.shape)} vs {tuple(l2.shape)}")
    t = _schedule(ts, size, l1).reshape((-1,) + (1,) * (l1.dim() - 1))
    return lerp(l1, l2, t).reshape((t.shape[0],) + tuple(l1.shape[1:]))


def spherical_interpolation(l1: torch.Tensor, l2: torch.Tensor, size: int = 5, ts=None) -> torch.Tensor:
    """Batched slerp between two ``(1, *)`` tensors -> ``(size, *)``; ``ts``,
    when given, is the coefficient schedule (and sets the size)."""
    if l1.shape != l2.shape:
        raise ValueError(f"shapes of l1 and l2 must match: {tuple(l1.shape)} vs {tuple(l2.shape)}")
    t = _schedule(ts, size, l1).reshape((-1,) + (1,) * (l1.dim() - 1))
    out = slerp(l1[None], l2[None], t[:, None])
    return out.reshape((t.shape[0],) + tuple(l1.shape[1:]))


def beta_ppf(q, alpha: float, beta: float) -> np.ndarray:
    """Host-side Beta(alpha, beta) inverse CDF (percent point function)."""
    return _beta_dist.ppf(q, alpha, beta)


def beta_cdf(x, alpha: float, beta: float) -> np.ndarray:
    """Host-side Beta(alpha, beta) CDF."""
    return _beta_dist.cdf(x, alpha, beta)


def generate_beta_schedule(size: int, alpha: float = 3.0, beta: float = 3.0, force_endpoints: bool = False) -> np.ndarray:
    """Coefficient schedule x_i with Beta-CDF F(x_i) = i/(size-1).

    ``force_endpoints`` overwrites ``ts[0], ts[-1] = 0, 1`` (Beta PPF already
    yields 0 and 1 at the endpoints for finite alpha/beta, but forcing
    protects against NaN for degenerate parameters). Returned as float32
    numpy.
    """
    qs = np.array([i / (size - 1) for i in range(size)])
    ts = _beta_dist.ppf(qs, alpha, beta).astype(np.float32)
    if force_endpoints:
        ts[0], ts[-1] = 0.0, 1.0
    return ts
