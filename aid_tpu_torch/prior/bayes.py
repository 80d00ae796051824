"""Bayesian (alpha, beta) selection with a numpy GP optimizer.

Counterpart of ``aid_tpu.prior.bayes`` (bayes.py:93-185), numpy as there:
choose the Beta-prior parameters that maximise the LPIPS smoothness of the
generated sequence, with the directional prior from the midpoint frame's
LPIPS distances, a 3x3 probe grid with early exit, then GP-UCB iterations
(Matern-5/2 kernel, ``np.random.default_rng(seed)`` candidates) with the
search window shrinking around the incumbent.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from aid_tpu_torch.metrics.gini import compute_smoothness_and_consistency


def _matern52(a: np.ndarray, b: np.ndarray, length: float) -> np.ndarray:
    d = np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)) / length
    s5 = np.sqrt(5.0) * d
    return (1.0 + s5 + 5.0 / 3.0 * d ** 2) * np.exp(-s5)


@dataclasses.dataclass
class GPOptimizer:
    """Minimal GP-UCB maximizer over a box domain."""

    bounds: np.ndarray  # (dim, 2)
    kappa: float = 2.576
    noise: float = 1e-6
    seed: int = 1
    window_shrink: float = 0.9
    minimum_window: float = 0.1

    def __post_init__(self):
        self.X: List[np.ndarray] = []
        self.y: List[float] = []
        self.rng = np.random.default_rng(self.seed)
        self._bounds = np.array(self.bounds, np.float64)

    def register(self, x, y: float):
        self.X.append(np.asarray(x, np.float64))
        self.y.append(float(y))
        self._shrink_window()

    def _shrink_window(self):
        """Contract the search box around the incumbent (domain reduction)."""
        if len(self.y) < 4:
            return
        best = self.X[int(np.argmax(self.y))]
        width = (self._bounds[:, 1] - self._bounds[:, 0]) * self.window_shrink
        width = np.maximum(width, self.minimum_window)
        lo = np.maximum(best - width / 2, self.bounds[:, 0])
        hi = np.minimum(best + width / 2, self.bounds[:, 1])
        hi = np.maximum(hi, lo + self.minimum_window)
        self._bounds = np.stack([lo, hi], axis=1)

    def _posterior(self, Xq: np.ndarray):
        X = np.stack(self.X)
        y = np.asarray(self.y)
        y_mean, y_std = y.mean(), y.std() + 1e-9
        yn = (y - y_mean) / y_std
        length = np.mean(self._bounds[:, 1] - self._bounds[:, 0]) / 4 + 1e-9
        K = _matern52(X, X, length) + self.noise * np.eye(len(X))
        Ks = _matern52(Xq, X, length)
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))
        mu = Ks @ alpha
        v = np.linalg.solve(L, Ks.T)
        var = np.clip(1.0 - (v ** 2).sum(0), 1e-12, None)
        return mu * y_std + y_mean, np.sqrt(var) * y_std

    def suggest(self) -> np.ndarray:
        if not self.X:
            return self._bounds.mean(axis=1)
        cand = self.rng.uniform(self._bounds[:, 0], self._bounds[:, 1], size=(256, self._bounds.shape[0]))
        mu, sigma = self._posterior(cand)
        return cand[int(np.argmax(mu + self.kappa * sigma))]

    @property
    def max(self) -> Dict:
        i = int(np.argmax(self.y))
        return {"target": self.y[i], "params": self.X[i]}


def bayesian_prior_selection(
    interpolation_pipe,
    latent1,
    latent2,
    prompt1: str,
    prompt2: str,
    lpips_fn: Callable[[np.ndarray], np.ndarray],
    guide_prompt: Optional[str] = None,
    negative_prompt: str = "",
    size: int = 3,
    num_inference_steps: int = 25,
    warmup_ratio: float = 1.0,
    early: str = "fused_outer",
    late: str = "self",
    target_score: float = 0.9,
    n_iter: int = 15,
    p_min: Optional[float] = None,
    p_max: Optional[float] = None,
) -> Tuple[float, float]:
    """Select (alpha, beta) maximizing sequence smoothness.

    ``lpips_fn``: images (N,H,W,3) -> (N-1,) adjacent perceptual distances
    (``metrics.lpips.compute_lpips`` with a model bound, or a fake for tests).
    Mirrors reference prior.py:343-478 including the directional prior: if
    the midpoint frame is perceptually closer to the first source, alpha
    should exceed beta (prior.py:418-438), enforced by zeroing the objective
    on the wrong side.

    Objective cost: the reference's objective drives interpolate_save_gpu's
    (size-2) separate 3-frame runs per BO step (prior.py:398-412),
    3(size-2) frame-denoises each. Here the objective asks for
    interpolate_save_gpu's batched path (one size-frame run at the Beta-PPF
    points, the same output), so each BO step costs ``size``
    frame-denoises. (interpolate_save_gpu itself defaults to the reference's
    sequential, memory-light structure.)
    """

    def smoothness_of(images) -> float:
        s, _, _ = compute_smoothness_and_consistency(lpips_fn(images))
        return s

    # directional prior from the t=0.5 frame
    mid = interpolation_pipe.interpolate_single(
        0.5, latent1, latent2, prompt1, prompt2, guide_prompt=guide_prompt,
        negative_prompt=negative_prompt, num_inference_steps=num_inference_steps,
        warmup_ratio=warmup_ratio, early=early, late=late,
    )
    distances = lpips_fn(mid)
    # reuse the distances just computed (smoothness_of would re-run the
    # full LPIPS forward on the same frames)
    init_smoothness, _, _ = compute_smoothness_and_consistency(distances)
    large_alpha_prior = bool(distances[0] < distances[1])

    def get_smoothness(alpha: float, beta: float) -> float:
        if alpha < beta and large_alpha_prior:
            return 0.0
        if alpha > beta and not large_alpha_prior:
            return 0.0
        if alpha == beta:
            return init_smoothness
        seq = interpolation_pipe.interpolate_save_gpu(
            latent1, latent2, prompt1, prompt2, guide_prompt=guide_prompt,
            negative_prompt=negative_prompt, size=size,
            num_inference_steps=num_inference_steps, warmup_ratio=warmup_ratio,
            early=early, late=late, alpha=alpha, beta=beta,
            batched=True,  # the BO objective is the hot loop
        )
        return smoothness_of(seq)

    if p_min is None:
        p_min = 1.0
    if p_max is None:
        p_max = warmup_ratio * num_inference_steps
    opt = GPOptimizer(bounds=np.array([[p_min, p_max], [p_min, p_max]]))

    # 3x3 probe grid with early exit (prior.py:455-465)
    grid = [p_min, (p_min + p_max) / 2, p_max]
    for a in grid:
        for b in grid:
            score = get_smoothness(a, b)
            opt.register([a, b], score)
            if score >= target_score:
                return a, b

    for _ in range(n_iter):
        a, b = opt.suggest()
        opt.register([a, b], get_smoothness(float(a), float(b)))
        if opt.max["target"] >= target_score:
            break

    best = opt.max["params"]
    return float(best[0]), float(best[1])
