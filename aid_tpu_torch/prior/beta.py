"""Beta-prior dynamic selection: CLIP-scored exploration and a smooth-path DP.

Counterpart of ``aid_tpu.prior.beta`` (beta.py:27-344), host logic in numpy
and scipy as there:
  * ``BetaPriorPipeline``: explore-then-select interpolation. Frames are
    inserted one gap at a time at the largest perceptual gap, each new
    coefficient at the Beta-CDF midpoint of its gap; (alpha, beta) are
    refitted by least squares on the cumulative-distance curve; then the
    most perceptually even subsequence is extracted by a minimal-spread DP
    path search.
  * ``batch_k`` > 1 explores the k largest gaps of a round in one
    (k + 2)-frame ``interpolate`` (``_gen_batch``); 1 is the reference's
    sequence.

Frame generation and the CLIP features run on the pipeline's device; the
insertion loop, ``curve_fit`` and the DP search run on the host. The port's
pipeline takes ``torch.Generator``s, so the missing latents of a batched
round come from ``pipe._seeded_latent(seed)`` and ``(seed + 1)``, the
seeds the JAX package uses.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
from scipy.optimize import curve_fit

from aid_tpu_torch.ops.interp import beta_cdf, beta_ppf


def fit_alpha_beta(xs: Sequence[float], ds: Sequence[float]) -> Tuple[float, float]:
    """Least-squares fit of Beta(a,b) CDF to the normalized cumulative
    perceptual-distance curve (reference prior.py:35-56)."""
    ds = np.asarray(ds, np.float64)
    uniform_points = np.concatenate([[0.0], np.cumsum(ds / ds.sum())])
    xs = np.asarray(xs, np.float64)

    def f(x, a, b):
        return beta_cdf(x, a, b)

    params, _ = curve_fit(
        f, xs, uniform_points, p0=[1.0, 1.0],
        bounds=([1e-6, 1e-6], [np.inf, np.inf]),
    )
    return float(params[0]), float(params[1])


def find_minimal_spread_and_path(n: int, m: int, weights: np.ndarray):
    """Select the n-node path 0 -> m-1 minimizing max-min edge-weight spread.

    Binary search over the spread D with a DP feasibility check
    (reference prior.py:223-297). Tries the C++ solver first
    (``prior/dp_solver.py``, built at first use), the Python search when it
    cannot be built or finds no path.
    """
    from aid_tpu_torch.prior import dp_solver

    try:
        return dp_solver.find_minimal_spread_and_path(n, m, weights)
    except (OSError, ValueError):  # no compiler or no path found natively: the Python search decides
        return _find_minimal_spread_and_path_py(n, m, weights)


def _find_minimal_spread_and_path_py(n: int, m: int, weights: np.ndarray):
    W = sorted({weights[i][j] for i in range(m - 1) for j in range(i + 1, m) if weights[i][j] != -1})
    low, high = 0.0, W[-1] - W[0]
    eps = 1e-6
    best_D, best_path = None, None
    while high - low > eps:
        D = (low + high) / 2
        path = _is_path_possible(D, n, m, weights, W)
        if path is not None:
            high, best_D, best_path = D, D, path
        else:
            low = D
    if best_path is None:
        # The bisection probes strictly below the upper bound, so instances
        # whose minimal feasible spread IS the full weight range — including
        # all-equal weights (high == 0, loop never runs) — need one probe at
        # the bound itself. The reference (prior.py:239-254) returns
        # (None, None) here and its caller crashes; documented deviation.
        path = _is_path_possible(high, n, m, weights, W)
        if path is not None:
            best_D, best_path = high, path
    return best_D, best_path


def _is_path_possible(D: float, n: int, m: int, weights: np.ndarray, W: Sequence[float]):
    for w_min in W:
        w_max = w_min + D
        if w_max > W[-1]:
            break
        # dp[i][l] = (max_w, min_w, path) best state reaching node i with l nodes
        dp = [[None] * (n + 1) for _ in range(m)]
        dp[0][1] = (float("-inf"), float("inf"), [0])
        for l in range(1, n):
            for i in range(m):
                if dp[i][l] is None:
                    continue
                max_w, min_w, path = dp[i][l]
                for j in range(i + 1, m):
                    w = weights[i][j]
                    if w != -1 and w_min <= w <= w_max:
                        nmax, nmin = max(max_w, w), min(min_w, w)
                        if nmax - nmin <= D:
                            cur = dp[j][l + 1]
                            if cur is None or (nmax - nmin) < (cur[0] - cur[1]):
                                dp[j][l + 1] = (nmax, nmin, path + [j])
        if dp[m - 1][n] is not None:
            return dp[m - 1][n][2]
    return None


class BetaPriorPipeline:
    """Explore-then-select interpolation (reference prior.py:12-340).

    ``pipe``: an interpolation pipeline exposing ``interpolate_single`` that
    returns uint8 images (N, H, W, 3).
    ``feature_fn``: images -> (N, D) feature array (CLIP image features on
    device, ``clip_scorer.make_clip_feature_fn``; any callable: tests inject
    a deterministic scorer).
    """

    def __init__(self, pipe, feature_fn: Callable[[np.ndarray], np.ndarray]):
        self.pipe = pipe
        self.feature_fn = feature_fn

    @staticmethod
    def _dist(fa: np.ndarray, fb: np.ndarray) -> float:
        """1 - cosine similarity (reference prior.py:18-22)."""
        fa, fb = fa.ravel(), fb.ravel()
        cos = float(np.dot(fa, fb) / (np.linalg.norm(fa) * np.linalg.norm(fb)))
        return 1.0 - cos

    def _gen(self, t: float, **kw) -> np.ndarray:
        # exploration default (reference prior.py:134 early="fused_outer"),
        # overridable by caller kwargs without a keyword collision
        kw.setdefault("early", "fused_outer")
        ims = self.pipe.interpolate_single(t, **kw)
        return ims

    # interpolate_single-only kwargs the full-sequence engine cannot take:
    # their presence (or a non-linear init) forces sequential generation,
    # mirroring interpolate_save_gpu's documented fallback.
    _SINGLE_ONLY_KW = frozenset({
        "guidance_rescale", "image_embeds_start", "image_embeds_end",
        "negative_image_embeds", "prompt_embeds_start", "prompt_embeds_end",
        "negative_prompt_embeds", "guide_prompt_embeds",
    })

    @classmethod
    def _batchable(cls, kw) -> bool:
        """Whether kwargs can ride the full-sequence ``interpolate`` engine
        (it lerps embeds and has no IP/rescale/embeds-bypass surface)."""
        if kw.get("init", "linear") != "linear":
            return False
        return not any(kw.get(k) is not None for k in cls._SINGLE_ONLY_KW
                       if k != "guidance_rescale") and not kw.get("guidance_rescale")

    def _gen_batch(self, ts: Sequence[float], **kw) -> np.ndarray:
        """Generate middle frames at coefficient points ``ts`` in ONE
        batched (k+2)-frame run: every AID mode sources K/V only from the endpoint rows, so
        each frame equals the middle of a 3-frame interpolate_single run at
        the same point (tests/test_torch_prior.py checks it). Returns
        the (k, H, W, 3) middle frames in ``ts`` order. Callers must gate on
        ``_batchable`` — interpolate_single-only kwargs are rejected here."""
        kw = dict(kw)
        kw.setdefault("early", "fused_outer")
        assert self._batchable(kw), (
            "kwargs incompatible with the batched engine: "
            f"{sorted(k for k in self._SINGLE_ONLY_KW if kw.get(k) is not None)}"
            f" init={kw.get('init', 'linear')!r}")
        kw.pop("init", None)
        for k in self._SINGLE_ONLY_KW:
            kw.pop(k, None)
        seed = kw.pop("seed", 0)
        if kw.get("latent_start") is None:
            kw["latent_start"] = self.pipe._seeded_latent(seed)
        if kw.get("latent_end") is None:
            kw["latent_end"] = self.pipe._seeded_latent(seed + 1)
        order = np.argsort(ts, kind="stable")
        full = np.concatenate([[0.0], np.asarray(ts, np.float32)[order], [1.0]])
        ims = self.pipe.interpolate(ts=full, **kw)
        middles = np.asarray(ims[1:-1])
        inv = np.empty(len(order), np.intp)
        inv[order] = np.arange(len(order))
        return middles[inv]

    def explore_with_beta(
        self,
        prompt_start: str,
        prompt_end: str,
        negative_prompt: str = "",
        latent_start=None,
        latent_end=None,
        num_inference_steps: int = 28,
        exploration_size: int = 16,
        init_alpha: float = 3.0,
        init_beta: float = 3.0,
        uniform: bool = False,
        verbose: bool = False,
        batch_k: int = 1,
        **kwargs,
    ):
        """Iterative largest-gap exploration (reference prior.py:119-199).

        ``batch_k``: candidate points explored per round. 1 (default)
        reproduces the reference's sequential insert-refit-insert sequence
        exactly. k>1 picks the k largest gaps' midpoints with the CURRENT
        (alpha, beta) fit and generates them in ONE (k+2)-frame batched run
        and refits once per round: a different (but
        equally valid) exploration sequence that amortizes the endpoint
        re-denoise: k+2 frame-denoises per k points vs 3 per point.
        """
        kw = dict(
            prompt_start=prompt_start, prompt_end=prompt_end,
            negative_prompt=negative_prompt, latent_start=latent_start,
            latent_end=latent_end, num_inference_steps=num_inference_steps,
            **kwargs,
        )
        if batch_k > 1 and not self._batchable(kw):
            import warnings

            warnings.warn(
                "batch_k > 1 requested with interpolate_single-only kwargs "
                "(IP embeds / embeds bypass / guidance_rescale / non-linear "
                "init); falling back to sequential exploration (batch_k=1)",
                stacklevel=2,
            )
            batch_k = 1
        xs = [0.0, 0.5, 1.0]
        ims = self._gen(0.5, **kw)
        images = [ims[0], ims[1], ims[2]]
        features = list(self.feature_fn(np.stack([np.asarray(im) for im in images])))
        ds = [self._dist(features[0], features[1]), self._dist(features[1], features[2])]
        alpha, beta = init_alpha, init_beta

        def _midpoint(idx):
            A, B = xs[idx], xs[idx + 1]
            if uniform:
                return (A + B) / 2.0
            # Beta-CDF midpoint of the gap (prior.py:75-89)
            F_t = (beta_cdf(A, alpha, beta) + beta_cdf(B, alpha, beta)) / 2.0
            return float(beta_ppf(F_t, alpha, beta))

        def _insert(idx, t, new_img, new_feat):
            d1 = self._dist(features[idx], new_feat)
            d2 = self._dist(features[idx + 1], new_feat)
            images.insert(idx + 1, new_img)
            features.insert(idx + 1, new_feat)
            xs.insert(idx + 1, t)
            del ds[idx]
            ds.insert(idx, d1)
            ds.insert(idx + 1, d2)

        while len(xs) < exploration_size:
            if uniform:
                # reference prior.py:87-89: uniform mode picks the widest
                # COEFFICIENT gap (not the largest perceptual-distance gap)
                # and bisects it at the arithmetic midpoint
                gaps = np.diff(np.asarray(xs))
                ranked = np.argsort(-gaps, kind="stable")  # ties: first gap wins (argmax semantics)
            else:
                ranked = np.argsort(-np.asarray(ds), kind="stable")
            k = max(1, min(batch_k, exploration_size - len(xs)))
            cand = []  # (gap index, midpoint) for the k largest gaps
            for idx in ranked[:k]:
                t = _midpoint(int(idx))
                if (0.0 < t < 1.0) and np.isfinite(t):
                    cand.append((int(idx), t))
            if not cand:
                break
            if len(cand) == 1:
                idx, t = cand[0]
                new_imgs = self._gen(t, **kw)[1:2]
            else:
                new_imgs = self._gen_batch([t for _, t in cand], **kw)
            new_feats = self.feature_fn(
                np.stack([np.asarray(im) for im in new_imgs]))
            # insert in descending gap-index order so earlier inserts don't
            # shift later candidates' gap indices
            for (idx, t), img, new_feat in sorted(
                    zip(cand, new_imgs, new_feats), key=lambda p: -p[0][0]):
                _insert(idx, t, img, new_feat)
            if uniform:
                alpha, beta = 1.0, 1.0
            else:
                try:
                    alpha, beta = fit_alpha_beta(xs, ds)
                except Exception:
                    pass  # keep previous fit if curve_fit fails
            if verbose:
                print(f"exploration {len(xs)}/{exploration_size} alpha={alpha:.3f} beta={beta:.3f} xs={xs}")

        return images, features, ds, xs, alpha, beta

    def extract_uniform_points(self, ds: Sequence[float], interpolation_size: int) -> List[int]:
        """Greedy cumulative-distance thresholding (reference prior.py:201-210)."""
        expected = sum(ds) / (interpolation_size - 1)
        current, out = 0.0, [0]
        for idx, d in enumerate(ds):
            current += d
            if current >= expected:
                out.append(idx)
                current = 0.0
        return out

    def extract_uniform_points_plus(self, features: Sequence[np.ndarray], interpolation_size: int) -> List[int]:
        """Minimal-spread smooth path over the all-pairs CLIP distance matrix
        (reference prior.py:212-221)."""
        m = len(features)
        weights = -np.ones((m, m))
        for i in range(m):
            for j in range(i + 1, m):
                weights[i][j] = self._dist(features[i], features[j])
        _, path = find_minimal_spread_and_path(interpolation_size, m, weights)
        return path

    def generate_interpolation(
        self,
        prompt_start: str,
        prompt_end: str,
        negative_prompt: str = "",
        latent_start=None,
        latent_end=None,
        num_inference_steps: int = 28,
        exploration_size: int = 16,
        init_alpha: float = 3.0,
        init_beta: float = 3.0,
        interpolation_size: int = 7,
        uniform: bool = False,
        batch_k: int = 1,
        **kwargs,
    ) -> List[np.ndarray]:
        """Explore then select (reference prior.py:299-340). Stashes
        images/ds/xs/alpha/beta_param for inspection, like the reference.
        ``batch_k`` > 1 enables batched candidate exploration (see
        explore_with_beta)."""
        images, features, ds, xs, alpha, beta = self.explore_with_beta(
            prompt_start, prompt_end, negative_prompt, latent_start, latent_end,
            num_inference_steps, exploration_size, init_alpha, init_beta,
            uniform=uniform, batch_k=batch_k, **kwargs,
        )
        idxs = self.extract_uniform_points_plus(features, interpolation_size)
        self.images, self.ds, self.xs = images, ds, xs
        self.alpha, self.beta_param = alpha, beta
        return [images[i] for i in idxs]
