"""Smoothness and consistency metrics.

A copy of ``aid_tpu.metrics.gini`` (pure numpy; the port imports nothing of
the JAX package). ``compute_gini`` is the O(n log n) closed form of the
reference's O(n^2) double loop: the same value from the sorted-index
formula.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def compute_gini(distances: Sequence[float]) -> float:
    """Gini index of a distance vector; 0 for fewer than two entries and for
    all-zero distances (identical frames: a perfectly even spread, not the
    0/0 NaN that would poison the smoothness search)."""
    d = np.asarray(distances, np.float64)
    n = d.size
    if n < 2:
        return 0.0
    d = np.sort(d)
    # sum_{i,j} |d_i - d_j| = 2 * sum_i (2i - n + 1) d_(i) for sorted d
    idx = np.arange(n)
    sum_diff = 2.0 * np.sum((2 * idx - n + 1) * d)
    mean = d.mean()
    if mean <= 0.0:
        return 0.0
    return float(sum_diff / (2 * n * n * mean))


def compute_smoothness_and_consistency(distances: Sequence[float]) -> Tuple[float, float, float]:
    """(smoothness, consistency, max distance) of adjacent perceptual
    distances: 1 - Gini, the mean, and the largest."""
    d = np.asarray(distances, np.float64)
    return 1.0 - compute_gini(d), float(d.mean()), float(d.max())


def separate_source_and_interpolated_images(images: np.ndarray):
    """Split a sequence into its [first, last] sources and its middles."""
    if len(images) < 2:
        raise ValueError("The input array should have at least two elements.")
    source = np.array([images[0], images[-1]])
    return source, images[1:-1]
