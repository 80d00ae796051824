"""Perceptual metrics of a frame sequence: LPIPS and the Gini smoothness.

Exports what ``aid_tpu.metrics`` exports, under the same names.
"""

from aid_tpu_torch.metrics.gini import (
    compute_gini,
    compute_smoothness_and_consistency,
    separate_source_and_interpolated_images,
)
from aid_tpu_torch.metrics.lpips import LPIPS, VGG16Features, compute_lpips

__all__ = [
    "compute_gini",
    "compute_smoothness_and_consistency",
    "separate_source_and_interpolated_images",
    "LPIPS",
    "VGG16Features",
    "compute_lpips",
]
