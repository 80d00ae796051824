"""Denoising pipelines.

Exports what ``aid_tpu.pipelines`` exports, under the same names.
"""

from aid_tpu_torch.pipelines import engine
from aid_tpu_torch.pipelines.interpolation import InterpolationPipeline

__all__ = ["InterpolationPipeline", "engine"]
