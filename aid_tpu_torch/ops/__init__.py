"""Ops: interpolation math, interpolated attention and the 3x3 conv, each with its kernel wrapper.

Exports what ``aid_tpu.ops`` exports, under the same names.
"""

from aid_tpu_torch.ops.attention import AttnMode, attention, interpolated_attention
from aid_tpu_torch.ops.interp import (
    beta_cdf,
    beta_ppf,
    generate_beta_schedule,
    lerp,
    linear_interpolation,
    slerp,
    spherical_interpolation,
)

__all__ = [
    "lerp",
    "slerp",
    "linear_interpolation",
    "spherical_interpolation",
    "generate_beta_schedule",
    "beta_ppf",
    "beta_cdf",
    "AttnMode",
    "interpolated_attention",
    "attention",
]
