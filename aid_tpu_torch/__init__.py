"""aid_tpu_torch: the AID/PAID port to PyTorch and hand-written CUDA kernels for Hopper.

The JAX package ``aid_tpu`` is the reference; this package never imports it
(nor jax or flax). Layout mirrors ``aid_tpu``:

  ops/        interpolation math, interpolated attention (plain version +
              flash kernel wrappers, bf16 D=64 and f32 D=512), 3x3 conv and
              GN+SiLU conv kernel wrappers, kernel build
  csrc/       the CUDA C++ kernels (sm_90a), built by ops/_build.py at first use
  models/     configs, UNet building blocks, UNet2DCondition, VAE decode,
              CLIP text encoder, param conversion
  schedulers/ Euler
  pipelines/  the warmup-split CFG denoise engine, VAE decode to uint8, the
              SDXL interpolate pipeline
  utils/      tokenizers

On a CPU tensor every op runs its plain PyTorch version; on a CUDA tensor it
runs its kernel (see ``ops/routing.py``).
"""

from aid_tpu_torch.models.configs import SDXL_UNET, TINY_SDXL_UNET, TINY_UNET, UNetConfig
from aid_tpu_torch.models.layers import AidContext, AidMode
from aid_tpu_torch.models.unet import UNet2DCondition
from aid_tpu_torch.ops.attention import AttnMode
from aid_tpu_torch.ops.interp import generate_beta_schedule
from aid_tpu_torch.pipelines.engine import denoise_sequence
from aid_tpu_torch.pipelines.sdxl import InterpolationXLPipeline
from aid_tpu_torch.schedulers.euler import EulerDiscreteScheduler

__all__ = [
    "AidContext", "AidMode", "AttnMode", "EulerDiscreteScheduler", "InterpolationXLPipeline", "SDXL_UNET",
    "TINY_SDXL_UNET", "TINY_UNET", "UNet2DCondition", "UNetConfig", "denoise_sequence", "generate_beta_schedule",
]
