"""aid_tpu_torch: the AID/PAID port to PyTorch and hand-written CUDA kernels for Hopper.

The JAX package ``aid_tpu`` is the reference; this package never imports it
(nor jax or flax). Layout mirrors ``aid_tpu``:

  ops/        interpolation math, plain and interpolated attention (the
              plain version and the flash kernels' wrappers: bf16, f16 and
              f32 at every head dim up to 2048), 3x3 conv and GN+SiLU conv
              kernel wrappers, kernel build
  csrc/       the CUDA C++ kernels (sm_90a), built by ops/_build.py at first use
  models/     configs, UNet building blocks, UNet2DCondition, VAE decode,
              CLIP text and vision towers, the safety checker, param
              conversion (LDM single files, LoRA merge, textual
              inversion), the loader (diffusers directories, single files)
  prior/      the coefficient selection: Beta-prior explore-and-select (its
              DP search native through ctypes), Bayesian (alpha, beta)
              search, the CLIP scorer
  metrics/    LPIPS and the Gini smoothness
  schedulers/ DDIM, Euler, PNDM, UniPC, EDM DPM-Solver++
  pipelines/  the warmup-split CFG denoise engine, VAE decode to uint8, the
              SD1.x interpolation pipeline and its SDXL subclass
  utils/      tokenizers, the safetensors reader, the invisible watermark,
              the readers of exported latents and embeddings, the phase
              timer and profiler trace, image strips and grids, the
              matmul+conv FLOP counter and MFU (utils/flops.py)
  parallel/   frame parallelism (frames sharded over ranks, the endpoint
              K/V all-gathered) and tensor parallelism on torch.distributed
  apps/       the Gradio app

On a CPU tensor every op runs its plain PyTorch version; on a CUDA tensor it
runs its kernel (see ``ops/routing.py``).
"""

__version__ = "0.1.0"

from aid_tpu_torch.models.configs import SD15_UNET, SDXL_UNET, TINY_SDXL_UNET, TINY_UNET, UNetConfig
from aid_tpu_torch.models.layers import AidContext, AidMode
from aid_tpu_torch.models.unet import UNet2DCondition
from aid_tpu_torch.ops.attention import AttnMode
from aid_tpu_torch.ops.interp import generate_beta_schedule
from aid_tpu_torch.pipelines.engine import denoise_sequence
from aid_tpu_torch.pipelines.interpolation import InterpolationPipeline
from aid_tpu_torch.pipelines.sdxl import InterpolationXLPipeline
from aid_tpu_torch.schedulers.ddim import DDIMScheduler
from aid_tpu_torch.schedulers.euler import EulerDiscreteScheduler

__all__ = [
    "ops", "models", "schedulers", "pipelines", "prior", "metrics", "parallel",
    "AidContext", "AidMode", "AttnMode", "DDIMScheduler", "EulerDiscreteScheduler", "InterpolationPipeline",
    "InterpolationXLPipeline", "SD15_UNET", "SDXL_UNET", "TINY_SDXL_UNET", "TINY_UNET", "UNet2DCondition",
    "UNetConfig", "denoise_sequence", "generate_beta_schedule",
]

# ops, models, schedulers and pipelines are imported above; the subpackages
# the package's own imports do not reach load when first named
_LAZY = ("prior", "metrics", "parallel")


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
