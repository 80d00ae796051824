"""Model configurations, UNet building blocks, UNet2DCondition and parameter conversion.

Exports what ``aid_tpu.models`` exports, under the same names.
"""

from aid_tpu_torch.models import configs
from aid_tpu_torch.models.clip import CLIPTextModel, CLIPVisionModel
from aid_tpu_torch.models.configs import CLIPTextConfig, CLIPVisionConfig, UNetConfig, VAEConfig
from aid_tpu_torch.models.layers import AidContext, AidMode
from aid_tpu_torch.models.unet import UNet2DCondition
from aid_tpu_torch.models.vae import AutoencoderKL

__all__ = [
    "configs",
    "UNetConfig",
    "VAEConfig",
    "CLIPTextConfig",
    "CLIPVisionConfig",
    "AidContext",
    "AidMode",
    "UNet2DCondition",
    "AutoencoderKL",
    "CLIPTextModel",
    "CLIPVisionModel",
]
