"""Model configurations for the supported model zoo.

The same frozen dataclasses and presets as ``aid_tpu.models.configs``,
copied so that the PyTorch port never imports the JAX package. A preset
here and its namesake there describe the same architecture, which is what
the parity tests rely on.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """UNet2DCondition architecture config (diffusers-compatible semantics)."""

    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    # Per-level: True = levels with cross-attention transformers.
    cross_attention_levels: Tuple[bool, ...] = (True, True, True, False)
    layers_per_block: int = 2
    # Transformer depth per level (SDXL uses (1, 2, 10)).
    transformer_layers_per_block: Tuple[int, ...] = (1, 1, 1, 1)
    # Number of attention heads per level. SD1.x/2.x use a constant head
    # count (attention_head_dim=8 in diffusers legacy naming means 8 heads);
    # SDXL uses (5, 10, 20) with head_dim 64.
    num_attention_heads: Tuple[int, ...] = (8, 8, 8, 8)
    cross_attention_dim: int = 768
    use_linear_projection: bool = False
    norm_num_groups: int = 32
    freq_shift: int = 0
    flip_sin_to_cos: bool = True
    # SDXL extra conditioning: pooled text embed + micro-conditioning time_ids.
    addition_embed_type: Optional[str] = None  # None | "text_time"
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: Optional[int] = None  # SDXL: 2816
    # IP-Adapter: number of image-prompt tokens (0 = no IP cross-attn params).
    ip_num_tokens: int = 0
    ip_hidden_dim: Optional[int] = None  # encoder_hid dim of image embeds

    @property
    def num_levels(self) -> int:
        return len(self.block_out_channels)

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKL config."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    latents_mean: Optional[Tuple[float, ...]] = None
    latents_std: Optional[Tuple[float, ...]] = None
    force_upcast: bool = True


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"  # SDXL text_encoder_2 uses "gelu"
    projection_dim: Optional[int] = None  # set for CLIPTextModelWithProjection
    eos_token_id: int = 49407


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 32
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    projection_dim: int = 512
    hidden_act: str = "quick_gelu"


# ---------------------------------------------------------------------------
# Model zoo presets
# ---------------------------------------------------------------------------

SD15_UNET = UNetConfig()

SD21_UNET = UNetConfig(
    sample_size=96,
    cross_attention_dim=1024,
    use_linear_projection=True,
    # SD2.1 attention_head_dim = [5, 10, 20, 20] -> head_dim 64
    num_attention_heads=(5, 10, 20, 20),
)

SDXL_UNET = UNetConfig(
    sample_size=128,
    block_out_channels=(320, 640, 1280),
    cross_attention_levels=(False, True, True),
    transformer_layers_per_block=(0, 2, 10),
    num_attention_heads=(5, 10, 20),
    cross_attention_dim=2048,
    use_linear_projection=True,
    addition_embed_type="text_time",
    projection_class_embeddings_input_dim=2816,
)

SD_VAE = VAEConfig()
SDXL_VAE = VAEConfig(scaling_factor=0.13025)
PLAYGROUND_V25_VAE = VAEConfig(
    scaling_factor=0.5,
    latents_mean=(-1.6574, 1.886, -1.383, 2.5155),
    latents_std=(8.4927, 5.9022, 6.5498, 5.2299),
)

CLIP_VIT_L_TEXT = CLIPTextConfig()  # SD1.x text encoder
OPENCLIP_VIT_H_TEXT = CLIPTextConfig(
    hidden_size=1024, intermediate_size=4096, num_hidden_layers=23,
    num_attention_heads=16, hidden_act="gelu",
)  # SD2.1
SDXL_TEXT_ENCODER_2 = CLIPTextConfig(
    hidden_size=1280, intermediate_size=5120, num_hidden_layers=32,
    num_attention_heads=20, hidden_act="gelu", projection_dim=1280,
)

CLIP_VIT_H_VISION = CLIPVisionConfig(
    image_size=224, patch_size=14, hidden_size=1280, intermediate_size=5120,
    num_hidden_layers=32, num_attention_heads=16, projection_dim=1024,
)  # IP-Adapter image encoder

# Tiny configs for CPU-runnable tests.
TINY_UNET = UNetConfig(
    sample_size=8,
    block_out_channels=(32, 64),
    cross_attention_levels=(True, False),
    layers_per_block=1,
    transformer_layers_per_block=(1, 1),
    num_attention_heads=(2, 2),
    cross_attention_dim=32,
    norm_num_groups=8,
)
TINY_UNET_IP = dataclasses.replace(TINY_UNET, ip_num_tokens=4, ip_hidden_dim=16)
TINY_SDXL_UNET = UNetConfig(
    sample_size=8,
    block_out_channels=(32, 64),
    cross_attention_levels=(False, True),
    layers_per_block=1,
    transformer_layers_per_block=(0, 2),
    num_attention_heads=(2, 2),
    cross_attention_dim=32,
    norm_num_groups=8,
    addition_embed_type="text_time",
    addition_time_embed_dim=16,
    projection_class_embeddings_input_dim=16 * 6 + 24,  # 6 time_ids + pooled 24
)
TINY_VAE = VAEConfig(
    block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=4,
)
TINY_CLIP_TEXT = CLIPTextConfig(
    vocab_size=1000, hidden_size=32, intermediate_size=64,
    num_hidden_layers=2, num_attention_heads=2, max_position_embeddings=77,
)
TINY_CLIP_VISION = CLIPVisionConfig(
    image_size=32, patch_size=8, hidden_size=32, intermediate_size=64,
    num_hidden_layers=2, num_attention_heads=2, projection_dim=16,
)
