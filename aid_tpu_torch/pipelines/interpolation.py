"""The interpolation pipeline's shared core (the part ``interpolate`` needs).

Counterpart of ``aid_tpu.pipelines.interpolation.InterpolationPipeline``:
``generate_latent``, ``_aid_modes``, ``_run_sequence`` (interpolation.py:
301-403, without chunking or callbacks) and ``_decode``. Modules are the
port's ``nn.Module``s with their weights inside, so there are no separate
parameter trees. Latents are NCHW; decoded images are NHWC uint8 numpy, as
the JAX package returns them.

Not yet ported: the SD1.x entry points (``interpolate``,
``interpolate_single``, ``interpolate_save_gpu``, ``denoising_interpolate``),
chunked generation with ``interrupt`` and callbacks, the safety checker, the
IP-Adapter attachments, VAE tiling and the bf16 decode option.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from aid_tpu_torch.models.layers import AidMode
from aid_tpu_torch.pipelines import engine


@dataclasses.dataclass
class InterpolationPipeline:
    """``tokenizer`` is any callable ``prompt -> (1, max_len) int ids``;
    ``scheduler`` is the port's Euler (the only scheduler ported yet)."""

    unet: Any
    vae: Any
    text_encoder: Any
    tokenizer: Any
    scheduler: Any
    vae_scale_factor: int = 8
    guidance_scale: float = 7.5

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    @property
    def latent_channels(self) -> int:
        return self.unet.config.in_channels

    def _latent_hw(self, height: Optional[int], width: Optional[int]):
        size = self.unet.config.sample_size
        h = (height // self.vae_scale_factor) if height else size
        w = (width // self.vae_scale_factor) if width else size
        return h, w

    def generate_latent(self, generator: torch.Generator, height: Optional[int] = None,
                        width: Optional[int] = None) -> torch.Tensor:
        """Random (1, C, h, w) f32 latent from ``generator``, on its device.
        (torch and JAX draw different numbers from one seed; parity tests
        hand both pipelines the same latents.)"""
        h, w = self._latent_hw(height, width)
        return torch.randn((1, self.latent_channels, h, w), generator=generator, device=generator.device,
                           dtype=torch.float32)

    def _ids(self, tokenizer, text: str) -> torch.Tensor:
        return torch.as_tensor(tokenizer(text), device=self.device)

    def _aid_modes(self, early: str, late: str):
        return AidMode.from_name(early), AidMode.from_name(late)

    def _run_sequence(
        self,
        latents: torch.Tensor,  # (B, C, h, w)
        embs: torch.Tensor,
        uncond_embs: torch.Tensor,
        coef: torch.Tensor,
        num_inference_steps: int,
        warmup_ratio: float,
        early: str,
        late: str,
        guidance_scale: Optional[float],
        guidance_rescale: float = 0.0,
        added_cond: Optional[dict] = None,
        added_cond_uncond: Optional[dict] = None,
        output_type: str = "np",
        per_frame_decode: bool = False,
        num_run_steps: Optional[int] = None,  # denoising_end truncation
    ):
        if output_type not in ("np", "latent"):
            raise ValueError(f"output_type must be 'np' or 'latent', got {output_type!r}")
        if guidance_scale is None:
            guidance_scale = self.guidance_scale
        state = self.scheduler.init(num_inference_steps, device=latents.device)
        latents = latents * state.init_noise_sigma
        if num_run_steps is None:
            num_run_steps = int(state.timesteps.shape[0])
        # early mode for steps i < warmup_steps, 0-based (interpolation.py:335-342)
        warmup_steps = min(int(num_inference_steps * warmup_ratio), num_run_steps)
        early_mode, late_mode = self._aid_modes(early, late)
        final = engine.denoise_sequence(
            self.unet, self.scheduler, latents, embs, uncond_embs, coef, state, guidance_scale,
            early=early_mode, late=late_mode, num_steps=num_run_steps, warmup_steps=warmup_steps,
            guidance_rescale=guidance_rescale, added_cond=added_cond, added_cond_uncond=added_cond_uncond)
        if output_type == "latent":
            return final
        return self._decode(final, per_frame=per_frame_decode)

    def _decode(self, latents: torch.Tensor, per_frame: bool = False):
        cfg = self.vae.config
        images = engine.decode_latents(self.vae, latents, cfg.scaling_factor, latents_mean=cfg.latents_mean,
                                       latents_std=cfg.latents_std, per_frame=per_frame)
        return engine.to_uint8(images)
