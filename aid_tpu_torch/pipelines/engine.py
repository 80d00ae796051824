"""The denoising engine: warmup-split AID with sequential classifier-free guidance.

Counterpart of ``aid_tpu.pipelines.engine.denoise_sequence`` (engine.py:32-228).
PyTorch runs eagerly, so the JAX package's two ``fori_loop`` phases become
one Python loop with a static warmup split: steps ``[0, warmup_steps)`` run
the ``early`` AID mode, the rest the ``late`` one. CFG matches the
reference: a conditional UNet pass with AID active, then an unconditional
pass with AID off (vanilla attention in attn1 and attn2).

``decode_latents`` and ``to_uint8`` are the counterparts of engine.py:319-348
and 422-426: an f32 VAE decode, optionally one frame at a time, with the
latents mean/std denormalisation.

Not yet ported: ``cfg_mode="batched"``, ``loop_mode="fused"`` (force-vanilla
endpoint skipping), ``denoise_steps`` / ``denoise_range``, IP-Adapter embeds
and ``tiled_decode``.
"""

from __future__ import annotations

from typing import Optional

import torch

from aid_tpu_torch.models.layers import AidContext, AidMode
from aid_tpu_torch.ops.attention import AttnMode


def rescale_noise_cfg(noise_cfg: torch.Tensor, noise_pred_text: torch.Tensor, guidance_rescale: float) -> torch.Tensor:
    """Rescale per 'Common Diffusion Noise Schedules are Flawed' §3.4."""
    dims = tuple(range(1, noise_pred_text.dim()))
    std_text = noise_pred_text.std(dim=dims, keepdim=True, correction=0)
    std_cfg = noise_cfg.std(dim=dims, keepdim=True, correction=0)
    rescaled = noise_cfg * (std_text / std_cfg)
    return guidance_rescale * rescaled + (1.0 - guidance_rescale) * noise_cfg


def _make_aid(mode: AidMode, coef: torch.Tensor) -> Optional[AidContext]:
    return None if mode.text == AttnMode.SELF else AidContext(coef=coef, mode=mode)


@torch.no_grad()
def denoise_sequence(
    unet,
    scheduler,
    latents: torch.Tensor,  # (B, C, h, w) NCHW
    embs: torch.Tensor,  # (B, S, D) conditional text embeds
    uncond_embs: torch.Tensor,  # (B, S, D)
    coef: torch.Tensor,  # (B,) per-frame interpolation coefficients
    sched_state,
    guidance_scale: float,
    *,
    early: AidMode,
    late: AidMode,
    num_steps: int,
    warmup_steps: int,
    guidance_rescale: float = 0.0,
    added_cond: Optional[dict] = None,  # SDXL cond dict (pooled text_embeds, time_ids)
    added_cond_uncond: Optional[dict] = None,  # SDXL uncond dict; defaults to added_cond
) -> torch.Tensor:
    """Run the full warmup-split CFG denoise loop; returns the final latents.

    The caller's ``latents`` are never written: the loop starts from a copy
    (the JAX function donates its buffer instead).
    """
    if early.cfg_split or late.cfg_split:
        raise NotImplementedError("batched CFG (cfg_split) is not yet ported to the engine")
    if added_cond is not None and added_cond_uncond is None:
        added_cond_uncond = added_cond
    uncond_mode = AidMode.vanilla()
    early_end = min(max(warmup_steps, 0), num_steps)

    latents = latents.clone()
    for i in range(num_steps):
        mode = early if i < early_end else late
        t = sched_state.timesteps[i]
        latent_in = scheduler.scale_model_input(sched_state, latents, i)
        noise_text = unet(latent_in, t, embs, _make_aid(mode, coef), added_cond)
        noise_uncond = unet(latent_in, t, uncond_embs, _make_aid(uncond_mode, coef), added_cond_uncond)
        # f32 guidance, as the JAX package promotes it against its f32 scale
        noise_uncond = noise_uncond.float()
        noise = noise_uncond + guidance_scale * (noise_text.float() - noise_uncond)
        if guidance_rescale > 0.0:
            noise = rescale_noise_cfg(noise, noise_text.float(), guidance_rescale)
        latents, sched_state = scheduler.step(sched_state, noise, i, latents)
    return latents


@torch.no_grad()
def decode_latents(vae, latents: torch.Tensor, scaling_factor: float, latents_mean=None, latents_std=None,
                   per_frame: bool = False) -> torch.Tensor:
    """VAE decode -> f32 images in [0, 1], NHWC (the JAX package's image layout).

    latents: (B, C, h, w). The decode runs in f32 whatever the latents'
    dtype. ``per_frame`` decodes one frame at a time to cap peak memory.
    ``latents_mean/std`` (per channel) apply the playground-style
    denormalisation ``z * std / scaling_factor + mean``; otherwise
    ``z / scaling_factor``.
    """
    z = latents.float()
    if latents_mean is not None:
        mean = torch.as_tensor(latents_mean, dtype=torch.float32, device=z.device).reshape(1, -1, 1, 1)
        std = torch.as_tensor(latents_std, dtype=torch.float32, device=z.device).reshape(1, -1, 1, 1)
        z = z * std / scaling_factor + mean
    else:
        z = z / scaling_factor
    if per_frame:
        image = torch.cat([vae.decode(z[i:i + 1]) for i in range(z.shape[0])])
    else:
        image = vae.decode(z)
    return (image.float() / 2.0 + 0.5).clamp(0.0, 1.0).permute(0, 2, 3, 1)


def to_uint8(images: torch.Tensor):
    """[0, 1] float NHWC -> host uint8 numpy (N, H, W, 3)."""
    return torch.round(images * 255.0).to(torch.uint8).cpu().numpy()
