"""The denoising engine: warmup-split AID with classifier-free guidance.

Counterpart of ``aid_tpu.pipelines.engine``'s ``denoise_sequence``,
``denoise_steps`` and ``denoise_range`` (engine.py:32-318). PyTorch runs
eagerly, so the JAX package's ``fori_loop`` phases become one Python loop
over a step range ``[start, end)`` with a warmup split: steps
``i < warmup_steps`` run the ``early`` AID mode, the rest the ``late`` one.

``cfg_mode="sequential"`` matches the reference: a conditional UNet pass
with AID active, then an unconditional pass with AID off (vanilla attention
in attn1 and attn2). ``cfg_mode="batched"`` runs ONE 2N-row pass a step:
the cond rows take their endpoints from cond rows 0 / N-1, the uncond rows
their own K/V as both endpoints, which reduces every AID mode exactly to
vanilla attention (``AidMode.cfg_split``). ``loop_mode="fused"`` (with a
fused early mode and a vanilla late mode) runs the early mode on every step
with ``force_vanilla = i >= warmup_steps``: its late steps drop every
endpoint segment, which is vanilla attention again. The JAX package uses it
to trace one loop instead of two; eagerly it only changes which kernel
calls a late step makes. ``"auto"`` is ``"split"``.

``denoise_steps`` returns the scheduler state too, so chunks of one schedule
compose (the pipelines' interruptible path); ``denoise_range`` is the
vanilla-attention loop of the denoising-interpolation baseline and plain
text-to-image.

IP-Adapter (engine.py:60-143): ``ip_embeds`` are the cond pass's projected
image tokens (B, T, cross_attention_dim), ``ip_uncond_embeds`` the uncond
pass's, ``ip_scale`` the adapter's scale. The uncond pass keeps the IP
branch in ``"own"`` mode (coefficient-scaled as the early mode is) on the
negative tokens; batched CFG stacks cond and uncond tokens, the uncond ones
zeros where none are given (zero tokens through the bias-free projections
add exactly nothing, as the sequential pass without them).

``frames`` (a ``models.layers.FrameShard``) runs the steps on one rank's
slice of a frame-sharded sequence: every AID forward's context carries it,
so the interpolating attention reads the global endpoints and skip rows.
``parallel.sharded_denoise_sequence`` sets it; batched CFG is refused under
it, as the JAX package asserts (layers.py:430-431).

``decode_latents``, ``tiled_decode`` and ``to_uint8`` are the counterparts
of engine.py:319-426: the VAE decode in the VAE's parameter dtype from f32
latents, optionally one frame at a time or in overlapping spatial tiles,
with the latents mean/std denormalisation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from aid_tpu_torch.models.layers import AidContext, AidMode, FrameShard
from aid_tpu_torch.ops.attention import AttnMode


def rescale_noise_cfg(noise_cfg: torch.Tensor, noise_pred_text: torch.Tensor, guidance_rescale: float) -> torch.Tensor:
    """Rescale per 'Common Diffusion Noise Schedules are Flawed' §3.4."""
    dims = tuple(range(1, noise_pred_text.dim()))
    std_text = noise_pred_text.std(dim=dims, keepdim=True, correction=0)
    std_cfg = noise_cfg.std(dim=dims, keepdim=True, correction=0)
    rescaled = noise_cfg * (std_text / std_cfg)
    return guidance_rescale * rescaled + (1.0 - guidance_rescale) * noise_cfg


def _make_aid(mode: AidMode, coef: torch.Tensor, force_vanilla=None, ip_states=None,
              ip_scale: float = 1.0, frames: Optional[FrameShard] = None) -> Optional[AidContext]:
    if mode.text == AttnMode.SELF and mode.ip is None:
        return None
    return AidContext(coef=coef, mode=mode, force_vanilla=force_vanilla, ip_hidden_states=ip_states,
                      ip_scale=ip_scale, frames=frames)


CFG_MODES = ("sequential", "batched")
LOOP_MODES = ("auto", "split", "fused")


@torch.no_grad()
def denoise_steps(
    unet,
    scheduler,
    latents: torch.Tensor,  # (B, C, h, w) NCHW
    embs: torch.Tensor,  # (B, S, D) conditional text embeds
    uncond_embs: torch.Tensor,  # (B, S, D)
    coef: Optional[torch.Tensor],  # (B,) per-frame interpolation coefficients
    sched_state,
    guidance_scale: float,
    *,
    early: AidMode,
    late: AidMode,
    start: int,
    end: int,
    warmup_steps: int,
    guidance_rescale: float = 0.0,
    added_cond: Optional[dict] = None,  # SDXL cond dict (pooled text_embeds, time_ids)
    added_cond_uncond: Optional[dict] = None,  # SDXL uncond dict; defaults to added_cond
    eta: float = 0.0,
    generator: Optional[torch.Generator] = None,  # the step noise when eta > 0
    cfg_mode: str = "sequential",  # "sequential" (two passes a step) | "batched" (one 2N-row pass)
    loop_mode: str = "auto",  # "auto" (= "split") | "split" | "fused"
    ip_embeds: Optional[torch.Tensor] = None,  # (B, T, D) projected cond IP tokens
    ip_uncond_embeds: Optional[torch.Tensor] = None,  # (B, T, D) the uncond pass's
    ip_scale: float = 1.0,
    frames: Optional[FrameShard] = None,  # this rank's slice of a frame-sharded sequence
):
    """Warmup-split CFG steps ``[start, end)`` of a schedule; returns
    ``(latents, sched_state)`` so chunks compose. The caller's ``latents``
    are never written in place. ``cfg_mode``, ``loop_mode``, the IP
    arguments and ``frames`` as in the module docstring (engine.py:60-169)."""
    if cfg_mode not in CFG_MODES:
        raise ValueError(f"cfg_mode must be one of {CFG_MODES}, got {cfg_mode!r}")
    if frames is not None and cfg_mode == "batched":
        raise ValueError("batched CFG is not supported under frame sharding")
    if loop_mode not in LOOP_MODES:
        raise ValueError(f"loop_mode must be one of {LOOP_MODES}, got {loop_mode!r}")
    if added_cond is not None and added_cond_uncond is None:
        added_cond_uncond = added_cond
    # the uncond pass: AID off, the IP branch (if any) on its own tokens (engine.py:81-91)
    uncond_mode = AidMode(text=AttnMode.SELF, ip=None if early.ip is None else "own",
                          ip_coef_scaled=early.ip_coef_scaled)

    if cfg_mode == "batched":
        N = latents.shape[0]
        embs_all = torch.cat([embs, uncond_embs])
        coef_all = None if coef is None else torch.cat([coef, coef])
        ip_all = None
        if ip_embeds is not None:
            ip_all = torch.cat([ip_embeds, torch.zeros_like(ip_embeds) if ip_uncond_embeds is None
                                else ip_uncond_embeds])
        added_all = None if added_cond is None else {
            k: torch.cat([v, added_cond_uncond[k]]) for k, v in added_cond.items()}

    def unet_noise(latent_in, t, mode: AidMode, force=None):
        if cfg_mode == "batched":
            aid = _make_aid(dataclasses.replace(mode, cfg_split=N), coef_all, force, ip_all, ip_scale)
            out = unet(torch.cat([latent_in, latent_in]), t, embs_all, aid, added_all)
            return out[:N], out[N:]
        noise_text = unet(latent_in, t, embs, _make_aid(mode, coef, force, ip_embeds, ip_scale, frames), added_cond)
        noise_uncond = unet(latent_in, t, uncond_embs,
                            _make_aid(uncond_mode, coef, None, ip_uncond_embeds, ip_scale, frames), added_cond_uncond)
        return noise_text, noise_uncond

    # one mode on every step, its endpoint segments dropped from the warmup
    # boundary on (engine.py:160-169)
    fused = loop_mode == "fused" and early.text.is_fused and late.text == AttnMode.SELF
    for i in range(start, end):
        t = sched_state.timesteps[i]
        latent_in = scheduler.scale_model_input(sched_state, latents, i)
        if fused:
            noise_text, noise_uncond = unet_noise(latent_in, t, early, force=i >= warmup_steps)
        else:
            noise_text, noise_uncond = unet_noise(latent_in, t, early if i < warmup_steps else late)
        # f32 guidance, as the JAX package promotes it against its f32 scale
        noise_uncond = noise_uncond.float()
        noise = noise_uncond + guidance_scale * (noise_text.float() - noise_uncond)
        if guidance_rescale > 0.0:
            noise = rescale_noise_cfg(noise, noise_text.float(), guidance_rescale)
        # every scheduler takes the step noise's arguments, as in the JAX
        # engine (engine.py:120-130); only DDIM with eta > 0 uses them
        latents, sched_state = scheduler.step(sched_state, noise, i, latents, eta=eta, generator=generator)
    return latents, sched_state


def denoise_sequence(unet, scheduler, latents, embs, uncond_embs, coef, sched_state, guidance_scale, *,
                     early: AidMode, late: AidMode, num_steps: int, warmup_steps: int, **kwargs) -> torch.Tensor:
    """The whole warmup-split CFG loop, steps ``[0, num_steps)``; returns
    the final latents (see :func:`denoise_steps`)."""
    latents, _ = denoise_steps(unet, scheduler, latents, embs, uncond_embs, coef, sched_state, guidance_scale,
                               early=early, late=late, start=0, end=num_steps, warmup_steps=warmup_steps, **kwargs)
    return latents


def denoise_range(unet, scheduler, latents, embs, uncond_embs, sched_state, guidance_scale, *, start: int,
                  end: int, eta: float = 0.0, generator: Optional[torch.Generator] = None, added_cond=None,
                  added_cond_uncond=None, ip_embeds=None, ip_uncond_embeds=None, ip_scale: float = 1.0):
    """Vanilla-attention CFG steps ``[start, end)``; returns
    ``(latents, sched_state)``. The composition primitive of the
    denoising-interpolation baseline and of ``__call__``. With
    ``ip_embeds`` each frame also attends its own image tokens (the
    vanilla IP-Adapter)."""
    vanilla = AidMode.vanilla(has_ip=ip_embeds is not None)
    return denoise_steps(unet, scheduler, latents, embs, uncond_embs, None, sched_state, guidance_scale,
                         early=vanilla, late=vanilla, start=start, end=end, warmup_steps=0, eta=eta,
                         generator=generator, added_cond=added_cond, added_cond_uncond=added_cond_uncond,
                         ip_embeds=ip_embeds, ip_uncond_embeds=ip_uncond_embeds, ip_scale=ip_scale)


@torch.no_grad()
def decode_latents(vae, latents: torch.Tensor, scaling_factor: float, latents_mean=None, latents_std=None,
                   per_frame: bool = False, tile_latent_size: Optional[int] = None) -> torch.Tensor:
    """VAE decode -> f32 images in [0, 1], NHWC (the JAX package's image layout).

    latents: (B, C, h, w). The denormalisation runs in f32 whatever the
    latents' dtype: ``latents_mean/std`` (per channel) apply the
    playground-style ``z * std / scaling_factor + mean``; otherwise
    ``z / scaling_factor``. The decode then runs in the VAE's parameter
    dtype (a bf16 VAE decodes the rounded f32 latents in bf16, as flax
    computes a ``dtype=bfloat16`` module). ``per_frame`` decodes one frame
    at a time to cap peak memory; ``tile_latent_size`` decodes through
    :func:`tiled_decode` where the latent is larger than one tile.
    """
    z = latents.float()
    if latents_mean is not None:
        mean = torch.as_tensor(latents_mean, dtype=torch.float32, device=z.device).reshape(1, -1, 1, 1)
        std = torch.as_tensor(latents_std, dtype=torch.float32, device=z.device).reshape(1, -1, 1, 1)
        z = z * std / scaling_factor + mean
    else:
        z = z / scaling_factor
    z = z.to(vae.dtype)
    if tile_latent_size is not None and max(z.shape[2:]) > tile_latent_size:
        def dec(zi):
            return tiled_decode(vae, zi, tile_latent_size=tile_latent_size)
    else:
        dec = vae.decode
    image = torch.cat([dec(z[i:i + 1]) for i in range(z.shape[0])]) if per_frame else dec(z)
    return (image.float() / 2.0 + 0.5).clamp(0.0, 1.0).permute(0, 2, 3, 1)


@torch.no_grad()
def tiled_decode(vae, z: torch.Tensor, tile_latent_size: int = 64, tile_overlap_factor: float = 0.25) -> torch.Tensor:
    """Spatially tiled VAE decode with overlap blending (engine.py:355-419).

    ``z`` (B, C, h, w), already scaled. The latent is edge-padded so every
    tile has the full (tl, tl) shape; tiles start every ``stride = max(1,
    int(tl * (1 - overlap)))`` latent pixels and decode one at a time. The
    blend extent and each tile's contribution derive from that stride, so
    the assembly stays seam-aligned for every tile size: each tile's top
    edge is blended with the tile above, then its left edge with the tile to
    its left (linear ramps, both neighbours as decoded), it is cropped to
    the stride, and the whole to ``h * f x w * f``. Returns the raw decoder
    output (B, out_channels, h * f, w * f) in the VAE's dtype.
    """
    B, C, h, w = z.shape
    f = 2 ** (len(vae.config.block_out_channels) - 1)
    tl = tile_latent_size
    stride = max(1, int(tl * (1.0 - tile_overlap_factor)))  # latent stride
    ts = tl * f  # decoded tile size (px)
    limit = stride * f  # each tile's contribution (px)
    blend = ts - limit  # blend extent (px)

    n_rows = max(1, -(-h // stride))  # ceil; tile starts at i * stride
    n_cols = max(1, -(-w // stride))
    pad_h = (n_rows - 1) * stride + tl - h
    pad_w = (n_cols - 1) * stride + tl - w
    zp = F.pad(z, (0, pad_w, 0, pad_h), mode="replicate")
    raw = [[vae.decode(zp[:, :, i * stride:i * stride + tl, j * stride:j * stride + tl]) for j in range(n_cols)]
           for i in range(n_rows)]

    ramp = torch.arange(blend, dtype=raw[0][0].dtype, device=z.device) / max(blend, 1)
    ramp_v, ramp_h = ramp.reshape(1, 1, blend, 1), ramp.reshape(1, 1, 1, blend)
    out_rows = []
    for i in range(n_rows):
        row = []
        for j in range(n_cols):
            tile = raw[i][j]
            if blend > 0 and (i > 0 or j > 0):
                tile = tile.clone()
            if i > 0 and blend > 0:  # top edge with the tile above
                above = raw[i - 1][j][:, :, ts - blend:ts]
                tile[:, :, :blend] = above * (1.0 - ramp_v) + tile[:, :, :blend] * ramp_v
            if j > 0 and blend > 0:  # left edge with the tile to the left
                left = raw[i][j - 1][:, :, :, ts - blend:ts]
                tile[:, :, :, :blend] = left * (1.0 - ramp_h) + tile[:, :, :, :blend] * ramp_h
            row.append(tile[:, :, :limit, :limit])
        out_rows.append(torch.cat(row, dim=3))
    return torch.cat(out_rows, dim=2)[:, :, :h * f, :w * f]


def to_uint8(images: torch.Tensor):
    """[0, 1] float NHWC -> host uint8 numpy (N, H, W, 3)."""
    return torch.round(images * 255.0).to(torch.uint8).cpu().numpy()
