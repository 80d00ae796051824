"""SDXL interpolation pipeline: two prompts in, uint8 frames out.

Counterpart of ``aid_tpu.pipelines.sdxl.InterpolationXLPipeline``:
``interpolate`` (sdxl.py:156-238), ``interpolate_single`` (sdxl.py:240-380)
and ``_cond_kwargs`` (sdxl.py:138-154), and what they need:
``encode_prompt`` (the two text encoders' hidden states concatenated, pooled
embeds from encoder 2), the micro-conditioning ``time_ids``,
``denoising_end`` and the frame-by-frame VAE decode. ``_cond_kwargs``
gives the inherited vanilla entry points (``__call__``,
``denoising_interpolate``) the added conditioning SDXL's UNet needs, and
``interpolate_save_gpu`` runs through this class's ``interpolate`` and
``interpolate_single``. Batched CFG, VAE tiling and the bf16 decode are the
base class's. Latents are slerped channels-last, as in the base module.

``watermarker`` (``utils.watermark.InvisibleWatermark``) marks every
decoded frame when set (sdxl.py:40-53); None, the default, leaves them.

``interpolate_single`` takes image embeds as the base class's does
(sdxl.py:352-372), with an IP-Adapter loaded through the inherited
``load_aid_ip_adapter``.

``interpolate_single`` takes pre-computed embeddings in place of the two
text encoders (sdxl.py:263-335): ``prompt_embeds_start`` / ``_end``,
``pooled_prompt_embeds_start`` / ``_end``, ``negative_prompt_embeds`` and
``negative_pooled_prompt_embeds`` together, and the guide's
``guide_prompt_embeds`` (its pooled embeds optional: without them the
middle frame's pooled embeds are interpolated) with or without them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from aid_tpu_torch.ops.interp import generate_beta_schedule, linear_interpolation
from aid_tpu_torch.pipelines.interpolation import (
    InterpolationPipeline,
    _check_ts,
    slerp_latent,
    slerp_latents,
)


@dataclasses.dataclass
class InterpolationXLPipeline(InterpolationPipeline):
    """``text_encoder``/``tokenizer`` are CLIP ViT-L; ``text_encoder_2``/
    ``tokenizer_2`` are OpenCLIP bigG with its projection."""

    text_encoder_2: Any = None
    tokenizer_2: Any = None
    guidance_scale: float = 5.0
    default_size: int = 1024
    # an InvisibleWatermark applied to every decoded frame; None = off
    watermarker: Any = None

    def _decode(self, latents: torch.Tensor, per_frame: bool = False):
        images = super()._decode(latents, per_frame=per_frame)
        if self.watermarker is not None:
            images = self.watermarker.apply(images)
        return images

    def _effective_steps(self, num_inference_steps: int, denoising_end: Optional[float]) -> int:
        """Steps to run before ``denoising_end`` (sdxl.py:55-66)."""
        if denoising_end is None:
            return num_inference_steps
        if not (0.0 < denoising_end < 1.0):
            raise ValueError(f"denoising_end must be in (0, 1), got {denoising_end}")
        # the EDM solver has no train-timestep config: 1000, as in sdxl.py:63
        T = self.scheduler.config.num_train_timesteps if hasattr(self.scheduler, "config") else 1000
        cutoff = round(T - denoising_end * T)
        state = self.scheduler.init(num_inference_steps)
        return int(np.sum(state.timesteps.cpu().numpy() >= cutoff))

    @torch.no_grad()
    def encode_prompt(self, prompt: str, negative_prompt: str = "", clip_skip: int = 0):
        """(emb, neg, pooled, neg_pooled): (1, S, D1 + D2) cond / uncond
        embeds, each encoder's hidden_states[-(clip_skip + 2)] concatenated,
        and encoder 2's pooled embeds for both (sdxl.py:68-85)."""

        def enc(text):
            _, _, hs1 = self.text_encoder(self._ids(self.tokenizer, text))
            _, pooled2, hs2 = self.text_encoder_2(self._ids(self.tokenizer_2, text))
            layer = -(clip_skip + 2)
            return torch.cat([hs1[layer], hs2[layer]], dim=-1), pooled2

        emb, pooled = enc(prompt)
        neg, neg_pooled = enc(negative_prompt)
        return emb, neg, pooled, neg_pooled

    def _time_ids(self, batch: int, height: int, width: int, original_size: Optional[tuple] = None,
                  crops_coords_top_left: tuple = (0, 0), target_size: Optional[tuple] = None) -> torch.Tensor:
        """original_size + crops_coords_top_left + target_size, per frame
        (sdxl.py:87-104); sizes default to the output resolution."""
        original_size = tuple(original_size or (height, width))
        target_size = tuple(target_size or (height, width))
        ids = torch.tensor([*original_size, *crops_coords_top_left, *target_size], dtype=torch.float32,
                           device=self.device)
        return ids[None].expand(batch, 6)

    def _time_ids_pair(self, batch: int, height: int, width: int, original_size=None, crops_coords_top_left=(0, 0),
                       target_size=None, negative_original_size=None, negative_crops_coords_top_left=(0, 0),
                       negative_target_size=None) -> tuple:
        """(cond, uncond) time_ids. The uncond ids differ only when both
        ``negative_original_size`` and ``negative_target_size`` are given
        (sdxl.py:106-136)."""
        time_ids = self._time_ids(batch, height, width, original_size, crops_coords_top_left, target_size)
        if negative_original_size is None or negative_target_size is None:
            return time_ids, time_ids
        return time_ids, self._time_ids(batch, height, width, negative_original_size,
                                        negative_crops_coords_top_left, negative_target_size)

    def _cond_kwargs(self, prompt: str, negative_prompt: str, batch: int, latent_hw) -> tuple:
        """The vanilla entry points' conditioning: embeds, and the pooled
        embeds + time_ids of the latent's pixel size (sdxl.py:138-154)."""
        emb, uncond, pooled, neg_pooled = (x.repeat_interleave(batch, dim=0)
                                           for x in self.encode_prompt(prompt, negative_prompt))
        f = 2 ** (len(self.vae.config.block_out_channels) - 1)
        time_ids = self._time_ids(batch, latent_hw[0] * f, latent_hw[1] * f)
        return emb, uncond, {"added_cond": {"text_embeds": pooled, "time_ids": time_ids},
                             "added_cond_uncond": {"text_embeds": neg_pooled, "time_ids": time_ids}}

    def interpolate(
        self,
        latent_start: torch.Tensor,  # (1, C, h, w)
        latent_end: torch.Tensor,
        prompt_start: str,
        prompt_end: str,
        guide_prompt: Optional[str] = None,
        negative_prompt: str = "",
        size: int = 7,
        num_inference_steps: int = 28,
        warmup_ratio: float = 0.5,
        early: str = "fused_outer",
        late: str = "self",
        alpha: Optional[float] = None,
        beta: Optional[float] = None,
        guidance_scale: Optional[float] = None,
        ts=None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        denoising_end: Optional[float] = None,
        original_size: Optional[tuple] = None,
        crops_coords_top_left: tuple = (0, 0),
        target_size: Optional[tuple] = None,
        negative_original_size: Optional[tuple] = None,
        negative_crops_coords_top_left: tuple = (0, 0),
        negative_target_size: Optional[tuple] = None,
        output_type: str = "np",
        callback_on_chunk_end=None,
        callback_on_step_end=None,
    ):
        """A ``size``-frame sequence from ``prompt_start`` to ``prompt_end``.

        Latents slerp and text / pooled embeds lerp at uniform points (or at
        ``ts``), or every interior frame takes ``guide_prompt`` (PAID); the
        per-frame attention coefficients follow the Beta(alpha, beta)
        schedule (alpha, beta default to ``num_inference_steps``) or ``ts``.
        Returns (size, H, W, 3) uint8 numpy for ``output_type="np"``, the
        final (size, C, h, w) latents for ``"latent"`` or when
        ``denoising_end`` is set.
        """
        if alpha is None:
            alpha = float(num_inference_steps)
        if beta is None:
            beta = float(num_inference_steps)
        height = height or self.default_size
        width = width or self.default_size
        if ts is not None:
            ts = _check_ts(ts)
            size = int(ts.shape[0])

        latents = slerp_latents(latent_start.to(self.device), latent_end.to(self.device), size, ts=ts)
        emb_s, un_s, pooled_s, neg_pooled_s = self.encode_prompt(prompt_start, negative_prompt)
        emb_e, un_e, pooled_e, neg_pooled_e = self.encode_prompt(prompt_end, negative_prompt)
        if guide_prompt is not None:
            emb_g, un_g, pooled_g, neg_pooled_g = self.encode_prompt(guide_prompt, negative_prompt)

            def frames(s, g, e):
                return torch.cat([s] + [g] * (size - 2) + [e], dim=0)

            embs, uncond = frames(emb_s, emb_g, emb_e), frames(un_s, un_g, un_e)
            pooled, neg_pooled = frames(pooled_s, pooled_g, pooled_e), frames(neg_pooled_s, neg_pooled_g, neg_pooled_e)
        else:
            embs = linear_interpolation(emb_s, emb_e, size=size, ts=ts)
            uncond = linear_interpolation(un_s, un_e, size=size, ts=ts)
            pooled = linear_interpolation(pooled_s, pooled_e, size=size, ts=ts)
            neg_pooled = linear_interpolation(neg_pooled_s, neg_pooled_e, size=size, ts=ts)

        coef = ts if ts is not None else generate_beta_schedule(size, alpha, beta, force_endpoints=True)
        coef = torch.as_tensor(coef, dtype=torch.float32, device=self.device)
        time_ids, neg_time_ids = self._time_ids_pair(
            size, height, width, original_size, crops_coords_top_left, target_size, negative_original_size,
            negative_crops_coords_top_left, negative_target_size)
        return self._run_sequence(
            latents, embs, uncond, coef, num_inference_steps, warmup_ratio, early, late, guidance_scale,
            added_cond={"text_embeds": pooled, "time_ids": time_ids},
            added_cond_uncond={"text_embeds": neg_pooled, "time_ids": neg_time_ids},
            output_type="latent" if denoising_end is not None else output_type,
            per_frame_decode=True,
            num_run_steps=self._effective_steps(num_inference_steps, denoising_end),
            callback_on_chunk_end=callback_on_chunk_end, callback_on_step_end=callback_on_step_end)

    def interpolate_single(
        self,
        it: float,
        latent_start: Optional[torch.Tensor] = None,
        latent_end: Optional[torch.Tensor] = None,
        prompt_start: str = "",
        prompt_end: str = "",
        guide_prompt: Optional[str] = None,
        negative_prompt: str = "",
        num_inference_steps: int = 28,
        warmup_ratio: float = 0.5,
        early: str = "fused_outer",
        late: str = "self",
        init: str = "linear",
        guidance_scale: Optional[float] = None,
        guidance_rescale: float = 0.0,
        image_embeds_start: Optional[torch.Tensor] = None,
        image_embeds_end: Optional[torch.Tensor] = None,
        negative_image_embeds: Optional[torch.Tensor] = None,
        prompt_embeds_start: Optional[torch.Tensor] = None,
        prompt_embeds_end: Optional[torch.Tensor] = None,
        pooled_prompt_embeds_start: Optional[torch.Tensor] = None,
        pooled_prompt_embeds_end: Optional[torch.Tensor] = None,
        negative_prompt_embeds: Optional[torch.Tensor] = None,
        negative_pooled_prompt_embeds: Optional[torch.Tensor] = None,
        guide_prompt_embeds: Optional[torch.Tensor] = None,
        guide_pooled_prompt_embeds: Optional[torch.Tensor] = None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        denoising_end: Optional[float] = None,
        original_size: Optional[tuple] = None,
        crops_coords_top_left: tuple = (0, 0),
        target_size: Optional[tuple] = None,
        negative_original_size: Optional[tuple] = None,
        negative_crops_coords_top_left: tuple = (0, 0),
        negative_target_size: Optional[tuple] = None,
        seed: int = 0,
        output_type: str = "np",
        callback_on_chunk_end=None,
        callback_on_step_end=None,
    ):
        """SDXL 3-frame [A, interpolated, B] generation (sdxl.py:240-380):
        as the base class's, with pooled embeds interpolated beside the text
        embeds (a guide prompt brings its own) and the micro-conditioning
        kwargs, whose negatives change only the uncond pass's time_ids.
        Pre-computed embeddings ((1, S, D1 + D2) and pooled (1, P)) stand in
        for the prompts as the module docstring says."""
        if not 0.0 < it < 1.0:
            raise ValueError("t must be between 0 and 1")
        height = height or self.default_size
        width = width or self.default_size
        latent_start = self._seeded_latent(seed) if latent_start is None else latent_start.to(self.device)
        latent_end = self._seeded_latent(seed + 1) if latent_end is None else latent_end.to(self.device)
        latents = torch.cat([latent_start, slerp_latent(latent_start, latent_end, it), latent_end], dim=0)

        if prompt_embeds_start is not None:
            needed = (prompt_embeds_end, pooled_prompt_embeds_start, pooled_prompt_embeds_end, negative_prompt_embeds,
                      negative_pooled_prompt_embeds)
            if any(x is None for x in needed):
                raise ValueError("prompt_embeds_start requires prompt_embeds_end, pooled_prompt_embeds_start/end, "
                                 "negative_prompt_embeds and negative_pooled_prompt_embeds")
            emb_s, emb_e = self._embeds(prompt_embeds_start), self._embeds(prompt_embeds_end)
            pooled_s, pooled_e = self._embeds(pooled_prompt_embeds_start), self._embeds(pooled_prompt_embeds_end)
            un_s = un_e = self._embeds(negative_prompt_embeds)
            neg_pooled_s = neg_pooled_e = self._embeds(negative_pooled_prompt_embeds)
            emb_g, pooled_g = self._embeds(guide_prompt_embeds), self._embeds(guide_pooled_prompt_embeds)
        else:
            emb_s, un_s, pooled_s, neg_pooled_s = self.encode_prompt(prompt_start, negative_prompt)
            emb_e, un_e, pooled_e, neg_pooled_e = self.encode_prompt(prompt_end, negative_prompt)
            emb_g = pooled_g = None
            if guide_prompt_embeds is not None:
                emb_g, pooled_g = self._embeds(guide_prompt_embeds), self._embeds(guide_pooled_prompt_embeds)
            elif guide_prompt is not None:
                emb_g, _, pooled_g, _ = self.encode_prompt(guide_prompt, negative_prompt)
        if emb_g is not None:
            # the guide's pooled embeds fall back to the interpolated ones (sdxl.py:333-340)
            emb_t = emb_g
            pooled_t = pooled_g if pooled_g is not None else self._interp_pair(pooled_s, pooled_e, it, init)
        else:
            emb_t = self._interp_pair(emb_s, emb_e, it, init)
            pooled_t = self._interp_pair(pooled_s, pooled_e, it, init)
        un_t = self._interp_pair(un_s, un_e, it, init)
        neg_pooled_t = self._interp_pair(neg_pooled_s, neg_pooled_e, it, init)

        embs = torch.cat([emb_s, emb_t, emb_e], dim=0)
        uncond = torch.cat([un_s, un_t, un_e], dim=0)
        pooled = torch.cat([pooled_s, pooled_t, pooled_e], dim=0)
        neg_pooled = torch.cat([neg_pooled_s, neg_pooled_t, neg_pooled_e], dim=0)
        ip_cond, ip_uncond = self._ip_embeds(it, init, image_embeds_start, image_embeds_end, negative_image_embeds)
        coef = torch.tensor([0.0, it, 1.0], dtype=torch.float32, device=self.device)
        time_ids, neg_time_ids = self._time_ids_pair(
            3, height, width, original_size, crops_coords_top_left, target_size, negative_original_size,
            negative_crops_coords_top_left, negative_target_size)
        return self._run_sequence(
            latents, embs, uncond, coef, num_inference_steps, warmup_ratio, early, late, guidance_scale,
            guidance_rescale, ip_image_embeds=ip_cond, ip_uncond_image_embeds=ip_uncond,
            added_cond={"text_embeds": pooled, "time_ids": time_ids},
            added_cond_uncond={"text_embeds": neg_pooled, "time_ids": neg_time_ids},
            output_type="latent" if denoising_end is not None else output_type,
            per_frame_decode=True,
            num_run_steps=self._effective_steps(num_inference_steps, denoising_end),
            callback_on_chunk_end=callback_on_chunk_end, callback_on_step_end=callback_on_step_end)
