"""SDXL interpolation pipeline: two prompts in, uint8 frames out.

Counterpart of ``aid_tpu.pipelines.sdxl.InterpolationXLPipeline``'s
``interpolate`` (sdxl.py:156-238) and what it needs: ``encode_prompt`` (the
two text encoders' hidden states concatenated, pooled embeds from encoder
2), the micro-conditioning ``time_ids``, ``denoising_end`` and the
frame-by-frame f32 VAE decode.

One layout trap: ``spherical_interpolation`` slerps over the LAST axis. The
JAX package's latents are NHWC, so it slerps each pixel's channel vector;
the port's latents are NCHW, so ``interpolate`` slerps them channels-last
and turns the result back.

Not yet ported: ``interpolate_single``, the prompt-embeds entry points, the
invisible watermark (the JAX default, None, is what runs here).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from aid_tpu_torch.ops.interp import generate_beta_schedule, linear_interpolation, spherical_interpolation
from aid_tpu_torch.pipelines.interpolation import InterpolationPipeline


def slerp_latents(latent_start: torch.Tensor, latent_end: torch.Tensor, size: int, ts=None) -> torch.Tensor:
    """(1, C, h, w) x 2 -> (size, C, h, w), slerped over channels per pixel
    (the JAX package's NHWC slerp)."""
    out = spherical_interpolation(latent_start.permute(0, 2, 3, 1), latent_end.permute(0, 2, 3, 1), size, ts=ts)
    return out.permute(0, 3, 1, 2).contiguous()


@dataclasses.dataclass
class InterpolationXLPipeline(InterpolationPipeline):
    """``text_encoder``/``tokenizer`` are CLIP ViT-L; ``text_encoder_2``/
    ``tokenizer_2`` are OpenCLIP bigG with its projection."""

    text_encoder_2: Any = None
    tokenizer_2: Any = None
    guidance_scale: float = 5.0
    default_size: int = 1024

    def _effective_steps(self, num_inference_steps: int, denoising_end: Optional[float]) -> int:
        """Steps to run before ``denoising_end`` (sdxl.py:55-66)."""
        if denoising_end is None:
            return num_inference_steps
        if not (0.0 < denoising_end < 1.0):
            raise ValueError(f"denoising_end must be in (0, 1), got {denoising_end}")
        T = self.scheduler.config.num_train_timesteps
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
            ts = np.asarray(ts, np.float32)
            if ts.ndim != 1 or ts[0] != 0.0 or ts[-1] != 1.0:
                raise ValueError("ts must be a 1-D schedule with endpoints 0 and 1")
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
            num_run_steps=self._effective_steps(num_inference_steps, denoising_end))
