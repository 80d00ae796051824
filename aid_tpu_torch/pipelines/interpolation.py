"""The SD1.x interpolation pipeline and the core its subclasses share.

Counterpart of ``aid_tpu.pipelines.interpolation.InterpolationPipeline``:
``generate_latent``, ``encode_prompt``, ``_run_sequence`` with chunked
generation, ``interrupt`` and both callback kinds, the entry points
``interpolate`` (PAID guide prompt, explicit ``ts``), ``interpolate_single``,
``interpolate_save_gpu`` (both ways), ``denoising_interpolate`` and
``__call__``, ``_decode``, batched CFG (``cfg_mode``), VAE tiling
(``enable_vae_tiling``), the bf16 decode (``enable_bf16_vae_decode``) and
the safety checker, run on every decode when set (``run_safety``). Modules are the port's ``nn.Module``s with
their weights inside, so there are no separate parameter trees. Latents are
NCHW; decoded images are NHWC uint8 numpy, as the JAX package returns them.

One layout trap: ``slerp`` works over the LAST axis. The JAX package's
latents are NHWC, so its latent slerps (``spherical_interpolation`` in
``interpolate``, the one-point ``slerp`` in ``interpolate_single``) slerp
each pixel's channel vector. The port's latents are NCHW, so
:func:`slerp_latents` and :func:`slerp_latent` slerp them channels-last and
turn the result back. Text embeds (1, 77, D) have the same layout on both
sides.

Random latents come from a ``torch.Generator``: torch and JAX draw
different numbers from one seed, so parity tests hand both pipelines the
same latents.

IP-Adapter (interpolation.py:177-300): ``load_aid_ip_adapter`` attaches an
h94-format checkpoint (a dict or a ``.safetensors`` path) to a UNet built
with ``ip_num_tokens > 0``: its per-layer ``to_k_ip`` / ``to_v_ip`` go into
the UNet, its ``image_proj`` becomes ``ip_proj`` (an ``ImageProjection``, or
a Plus ``Resampler`` where it has ``latents``). ``encode_image`` runs the
attached CLIP vision tower (pooled embeds for a standard adapter, the
penultimate hidden states for Plus), and ``interpolate_single`` takes the
embeds: each frame's image tokens are the projection of the endpoints'
embeds and of their lerp/slerp. ``early="scale_control"`` per call
selects scale control, where the IP branch is weighted by each frame's
coefficient (the JAX pipeline sets it at load time; the port keeps no mode
state on the pipeline and leaves out the reference's unused
``default_early`` / ``load_aid``).

``interpolate_single`` also takes pre-computed text embeddings
(``prompt_embeds_start`` / ``_end`` with ``negative_prompt_embeds``, and
``guide_prompt_embeds`` with or without them), which skip the tokenizer and
the text encoder (interpolation.py:475-545): the way reference-exported
embeddings (``utils/parity.py``) drive a run. ``load_textual_inversion``
adds an embedding's placeholder to the tokenizer and the text encoder.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any, Optional

import numpy as np
import torch

from aid_tpu_torch.models.layers import AidMode
from aid_tpu_torch.ops.interp import (
    generate_beta_schedule,
    lerp,
    linear_interpolation,
    slerp,
    spherical_interpolation,
)
from aid_tpu_torch.pipelines import engine
from aid_tpu_torch.schedulers.ddim import DDIMScheduler


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def slerp_latents(latent_start: torch.Tensor, latent_end: torch.Tensor, size: int, ts=None) -> torch.Tensor:
    """(1, C, h, w) x 2 -> (size, C, h, w), slerped over channels per pixel
    at uniform points or at ``ts`` (the JAX package's NHWC slerp)."""
    out = spherical_interpolation(_channels_last(latent_start), _channels_last(latent_end), size, ts=ts)
    return _channels_first(out)


def slerp_latent(latent_start: torch.Tensor, latent_end: torch.Tensor, t: float) -> torch.Tensor:
    """One point of :func:`slerp_latents`: (1, C, h, w) at coefficient ``t``."""
    return _channels_first(slerp(_channels_last(latent_start), _channels_last(latent_end), t))


def _check_ts(ts) -> np.ndarray:
    ts = np.asarray(ts, np.float32)
    if ts.ndim != 1 or ts[0] != 0.0 or ts[-1] != 1.0:
        raise ValueError("ts must be a 1-D schedule with endpoints 0 and 1")
    return ts


@dataclasses.dataclass
class InterpolationPipeline:
    """SD1.x / 2.x attention-interpolation pipeline. ``tokenizer`` is any
    callable ``prompt -> (1, max_len) int ids``; ``scheduler`` is any of the
    port's five: DDIM (the default), Euler, PNDM, UniPC or EDM DPM-Solver++.
    The multistep ones carry their history in the scheduler state, which
    the chunked path hands from chunk to chunk; every entry point loops over
    ``state.timesteps`` (PNDM's has n + 1 entries) and takes the AID warmup
    from ``num_inference_steps``. ``models/loader.py`` builds one from a
    diffusers directory."""

    unet: Any
    vae: Any
    text_encoder: Any
    tokenizer: Any
    scheduler: Any = dataclasses.field(default_factory=DDIMScheduler)
    vae_scale_factor: int = 8
    guidance_scale: float = 7.5
    # "sequential": the reference's two UNet passes a step; "batched": one
    # 2N-row pass (the same result; see pipelines/engine.py)
    cfg_mode: str = "sequential"
    # When set, generation runs as ceil(steps / chunk) ``engine.denoise_steps``
    # segments and ``interrupt()`` is honoured between them.
    denoise_chunk_size: Optional[int] = None
    _interrupt: bool = dataclasses.field(default=False, repr=False)
    # Spatial VAE tiling: None = off, else the latent tile edge (64 = 512px
    # tiles); see enable_vae_tiling()
    vae_tile_latent_size: Optional[int] = None
    # models.safety.SafetyChecker run on every decode (flagged frames come
    # out black); None skips it, as the JAX pipeline does without one
    safety_checker: Any = None
    # IP-Adapter attachments (load_aid_ip_adapter): the image projection
    # (None: no adapter), its scale, whether it is a Plus resampler, and the
    # CLIP vision tower encode_image runs
    ip_proj: Any = None
    ip_scale: float = 1.0
    ip_plus: bool = False
    image_encoder: Any = None

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    @property
    def latent_channels(self) -> int:
        return self.unet.config.in_channels

    def interrupt(self) -> None:
        """Request a cooperative cancel of the running generation: it stops
        at the next chunk boundary (``denoise_chunk_size`` or a callback)
        and decodes the latents it has."""
        self._interrupt = True

    def _latent_hw(self, height: Optional[int], width: Optional[int]):
        size = self.unet.config.sample_size
        h = (height // self.vae_scale_factor) if height else size
        w = (width // self.vae_scale_factor) if width else size
        return h, w

    def generate_latent(self, generator: torch.Generator, height: Optional[int] = None,
                        width: Optional[int] = None) -> torch.Tensor:
        """Random (1, C, h, w) f32 latent from ``generator``, on its device."""
        h, w = self._latent_hw(height, width)
        return torch.randn((1, self.latent_channels, h, w), generator=generator, device=generator.device,
                           dtype=torch.float32)

    def _seeded_latent(self, seed: int, height: Optional[int] = None, width: Optional[int] = None):
        return self.generate_latent(torch.Generator(device=self.device).manual_seed(seed), height, width)

    def _ids(self, tokenizer, text: str) -> torch.Tensor:
        return torch.as_tensor(tokenizer(text), device=self.device)

    @torch.no_grad()
    def encode_prompt(self, prompt: str, negative_prompt: str = "", clip_skip: int = 0):
        """Prompt -> (cond, uncond) embeddings, each (1, S, D)."""
        emb, _, _ = self.text_encoder(self._ids(self.tokenizer, prompt), clip_skip=clip_skip)
        neg, _, _ = self.text_encoder(self._ids(self.tokenizer, negative_prompt), clip_skip=clip_skip)
        return emb, neg

    def enable_vae_tiling(self, tile_latent_size: int = 64):
        """Decode in overlapping spatial tiles (``engine.tiled_decode``), so
        large outputs fit in device memory."""
        self.vae_tile_latent_size = tile_latent_size
        return self

    def disable_vae_tiling(self):
        self.vae_tile_latent_size = None
        return self

    def enable_bf16_vae_decode(self):
        """Decode in bf16: the VAE module is cast to bf16 in place, on its
        device (interpolation.py:143-153; bf16 keeps f32's exponent range,
        so the fp16 overflow that makes the reference upcast does not
        arise). Its mid-block attention then runs the bf16 D=512 kernel on
        the card. The default stays f32, the reference's numerics."""
        self.vae.to(dtype=torch.bfloat16)
        return self

    def _interp_pair(self, a, b, t, init: str):
        return lerp(a, b, t) if init == "linear" else slerp(a, b, t)

    @property
    def has_ip(self) -> bool:
        return self.ip_proj is not None

    @torch.no_grad()
    def _project_ip(self, image_embeds: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """CLIP image embeds (B, D), or Plus hidden states (B, S, D) -> IP
        tokens (B, T, cross_attention_dim); None stays None."""
        if image_embeds is None:
            return None
        if not self.has_ip:
            raise ValueError("image embeds need an IP-Adapter: call load_aid_ip_adapter first")
        return self.ip_proj(torch.as_tensor(image_embeds, device=self.device))

    def _aid_modes(self, early: str, late: str):
        """The early and late steps' AidModes. ``early="scale_control"``
        (interpolation.py:186-188) weights the IP branch by each frame's
        coefficient in every step: text ``fused_outer`` early and vanilla
        late, so it takes only ``late="self"``."""
        if early == "scale_control":
            if not self.has_ip:
                raise ValueError("early='scale_control' needs an IP-Adapter: call load_aid_ip_adapter first")
            if late != "self":
                raise ValueError(f"early='scale_control' runs its late steps vanilla; got late={late!r}")
            return AidMode.from_name("scale_control"), AidMode.vanilla(scale_control=True)
        return AidMode.from_name(early, has_ip=self.has_ip), AidMode.from_name(late, has_ip=self.has_ip)

    @torch.no_grad()
    def load_aid_ip_adapter(self, checkpoint, image_encoder=None, scale: float = 1.0):
        """Attach an IP-Adapter (interpolation.py:197-269).

        ``checkpoint``: an h94-format dict (``image_proj`` and
        ``ip_adapter``) or a path to its ``.safetensors`` file, whose keys
        split on their first ``.`` into those two groups. The per-layer
        weights are copied into the UNet's IP projections, which exist only
        where its config has ``ip_num_tokens > 0``; the projection is built
        from ``image_proj`` in f32 on the pipeline's device (a Plus
        resampler where it has ``latents``). ``image_encoder``: the
        ``CLIPVisionModel`` that ``encode_image`` runs. Scale control is
        chosen per call, with ``early="scale_control"``."""
        from aid_tpu_torch.models.ip_adapter import Resampler, image_projection_from_state_dict
        from aid_tpu_torch.models.params import ip_adapter_state_dict
        from aid_tpu_torch.utils.safetensors import load_safetensors

        cfg = self.unet.config
        if not cfg.ip_num_tokens:
            raise ValueError("the UNet has no IP-Adapter projections: build it from a config with ip_num_tokens > 0")
        if not isinstance(checkpoint, Mapping):
            flat, checkpoint = load_safetensors(str(checkpoint)), {"image_proj": {}, "ip_adapter": {}}
            for k, v in flat.items():
                group, rest = k.split(".", 1)
                checkpoint[group][rest] = v
        params = dict(self.unet.named_parameters())
        for name, w in ip_adapter_state_dict(checkpoint, cfg).items():
            if params[name].shape != w.shape:
                raise ValueError(f"{name}: the checkpoint's shape {tuple(w.shape)}, the UNet's "
                                 f"{tuple(params[name].shape)}")
            params[name].copy_(w)
        self.ip_proj = image_projection_from_state_dict(checkpoint["image_proj"], cfg.cross_attention_dim,
                                                        cfg.ip_num_tokens, device=self.device)
        self.ip_plus = isinstance(self.ip_proj, Resampler)
        self.ip_scale = scale
        self.image_encoder = image_encoder
        return self

    def load_textual_inversion(self, checkpoint, token: Optional[str] = None):
        """Add a textual-inversion embedding (a dict or a file; the layouts
        of ``models.params.textual_inversion_embedding``) to the text
        encoder and the tokenizer (interpolation.py:271-283): the token
        table grows on its device, and the placeholder maps to its new ids."""
        from aid_tpu_torch.models.params import load_textual_inversion

        load_textual_inversion(self.text_encoder, self.tokenizer, checkpoint, token)
        return self

    def _embeds(self, x) -> Optional[torch.Tensor]:
        return None if x is None else torch.as_tensor(x, device=self.device)

    @torch.no_grad()
    def encode_image(self, images) -> torch.Tensor:
        """Frames (N, H, W, 3), uint8 or float in [0, 1], numpy or torch ->
        CLIP image embeds from the attached vision tower
        (interpolation.py:285-296): the projected pooled embeds (N, D) for a
        standard adapter, the penultimate hidden states (N, S, D) for Plus."""
        if self.image_encoder is None:
            raise ValueError("no image encoder attached: pass image_encoder to load_aid_ip_adapter")
        from aid_tpu_torch.prior.clip_scorer import preprocess

        weight = self.image_encoder.visual_projection.weight
        px = preprocess(images, self.image_encoder.config.image_size, device=weight.device).to(weight.dtype)
        embeds, penultimate = self.image_encoder(px)
        return penultimate if self.ip_plus else embeds

    def _ip_embeds(self, it: float, init: str, image_embeds_start, image_embeds_end, negative_image_embeds):
        """The cond and uncond image embeds of a 3-frame run
        (interpolation.py:556-565): [start, interpolated, end] and the
        negative embeds three times. Without ``image_embeds_start`` (scale
        control) the start is the negative embeds, which default to zeros.
        (None, None) without ``image_embeds_end``."""
        if image_embeds_end is None:
            return None, None
        image_embeds_end = torch.as_tensor(image_embeds_end, device=self.device)
        if negative_image_embeds is None:
            negative_image_embeds = torch.zeros_like(image_embeds_end)
        negative_image_embeds = torch.as_tensor(negative_image_embeds, device=self.device)
        if image_embeds_start is None:
            image_embeds_start = negative_image_embeds
        image_embeds_start = torch.as_tensor(image_embeds_start, device=self.device)
        ip_t = self._interp_pair(image_embeds_start, image_embeds_end, it, init)
        return (torch.cat([image_embeds_start, ip_t, image_embeds_end]),
                torch.cat([negative_image_embeds] * 3))

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
        ip_image_embeds: Optional[torch.Tensor] = None,
        ip_uncond_image_embeds: Optional[torch.Tensor] = None,
        added_cond: Optional[dict] = None,
        added_cond_uncond: Optional[dict] = None,
        output_type: str = "np",
        per_frame_decode: bool = False,
        num_run_steps: Optional[int] = None,  # denoising_end truncation
        callback_on_chunk_end=None,  # fn(pipe, step_end, latents) -> latents | None
        callback_on_step_end=None,  # reference-style fn(pipe, i, t, {"latents": ...}) -> dict | None
    ):
        if output_type not in ("np", "latent"):
            raise ValueError(f"output_type must be 'np' or 'latent', got {output_type!r}")
        if guidance_scale is None:
            guidance_scale = self.guidance_scale
        state = self.scheduler.init(num_inference_steps, device=latents.device)
        latents = latents * state.init_noise_sigma
        if num_run_steps is None:
            num_run_steps = int(state.timesteps.shape[0])
        self._interrupt = False
        # early mode for steps i < warmup_steps, 0-based (interpolation.py:335-342)
        warmup_steps = min(int(num_inference_steps * warmup_ratio), num_run_steps)
        early_mode, late_mode = self._aid_modes(early, late)
        common = dict(early=early_mode, late=late_mode, warmup_steps=warmup_steps, guidance_rescale=guidance_rescale,
                      ip_embeds=self._project_ip(ip_image_embeds),
                      ip_uncond_embeds=self._project_ip(ip_uncond_image_embeds), ip_scale=self.ip_scale,
                      added_cond=added_cond, added_cond_uncond=added_cond_uncond, cfg_mode=self.cfg_mode)
        chunk = self.denoise_chunk_size
        if callback_on_step_end is not None:
            # the reference's per-step signature: every step ends a chunk
            if callback_on_chunk_end is not None:
                raise ValueError("pass callback_on_step_end or callback_on_chunk_end, not both")
            timesteps = state.timesteps

            def callback_on_chunk_end(pipe, step_end, lat, _cb=callback_on_step_end):
                out = _cb(pipe, step_end - 1, timesteps[step_end - 1], {"latents": lat})
                return None if out is None else out.get("latents")

            chunk = 1
        if chunk is None and callback_on_chunk_end is None:
            final = engine.denoise_sequence(self.unet, self.scheduler, latents, embs, uncond_embs, coef, state,
                                            guidance_scale, num_steps=num_run_steps, **common)
        else:
            chunk = chunk or num_run_steps
            final = latents
            for s in range(0, num_run_steps, chunk):
                end = min(s + chunk, num_run_steps)
                final, state = engine.denoise_steps(self.unet, self.scheduler, final, embs, uncond_embs, coef,
                                                    state, guidance_scale, start=s, end=end, **common)
                if callback_on_chunk_end is not None:
                    out = callback_on_chunk_end(self, end, final)
                    if out is not None:
                        final = out
                if self._interrupt:
                    break
        if output_type == "latent":
            return final
        return self._decode(final, per_frame=per_frame_decode)

    def interpolate(
        self,
        latent_start: torch.Tensor,  # (1, C, h, w)
        latent_end: torch.Tensor,
        prompt_start: str,
        prompt_end: str,
        guide_prompt: Optional[str] = None,
        negative_prompt: str = "",
        size: int = 7,
        num_inference_steps: int = 25,
        warmup_ratio: float = 0.5,
        early: str = "fused_outer",
        late: str = "self",
        alpha: Optional[float] = None,
        beta: Optional[float] = None,
        guidance_scale: Optional[float] = None,
        ts=None,
        output_type: str = "np",
        callback_on_chunk_end=None,
        callback_on_step_end=None,
    ):
        """A ``size``-frame sequence from ``prompt_start`` to ``prompt_end``
        in one batch.

        Latents slerp and text embeds lerp at uniform points, or every
        interior frame takes ``guide_prompt`` (PAID); the per-frame attention
        coefficients follow the Beta(alpha, beta) schedule (alpha, beta
        default to ``num_inference_steps``). ``ts`` ((N,) with ts[0] = 0,
        ts[-1] = 1) sets the points of all three and the size. Returns
        (size, H, W, 3) uint8 numpy, or the final latents for
        ``output_type="latent"``.
        """
        if alpha is None:
            alpha = float(num_inference_steps)
        if beta is None:
            beta = float(num_inference_steps)
        if ts is not None:
            ts = _check_ts(ts)
            size = int(ts.shape[0])
        latents = slerp_latents(latent_start.to(self.device), latent_end.to(self.device), size, ts=ts)
        emb_s, un_s = self.encode_prompt(prompt_start, negative_prompt)
        emb_e, un_e = self.encode_prompt(prompt_end, negative_prompt)
        if guide_prompt is not None:
            emb_g, un_g = self.encode_prompt(guide_prompt, negative_prompt)
            embs = torch.cat([emb_s] + [emb_g] * (size - 2) + [emb_e], dim=0)
            uncond = torch.cat([un_s] + [un_g] * (size - 2) + [un_e], dim=0)
        else:
            embs = linear_interpolation(emb_s, emb_e, size=size, ts=ts)
            uncond = linear_interpolation(un_s, un_e, size=size, ts=ts)
        coef = ts if ts is not None else generate_beta_schedule(size, alpha, beta, force_endpoints=True)
        coef = torch.as_tensor(coef, dtype=torch.float32, device=self.device)
        return self._run_sequence(latents, embs, uncond, coef, num_inference_steps, warmup_ratio, early, late,
                                  guidance_scale, output_type=output_type, callback_on_chunk_end=callback_on_chunk_end,
                                  callback_on_step_end=callback_on_step_end)

    def interpolate_single(
        self,
        it: float,
        latent_start: Optional[torch.Tensor] = None,
        latent_end: Optional[torch.Tensor] = None,
        prompt_start: str = "",
        prompt_end: str = "",
        guide_prompt: Optional[str] = None,
        negative_prompt: str = "",
        num_inference_steps: int = 25,
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
        negative_prompt_embeds: Optional[torch.Tensor] = None,
        guide_prompt_embeds: Optional[torch.Tensor] = None,
        seed: int = 0,
        output_type: str = "np",
        callback_on_chunk_end=None,
        callback_on_step_end=None,
    ):
        """3-frame [A, interpolated, B] generation: the middle latent is
        slerp(A, B, it) per pixel, its text embeds the guide prompt's (PAID)
        or the lerp/slerp (``init``) of the endpoints', coefficients
        [0, it, 1]. Missing latents come from ``seed`` and ``seed + 1``.
        With an IP-Adapter loaded, ``image_embeds_start/end`` (from
        ``encode_image``) are interpolated the same way; with only
        ``image_embeds_end`` (scale control, ``early="scale_control"``)
        the start is ``negative_image_embeds``, zeros by default.

        ``prompt_embeds_start`` / ``_end`` and ``negative_prompt_embeds``
        (each (1, S, D), all three together) stand in for the prompts and
        skip the text encoder; ``guide_prompt_embeds`` stands in for the
        guide prompt, with or without them (interpolation.py:525-545)."""
        if not 0.0 < it < 1.0:
            raise ValueError("t must be between 0 and 1")
        latent_start = self._seeded_latent(seed) if latent_start is None else latent_start.to(self.device)
        latent_end = self._seeded_latent(seed + 1) if latent_end is None else latent_end.to(self.device)
        latents = torch.cat([latent_start, slerp_latent(latent_start, latent_end, it), latent_end], dim=0)

        if prompt_embeds_start is not None:
            if prompt_embeds_end is None or negative_prompt_embeds is None:
                raise ValueError("prompt_embeds_start requires prompt_embeds_end and negative_prompt_embeds")
            emb_s, emb_e = self._embeds(prompt_embeds_start), self._embeds(prompt_embeds_end)
            un_s = un_e = self._embeds(negative_prompt_embeds)
            emb_g = self._embeds(guide_prompt_embeds)
        else:
            emb_s, un_s = self.encode_prompt(prompt_start, negative_prompt)
            emb_e, un_e = self.encode_prompt(prompt_end, negative_prompt)
            if guide_prompt_embeds is not None:
                emb_g = self._embeds(guide_prompt_embeds)
            else:
                emb_g = self.encode_prompt(guide_prompt, negative_prompt)[0] if guide_prompt is not None else None
        emb_t = emb_g if emb_g is not None else self._interp_pair(emb_s, emb_e, it, init)
        un_t = self._interp_pair(un_s, un_e, it, init)
        embs = torch.cat([emb_s, emb_t, emb_e], dim=0)
        uncond = torch.cat([un_s, un_t, un_e], dim=0)
        ip_cond, ip_uncond = self._ip_embeds(it, init, image_embeds_start, image_embeds_end, negative_image_embeds)
        coef = torch.tensor([0.0, it, 1.0], dtype=torch.float32, device=self.device)
        return self._run_sequence(latents, embs, uncond, coef, num_inference_steps, warmup_ratio, early, late,
                                  guidance_scale, guidance_rescale, ip_image_embeds=ip_cond,
                                  ip_uncond_image_embeds=ip_uncond, output_type=output_type,
                                  callback_on_chunk_end=callback_on_chunk_end,
                                  callback_on_step_end=callback_on_step_end)

    def interpolate_save_gpu(
        self,
        latent_start: torch.Tensor,
        latent_end: torch.Tensor,
        prompt_start: str,
        prompt_end: str,
        guide_prompt: Optional[str] = None,
        negative_prompt: str = "",
        size: int = 7,
        num_inference_steps: int = 25,
        warmup_ratio: float = 0.5,
        early: str = "fused_outer",
        late: str = "self",
        alpha: Optional[float] = None,
        beta: Optional[float] = None,
        init: str = "linear",
        guidance_scale: Optional[float] = None,
        batched: bool = False,
    ) -> np.ndarray:
        """Frame-at-a-time stitched generation: (size - 2) 3-frame runs at
        the Beta-PPF points, stitched [first 2] + middles + [last], so peak
        memory stays that of one 3-frame run. ``batched=True`` runs the same
        sequence as ONE ``interpolate(ts=...)`` batch (every AID mode takes
        K/V only from the endpoint rows, so each middle frame depends only on
        its own inputs and the endpoint trajectories). ``init="denoising"``
        takes the denoising-interpolation baseline per frame."""
        if alpha is None:
            alpha = float(num_inference_steps)
        if beta is None:
            beta = float(num_inference_steps)
        betas = generate_beta_schedule(size, alpha, beta, force_endpoints=True)
        if batched and init == "linear":
            return self.interpolate(latent_start, latent_end, prompt_start, prompt_end, guide_prompt=guide_prompt,
                                    negative_prompt=negative_prompt, size=size,
                                    num_inference_steps=num_inference_steps, warmup_ratio=warmup_ratio,
                                    early=early, late=late, guidance_scale=guidance_scale, ts=betas)
        final = None
        for i in range(size - 2):
            it = float(betas[i + 1])
            if init == "denoising":
                images = self.denoising_interpolate(latent_start, prompt_start, prompt_end, negative_prompt,
                                                    interpolated_ratio=it, timesteps=num_inference_steps)
            else:
                images = self.interpolate_single(it, latent_start, latent_end, prompt_start, prompt_end,
                                                 guide_prompt=guide_prompt, negative_prompt=negative_prompt,
                                                 num_inference_steps=num_inference_steps, warmup_ratio=warmup_ratio,
                                                 early=early, late=late, init=init, guidance_scale=guidance_scale)
            if size == 3:
                return images
            if i == 0:
                final = images[:2]
            elif i == size - 3:
                final = np.concatenate([final, images[1:]], axis=0)
            else:
                final = np.concatenate([final, images[1:2]], axis=0)
        return final

    def _cond_kwargs(self, prompt: str, negative_prompt: str, batch: int, latent_hw) -> tuple:
        """(cond embeds, uncond embeds, extra engine kwargs) of a vanilla CFG
        run, repeated to ``batch`` rows. The SDXL subclass adds its
        micro-conditioning dicts."""
        emb, uncond = self.encode_prompt(prompt, negative_prompt)[:2]
        return emb.repeat_interleave(batch, dim=0), uncond.repeat_interleave(batch, dim=0), {}

    def denoising_interpolate(
        self,
        latents: torch.Tensor,
        text_1: str,
        text_2: str,
        negative_prompt: str = "",
        interpolated_ratio: float = 1.0,
        timesteps: int = 25,
        guidance_scale: Optional[float] = None,
    ) -> np.ndarray:
        """Baseline without AID: condition on ``text_1`` for the first
        ``int(timesteps * interpolated_ratio)`` steps, then on ``text_2``."""
        if guidance_scale is None:
            guidance_scale = self.guidance_scale
        latents = latents.to(self.device)
        n = latents.shape[0]
        emb1, uncond, extra1 = self._cond_kwargs(text_1, negative_prompt, n, latents.shape[2:])
        emb2, _, extra2 = self._cond_kwargs(text_2, negative_prompt, n, latents.shape[2:])
        state = self.scheduler.init(timesteps, device=latents.device)
        latents = latents * state.init_noise_sigma
        switch = int(timesteps * interpolated_ratio)
        end = int(state.timesteps.shape[0])
        latents, state = engine.denoise_range(self.unet, self.scheduler, latents, emb1, uncond, state, guidance_scale,
                                              start=0, end=switch, **extra1)
        latents, state = engine.denoise_range(self.unet, self.scheduler, latents, emb2, uncond, state, guidance_scale,
                                              start=switch, end=end, **extra2)
        return self._decode(latents)

    def __call__(
        self,
        prompt: str,
        negative_prompt: str = "",
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_inference_steps: int = 50,
        guidance_scale: Optional[float] = None,
        num_images_per_prompt: int = 1,
        seed: int = 0,
        latents: Optional[torch.Tensor] = None,
        output_type: str = "np",
    ):
        """Plain text-to-image, always vanilla attention. Without
        ``latents``, image i starts from the latent of seed ``seed + i``."""
        if output_type not in ("np", "latent"):
            raise ValueError(f"output_type must be 'np' or 'latent', got {output_type!r}")
        if guidance_scale is None:
            guidance_scale = self.guidance_scale
        if latents is None:
            latents = torch.cat([self._seeded_latent(seed + i, height, width) for i in range(num_images_per_prompt)])
        elif num_images_per_prompt not in (1, latents.shape[0]):
            raise ValueError(f"num_images_per_prompt={num_images_per_prompt} but explicit latents have batch "
                             f"{latents.shape[0]}; pass matching latents or omit one of the two")
        latents = latents.to(self.device)
        emb, uncond, extra = self._cond_kwargs(prompt, negative_prompt, latents.shape[0], latents.shape[2:])
        state = self.scheduler.init(num_inference_steps, device=latents.device)
        latents = latents * state.init_noise_sigma
        final, _ = engine.denoise_range(self.unet, self.scheduler, latents, emb, uncond, state, guidance_scale,
                                        start=0, end=int(state.timesteps.shape[0]), **extra)
        if output_type == "latent":
            return final
        return self._decode(final)

    def _decode(self, latents: torch.Tensor, per_frame: bool = False):
        cfg = self.vae.config
        images = engine.decode_latents(self.vae, latents, cfg.scaling_factor, latents_mean=cfg.latents_mean,
                                       latents_std=cfg.latents_std, per_frame=per_frame,
                                       tile_latent_size=self.vae_tile_latent_size)
        images = engine.to_uint8(images)
        if self.safety_checker is not None:
            images, _ = self.run_safety(images)
        return images

    def run_safety(self, images: np.ndarray):
        """(frames with the flagged ones set to 0, (N,) bool flags) of the
        safety checker on (N, H, W, 3) uint8 frames. ``_decode`` applies it
        to every decode; a caller that needs the flags calls this."""
        from aid_tpu_torch.models.safety import run_safety_checker

        return run_safety_checker(images, self.safety_checker)
