"""Build pipelines from local diffusers-format checkpoint directories.

Counterpart of ``aid_tpu.models.loader`` (loader.py:31-310, 532-557), the
JAX package's entry point: read each subfolder's config.json and
safetensors, build the matching modules and assemble an
``InterpolationPipeline`` (SD 1.x / 2.x, with the ``safety_checker/`` a
directory ships) or, for a directory with a ``text_encoder_2``, an
``InterpolationXLPipeline``. Paths are local; nothing is downloaded.

The port's modules carry diffusers' and transformers' parameter names and
layouts, so a checkpoint loads with ``load_state_dict(strict=True)`` and no
conversion. Each module is built on the meta device and takes the tensors
the safetensors reader (``utils/safetensors.py``) put on the target device
in the target dtype, so no random initialisation runs and no second copy is
made. Defaults are the JAX loader's: UNet bf16, text encoders f32, the VAE
f32 when its config sets ``force_upcast`` (bf16 otherwise), the safety
checker f32. Every module lands on ``device``, "cuda" unless the caller asks
for "cpu".

An original single-file checkpoint (``.safetensors`` or torch ``.ckpt``)
loads through :func:`load_single_file_pipeline` (loader.py:313-529): the
layout (SD 1.x, SD 2.x, SDXL) and the model configs are read off the
tensors, the weights converted by ``models.params`` into the same names,
and the prediction type resolved by :func:`resolve_single_file_prediction_type`.

Not ported: the parameter cache (``cache_dir``, orbax). The JAX XL loader
reads no safety checker, and neither does this one.
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Optional

import torch

from aid_tpu_torch.models import configs as C
from aid_tpu_torch.models.clip import CLIPTextModel
from aid_tpu_torch.models.safety import SafetyChecker
from aid_tpu_torch.models.unet import UNet2DCondition
from aid_tpu_torch.models.vae import AutoencoderKL
from aid_tpu_torch.utils.safetensors import load_safetensors
from aid_tpu_torch.utils.tokenizer import load_tokenizer


def _read_config(path: str) -> dict:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def unet_config_from_diffusers(cfg: dict) -> C.UNetConfig:
    """diffusers UNet2DConditionModel config.json -> UNetConfig (loader.py:36-69)."""
    down_types = cfg["down_block_types"]
    levels = len(down_types)

    def per_level(v, default):
        v = cfg.get(v, default)
        return tuple(v) if isinstance(v, (list, tuple)) else (v,) * levels

    # diffusers' legacy naming: attention_head_dim is the HEAD COUNT when
    # num_attention_heads is unset (SD 1.x: 8 heads; SD 2.1: [5, 10, 20, 20]
    # heads, so 64 channels a head at widths 320/640/1280)
    heads = cfg.get("num_attention_heads") or cfg.get("attention_head_dim", 8)
    heads = tuple(heads) if isinstance(heads, (list, tuple)) else (heads,) * levels
    return C.UNetConfig(
        sample_size=cfg.get("sample_size", 64),
        in_channels=cfg.get("in_channels", 4),
        out_channels=cfg.get("out_channels", 4),
        block_out_channels=tuple(cfg["block_out_channels"]),
        cross_attention_levels=tuple("CrossAttn" in t for t in down_types),
        layers_per_block=cfg.get("layers_per_block", 2),
        transformer_layers_per_block=per_level("transformer_layers_per_block", 1),
        num_attention_heads=heads,
        cross_attention_dim=cfg.get("cross_attention_dim", 768),
        use_linear_projection=cfg.get("use_linear_projection", False),
        norm_num_groups=cfg.get("norm_num_groups", 32),
        freq_shift=cfg.get("freq_shift", 0),
        flip_sin_to_cos=cfg.get("flip_sin_to_cos", True),
        addition_embed_type=cfg.get("addition_embed_type"),
        addition_time_embed_dim=cfg.get("addition_time_embed_dim") or 256,
        projection_class_embeddings_input_dim=cfg.get("projection_class_embeddings_input_dim"),
    )


def vae_config_from_diffusers(cfg: dict) -> C.VAEConfig:
    lm, ls = cfg.get("latents_mean"), cfg.get("latents_std")
    return C.VAEConfig(
        in_channels=cfg.get("in_channels", 3),
        out_channels=cfg.get("out_channels", 3),
        latent_channels=cfg.get("latent_channels", 4),
        block_out_channels=tuple(cfg["block_out_channels"]),
        layers_per_block=cfg.get("layers_per_block", 2),
        norm_num_groups=cfg.get("norm_num_groups", 32),
        scaling_factor=cfg.get("scaling_factor", 0.18215),
        latents_mean=tuple(lm) if lm else None,
        latents_std=tuple(ls) if ls else None,
        force_upcast=cfg.get("force_upcast", True),
    )


def clip_text_config_from_transformers(cfg: dict) -> C.CLIPTextConfig:
    proj = cfg.get("projection_dim") if "CLIPTextModelWithProjection" in (cfg.get("architectures") or []) else None
    return C.CLIPTextConfig(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_hidden_layers=cfg["num_hidden_layers"],
        num_attention_heads=cfg["num_attention_heads"],
        max_position_embeddings=cfg.get("max_position_embeddings", 77),
        hidden_act=cfg.get("hidden_act", "quick_gelu"),
        projection_dim=proj,
        eos_token_id=cfg.get("eos_token_id", 49407),
    )


def vae_decode_dtype(cfg: C.VAEConfig) -> torch.dtype:
    """force_upcast -> float32 decode (SD, SDXL), otherwise bfloat16
    (sdxl-vae-fp16-fix, playground-v2.5), as in the JAX loader."""
    return torch.float32 if cfg.force_upcast else torch.bfloat16


def _weights(path: str, dtype: torch.dtype, device) -> dict:
    """The safetensors of ``path`` on ``device`` in ``dtype``, without the
    ``embeddings.position_ids`` buffers transformers checkpoints may carry
    and the port's modules do not hold."""
    return {k: v for k, v in load_safetensors(path, dtype=dtype, device=device).items()
            if not k.endswith("embeddings.position_ids")}


def _placed(cls, cfg, sd: dict, dtype: torch.dtype, device):
    """``cls(cfg)`` built on the meta device, then given ``sd`` on
    ``device`` in ``dtype`` (strict: every name must match, none may be left
    over; transformers' position_ids buffers dropped)."""
    sd = {k: v.to(device=device, dtype=dtype).contiguous() for k, v in sd.items()
          if not k.endswith("embeddings.position_ids")}
    with torch.device("meta"):
        module = cls(cfg, dtype=dtype)
    module.load_state_dict(sd, strict=True, assign=True)
    return module.eval()


def _load_module(cls, cfg, path: str, dtype: torch.dtype, device):
    """``cls(cfg)`` given the safetensors of ``path``, read onto ``device``
    in ``dtype``."""
    return _placed(cls, cfg, load_safetensors(path, dtype=dtype, device=device), dtype, device)


def load_unet(path: str, dtype: torch.dtype = torch.bfloat16, device="cuda") -> UNet2DCondition:
    return _load_module(UNet2DCondition, unet_config_from_diffusers(_read_config(path)), path, dtype, device)


def load_vae(path: str, dtype: Optional[torch.dtype] = None, device="cuda") -> AutoencoderKL:
    """``dtype=None`` follows the checkpoint's ``force_upcast``."""
    cfg = vae_config_from_diffusers(_read_config(path))
    return _load_module(AutoencoderKL, cfg, path, dtype or vae_decode_dtype(cfg), device)


def load_text_encoder(path: str, dtype: torch.dtype = torch.float32, device="cuda") -> CLIPTextModel:
    return _load_module(CLIPTextModel, clip_text_config_from_transformers(_read_config(path)), path, dtype, device)


def clip_vision_config_from_transformers(cfg: dict) -> C.CLIPVisionConfig:
    """transformers CLIPVisionConfig or CLIPConfig (loader.py:159-172): a
    safety_checker / image_encoder config may nest the tower under
    ``vision_config``, with ``projection_dim`` at the top level."""
    vc = cfg.get("vision_config", cfg)
    return C.CLIPVisionConfig(
        image_size=vc.get("image_size", 224),
        patch_size=vc.get("patch_size", 32),
        hidden_size=vc.get("hidden_size", 768),
        intermediate_size=vc.get("intermediate_size", 3072),
        num_hidden_layers=vc.get("num_hidden_layers", 12),
        num_attention_heads=vc.get("num_attention_heads", 12),
        projection_dim=cfg.get("projection_dim", vc.get("projection_dim", 512)),
        hidden_act=vc.get("hidden_act", "quick_gelu"),
    )


def load_safety_checker(path: str, device="cuda") -> SafetyChecker:
    """A ``SafetyChecker`` in f32 from a checkpoint's ``safety_checker/``
    (loader.py:175-184); the concept counts come from the weights."""
    cfg = clip_vision_config_from_transformers(_read_config(path))
    sd = _weights(path, torch.float32, device)
    if "concept_embeds" not in sd:
        raise FileNotFoundError(f"{path} holds no safety-checker weights (no .safetensors with concept_embeds)")
    with torch.device("meta"):
        module = SafetyChecker(cfg, num_concepts=sd["concept_embeds"].shape[0],
                               num_special=sd["special_care_embeds"].shape[0])
    module.load_state_dict(sd, strict=True, assign=True)
    return module.eval()


#: a checkpoint's scheduler class -> the port's scheduler (loader.py:208-215)
_SCHEDULER_CLASSES = {
    "DDIMScheduler": "ddim",
    "PNDMScheduler": "pndm",  # the SD 1.x derivatives' default
    "UniPCMultistepScheduler": "unipc",
    "EulerDiscreteScheduler": "euler",
    "EDMDPMSolverMultistepScheduler": "edm",  # playground-v2.5
    "DPMSolverMultistepScheduler": "unipc",  # the closest functional match
}


def load_scheduler(repo_path: str, scheduler_name: str = "auto"):
    """A scheduler from ``<repo_path>/scheduler/scheduler_config.json``.

    ``"auto"`` dispatches on the config's ``_class_name``; an explicit name
    ("ddim", "pndm", "unipc", "euler", "edm") overrides it. The EDM sigma
    parameters and Euler's Karras flag are read from the config."""
    from aid_tpu_torch.schedulers import (
        DDIMScheduler,
        EDMDPMSolverScheduler,
        EulerDiscreteScheduler,
        PNDMScheduler,
        SchedulerConfig,
        UniPCScheduler,
    )

    sc = {}
    sch_path = os.path.join(repo_path, "scheduler", "scheduler_config.json")
    if os.path.exists(sch_path):
        with open(sch_path) as f:
            sc = json.load(f)
    if scheduler_name == "auto":
        scheduler_name = _SCHEDULER_CLASSES.get(sc.get("_class_name", "DDIMScheduler"), "ddim")

    if scheduler_name == "edm":
        return EDMDPMSolverScheduler(
            sigma_min=sc.get("sigma_min", 0.002), sigma_max=sc.get("sigma_max", 80.0),
            sigma_data=sc.get("sigma_data", 0.5), rho=sc.get("rho", 7.0),
            prediction_type=sc.get("prediction_type", "epsilon"))
    cfg = SchedulerConfig(
        num_train_timesteps=sc.get("num_train_timesteps", 1000),
        beta_start=sc.get("beta_start", 0.00085),
        beta_end=sc.get("beta_end", 0.012),
        beta_schedule=sc.get("beta_schedule", "scaled_linear"),
        prediction_type=sc.get("prediction_type", "epsilon"),
        timestep_spacing=sc.get("timestep_spacing", "leading"),
        steps_offset=sc.get("steps_offset", 1),
        set_alpha_to_one=sc.get("set_alpha_to_one", False),
        clip_sample=sc.get("clip_sample", False),
        rescale_betas_zero_snr=sc.get("rescale_betas_zero_snr", False),
    )
    if scheduler_name == "euler":
        return EulerDiscreteScheduler(cfg, use_karras_sigmas=sc.get("use_karras_sigmas", False))
    if scheduler_name == "pndm":
        return PNDMScheduler(cfg, skip_prk_steps=sc.get("skip_prk_steps", True))
    return {"ddim": DDIMScheduler, "unipc": UniPCScheduler}[scheduler_name](cfg)


def load_interpolation_pipeline(
    repo_path: str,
    scheduler_name: Optional[str] = None,
    dtype: torch.dtype = torch.bfloat16,
    guidance_scale: Optional[float] = None,
    device="cuda",
):
    """An ``InterpolationPipeline`` from a local SD 1.x / 2.x directory
    (unet/ vae/ text_encoder/ tokenizer/ scheduler/), or, when it has a
    ``text_encoder_2``, an ``InterpolationXLPipeline`` through
    :func:`load_interpolation_xl_pipeline`. ``scheduler_name=None`` is the
    family default ("ddim" for SD, the checkpoint's own class for SDXL);
    ``guidance_scale=None`` likewise (7.5 / 5.0). ``dtype`` is the UNet's.
    An SD directory's ``safety_checker/`` (when its config.json exists) is
    loaded in f32 on ``device`` and runs on every decode (loader.py:296-299).
    """
    from aid_tpu_torch.pipelines.interpolation import InterpolationPipeline

    if os.path.isdir(os.path.join(repo_path, "text_encoder_2")):
        return load_interpolation_xl_pipeline(repo_path, scheduler_name="auto" if scheduler_name is None
                                              else scheduler_name, dtype=dtype, guidance_scale=guidance_scale,
                                              device=device)
    safety_dir = os.path.join(repo_path, "safety_checker")
    return InterpolationPipeline(
        unet=load_unet(os.path.join(repo_path, "unet"), dtype=dtype, device=device),
        vae=load_vae(os.path.join(repo_path, "vae"), device=device),
        text_encoder=load_text_encoder(os.path.join(repo_path, "text_encoder"), device=device),
        tokenizer=load_tokenizer(os.path.join(repo_path, "tokenizer")),
        scheduler=load_scheduler(repo_path, scheduler_name or "ddim"),
        guidance_scale=7.5 if guidance_scale is None else guidance_scale,
        safety_checker=(load_safety_checker(safety_dir, device=device)
                        if os.path.exists(os.path.join(safety_dir, "config.json")) else None),
    )


def load_interpolation_xl_pipeline(repo_path: str, scheduler_name: str = "auto", dtype: torch.dtype = torch.bfloat16,
                                   guidance_scale: Optional[float] = None, device="cuda"):
    """An ``InterpolationXLPipeline`` from a local SDXL directory;
    ``scheduler_name="auto"`` honours the checkpoint's scheduler class (so
    playground-v2.5 loads its EDM solver)."""
    from aid_tpu_torch.pipelines.sdxl import InterpolationXLPipeline

    return InterpolationXLPipeline(
        unet=load_unet(os.path.join(repo_path, "unet"), dtype=dtype, device=device),
        vae=load_vae(os.path.join(repo_path, "vae"), device=device),
        text_encoder=load_text_encoder(os.path.join(repo_path, "text_encoder"), device=device),
        tokenizer=load_tokenizer(os.path.join(repo_path, "tokenizer")),
        text_encoder_2=load_text_encoder(os.path.join(repo_path, "text_encoder_2"), device=device),
        tokenizer_2=load_tokenizer(os.path.join(repo_path, "tokenizer_2")),
        scheduler=load_scheduler(repo_path, scheduler_name),
        **({} if guidance_scale is None else {"guidance_scale": guidance_scale}),
    )


def infer_single_file_prediction_type(cross_dim: int, global_step) -> str:
    """The SD 2.x v-prediction heuristic of a single-file checkpoint
    (loader.py:313-325, diffusers' from_single_file rule): the 768-v
    releases trained past ``global_step`` 875 000, the 512 base run
    stopped earlier. Only the 1024-wide cross-attention (SD 2.x) layout can
    be v-prediction; everything else is epsilon."""
    if cross_dim == 1024 and global_step is not None and int(global_step) >= 875_000:
        return "v_prediction"
    return "epsilon"


def apply_prediction_type(scheduler, prediction_type: str):
    """``scheduler`` with its prediction objective pinned (loader.py:328-341):
    a copy of the frozen dataclass, through its nested ``SchedulerConfig``
    where it has one, else through the EDM solver's own field."""
    if hasattr(scheduler, "config"):
        return dataclasses.replace(scheduler, config=dataclasses.replace(scheduler.config,
                                                                         prediction_type=prediction_type))
    return dataclasses.replace(scheduler, prediction_type=prediction_type)


def resolve_single_file_prediction_type(ckpt_dir: str, explicit: Optional[str], cross_dim: int,
                                        global_step) -> Optional[str]:
    """The prediction objective of a single-file load (loader.py:344-380).
    An ``explicit`` value wins. Next, a sidecar
    ``scheduler/scheduler_config.json`` beside the checkpoint that pins
    ``prediction_type``: None is returned, since ``load_scheduler`` already
    read it. Last, :func:`infer_single_file_prediction_type`, which warns on
    an SD 2.x file with no ``global_step`` (bare safetensors exports carry
    none, so a 768-v model cannot be told from the base one): epsilon is
    assumed."""
    if explicit is not None:
        return explicit
    sidecar = os.path.join(ckpt_dir, "scheduler", "scheduler_config.json")
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            if "prediction_type" in json.load(f):
                return None
    if cross_dim == 1024 and global_step is None:
        warnings.warn("SD2.x single-file checkpoint without global_step metadata (typical of bare safetensors "
                      "exports): cannot detect whether this is a 768-v model; defaulting to epsilon. Pass "
                      "prediction_type='v_prediction' if this is a v-objective (768px) checkpoint.", stacklevel=3)
    return infer_single_file_prediction_type(cross_dim, global_step)


def _read_single_file(path: str) -> dict:
    """Every entry of a .safetensors file (the port's reader) or a torch
    .ckpt (``torch.load(weights_only=True)``), on the CPU, as stored."""
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def _text_config(text_sd: dict, hidden_act: str = "quick_gelu", projection_dim: Optional[int] = None):
    """A text tower's config read off its tensors (loader.py:438-451): the
    vocabulary and width from the token table, the depth from the highest
    layer index, 64 channels a head, a 4x MLP."""
    vocab, hidden = text_sd["text_model.embeddings.token_embedding.weight"].shape
    layers = 1 + max(int(k.split(".")[3]) for k in text_sd if k.startswith("text_model.encoder.layers."))
    return C.CLIPTextConfig(vocab_size=vocab, hidden_size=hidden, intermediate_size=4 * hidden,
                            num_hidden_layers=layers, num_attention_heads=hidden // 64, hidden_act=hidden_act,
                            projection_dim=projection_dim)


def load_single_file_pipeline(
    checkpoint_path: str,
    tokenizer_path: str,
    scheduler_name: str = "ddim",
    dtype: torch.dtype = torch.bfloat16,
    guidance_scale: Optional[float] = None,
    tokenizer_2_path: Optional[str] = None,
    prediction_type: Optional[str] = None,
    device="cuda",
):
    """An ``InterpolationPipeline`` (or ``InterpolationXLPipeline``) from an
    original single-file checkpoint, ``.safetensors`` or torch ``.ckpt``
    (loader.py:383-529).

    The layout is read off the keys (``conditioner.embedders.*``: SDXL) and
    the configs off the tensors: cross-attention width 768 is SD 1.x
    (``configs.SD15_UNET``), 1024 SD 2.x (``SD21_UNET``, its OpenCLIP tower
    gelu), with ``use_linear_projection`` from the rank of ``proj_in``'s
    weight; SDXL takes ``SDXL_UNET`` and ``SDXL_VAE``, SD ``SD_VAE``. The
    file holds no tokenizer: ``tokenizer_path`` is any SD tokenizer
    directory. SD 2.x's tokenizer pads with "!" whatever the directory says,
    as does SDXL's ``tokenizer_2`` unless ``tokenizer_2_path`` gives one.
    ``global_step`` is read before the ``state_dict`` wrapper is removed;
    ``prediction_type`` follows :func:`resolve_single_file_prediction_type`.
    Guidance defaults to 7.5 (SD) or 5.0 (SDXL). Each module is built on the
    meta device and takes its converted tensors on ``device`` ("cuda" unless
    the caller asks for "cpu"): the UNet in ``dtype``, the text encoders in
    f32, the VAE by ``force_upcast``, as :func:`load_interpolation_pipeline`
    places them."""
    from aid_tpu_torch.models.params import convert_ldm_checkpoint, convert_ldm_checkpoint_xl
    from aid_tpu_torch.pipelines.interpolation import InterpolationPipeline

    sd = _read_single_file(checkpoint_path)
    global_step = sd.get("global_step")  # torch .ckpt metadata beside state_dict
    if "state_dict" in sd and not hasattr(sd["state_dict"], "shape"):
        sd = sd["state_dict"]
    ckpt_dir = os.path.dirname(checkpoint_path) or "."
    scheduler = load_scheduler(ckpt_dir, scheduler_name)

    def vae(vae_sd, cfg):
        return _placed(AutoencoderKL, cfg, vae_sd, vae_decode_dtype(cfg), device)

    def text(text_sd, **kw):
        return _placed(CLIPTextModel, _text_config(text_sd, **kw), text_sd, torch.float32, device)

    if any(k.startswith("conditioner.embedders.") for k in sd):
        from aid_tpu_torch.pipelines.sdxl import InterpolationXLPipeline

        unet_sd, vae_sd, text_sd, text2_sd = convert_ldm_checkpoint_xl(sd)
        return InterpolationXLPipeline(
            unet=_placed(UNet2DCondition, C.SDXL_UNET, unet_sd, dtype, device),
            vae=vae(vae_sd, C.SDXL_VAE),
            text_encoder=text(text_sd),
            tokenizer=load_tokenizer(tokenizer_path),
            text_encoder_2=text(text2_sd, hidden_act="gelu",
                                projection_dim=text2_sd["text_projection.weight"].shape[0]),
            # the bigG tower was trained with "!" (id 0) padding, whatever an
            # SD tokenizer directory's own config says (loader.py:477-487)
            tokenizer_2=(load_tokenizer(tokenizer_2_path) if tokenizer_2_path
                         else load_tokenizer(tokenizer_path, pad_token="!")),
            scheduler=scheduler,
            guidance_scale=5.0 if guidance_scale is None else guidance_scale,
        )

    unet_sd, vae_sd, text_sd = convert_ldm_checkpoint(sd)
    cross_dim = unet_sd["down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k.weight"].shape[1]
    unet_cfg = C.SD21_UNET if cross_dim == 1024 else C.SD15_UNET
    linear_proj = unet_sd["down_blocks.0.attentions.0.proj_in.weight"].dim() == 2
    if linear_proj != unet_cfg.use_linear_projection:
        unet_cfg = dataclasses.replace(unet_cfg, use_linear_projection=linear_proj)
    prediction_type = resolve_single_file_prediction_type(ckpt_dir, prediction_type, cross_dim, global_step)
    if prediction_type is not None:
        scheduler = apply_prediction_type(scheduler, prediction_type)
    sd2 = cross_dim == 1024
    return InterpolationPipeline(
        unet=_placed(UNet2DCondition, unet_cfg, unet_sd, dtype, device),
        vae=vae(vae_sd, C.SD_VAE),
        text_encoder=text(text_sd, hidden_act="gelu" if sd2 else "quick_gelu"),
        # SD 2.x's OpenCLIP tower was trained with "!" (id 0) padding; SD 1.x
        # tokenizer directories pad with EOS (loader.py:515-525)
        tokenizer=load_tokenizer(tokenizer_path, pad_token="!") if sd2 else load_tokenizer(tokenizer_path),
        scheduler=scheduler,
        guidance_scale=7.5 if guidance_scale is None else guidance_scale,
    )
