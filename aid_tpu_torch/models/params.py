"""Parameter conversion between the JAX package's flax trees and the port's modules.

Each ``*_state_dict_from_flax`` takes a parameter tree of the JAX package
(nested dicts of numpy arrays, with or without the top-level ``"params"``
key) and returns the ``state_dict`` that the port's module loads with
``strict=True``: it inverts ``aid_tpu.models.params``'s ``_convert_leaf``
and ``_torch_path_to_flax`` (params.py:45-100) and the per-model renames of
``convert_vae_state_dict`` and ``convert_clip_text_state_dict``
(params.py:139-162). Diffusers and transformers checkpoints need no
conversion at all: the port's modules carry their names and layouts.

An h94-format IP-Adapter checkpoint (``{"image_proj": ..., "ip_adapter":
{"<idx>.to_k_ip.weight", ...}}``) needs one: its per-layer weights are
numbered by the UNet's attention processors, which
:func:`unet_attention_order` turns into the port's module names
(:func:`ip_adapter_state_dict`). Its ``image_proj`` loads as it is
(``models.ip_adapter``).

What users load into a pipeline besides a diffusers directory
(params.py:270-765):

* an original single-file LDM checkpoint (SD 1.x, SD 2.x with its OpenCLIP
  ViT-H tower, SDXL): :func:`convert_ldm_checkpoint`,
  :func:`convert_ldm_checkpoint_xl` and :func:`convert_open_clip_text_state_dict`
  split it into diffusers / transformers state dicts, which the port's
  modules load with ``load_state_dict(strict=True, assign=True)``;
* a LoRA: :func:`merge_lora` gives a UNet with ``W + scale * alpha / r * B @ A``
  in its targets and the caller's tensors everywhere else;
* a textual-inversion embedding: :func:`load_textual_inversion` grows the
  text encoder's token table and registers the placeholder's ids.

The key maps are the port's own copies; nothing here imports the JAX
package.
"""

from __future__ import annotations

import dataclasses
import os
import re
from collections import OrderedDict
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

# flax module-name folding -> diffusers dotted path
_UNFOLD = (
    (re.compile(r"^(down_blocks|up_blocks)_(\d+)_(resnets|attentions|downsamplers|upsamplers)_(\d+)$"),
     r"\1.\2.\3.\4"),
    (re.compile(r"^mid_block_(resnets|attentions)_(\d+)$"), r"mid_block.\1.\2"),
    (re.compile(r"^(transformer_blocks|layers)_(\d+)$"), r"\1.\2"),
    (re.compile(r"^net_0_proj$"), "net.0.proj"),
    (re.compile(r"^(net|to_out)_(\d+)$"), r"\1.\2"),
)


def _unfold(name: str) -> str:
    for pattern, repl in _UNFOLD:
        if pattern.match(name):
            return pattern.sub(repl, name)
    return name


def _leaf_to_torch(name: str, w: np.ndarray):
    """flax leaf -> (torch leaf name, array in torch layout)."""
    if name == "kernel":
        if w.ndim == 4:  # conv HWIO -> OIHW
            return "weight", w.transpose(3, 2, 0, 1)
        if w.ndim == 2:  # linear (in, out) -> (out, in)
            return "weight", w.transpose(1, 0)
        raise ValueError(f"kernel of rank {w.ndim}")
    if name in ("scale", "embedding"):
        return "weight", w
    return name, w


def _state_dict(tree: Dict, unfold, dtype: Optional[torch.dtype] = None) -> "OrderedDict[str, torch.Tensor]":
    """Walk a flax tree; ``unfold(name, depth)`` gives each module name's
    dotted path. ``dtype``: each leaf cast to it (rounded once from the
    tree's own values), else kept in the tree's dtype."""
    if "params" in tree:
        tree = tree["params"]
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def walk(node, prefix):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, prefix + [unfold(key, len(prefix))])
            else:
                name, w = _leaf_to_torch(key, np.asarray(value))
                # a copy: the input may be read-only
                out[".".join(prefix + [name])] = torch.tensor(w) if dtype is None else torch.tensor(w).to(dtype)

    walk(tree, [])
    return out


def unet_state_dict_from_flax(tree: Dict, dtype: Optional[torch.dtype] = None) -> "OrderedDict[str, torch.Tensor]":
    """JAX UNet2DCondition params (numpy leaves) -> the port's state_dict,
    in ``dtype`` if given (an f16 or bf16 UNet from the same f32 draw)."""
    return _state_dict(tree, lambda key, depth: _unfold(key), dtype)


_VAE_UNFOLD = (
    # the VAE's up- and downsamplers are bare flax Convs; diffusers wraps
    # them as upsamplers.0.conv / downsamplers.0.conv
    (re.compile(r"^(up|down)_blocks_(\d+)_(up|down)samplers_0$"), r"\1_blocks.\2.\3samplers.0.conv"),
    # nested mid block (params.py:139-152): mid_block/resnets_0 -> mid_block.resnets.0
    (re.compile(r"^(resnets|attentions)_(\d+)$"), r"\1.\2"),
)


def vae_state_dict_from_flax(tree: Dict, dtype: Optional[torch.dtype] = None) -> "OrderedDict[str, torch.Tensor]":
    """JAX AutoencoderKL params (encoder, decoder, ``quant_conv``,
    ``post_quant_conv``) -> the port's AutoencoderKL state_dict, in
    ``dtype`` if given."""

    def unfold(key, depth):
        for pattern, repl in _VAE_UNFOLD:
            if pattern.match(key):
                return pattern.sub(repl, key)
        return _unfold(key)

    return _state_dict(tree, unfold, dtype)


_CLIP_TOP = {
    "token_embedding": "text_model.embeddings.token_embedding",
    "position_embedding": "text_model.embeddings.position_embedding",
    "final_layer_norm": "text_model.final_layer_norm",
}


def clip_text_state_dict_from_flax(tree: Dict, dtype: Optional[torch.dtype] = None) -> "OrderedDict[str, torch.Tensor]":
    """JAX CLIPTextModel params -> the port's CLIPTextModel state_dict
    (transformers names; ``text_projection`` when the config has one), in
    ``dtype`` if given."""

    def unfold(key, depth):
        if depth == 0:
            m = re.match(r"^layers_(\d+)$", key)
            return f"text_model.encoder.layers.{m.group(1)}" if m else _CLIP_TOP.get(key, key)
        m = re.match(r"^mlp_(fc[12])$", key)
        return f"mlp.{m.group(1)}" if m else key

    return _state_dict(tree, unfold, dtype)


def unet_attention_order(config) -> List[str]:
    """The UNet's cross-attention (attn2) modules, as dotted names, in the
    order of diffusers' ``attn_processors``: down blocks, UP blocks, then
    the mid block LAST (aid_tpu/models/params.py:236-262). diffusers assigns
    ``up_blocks`` before ``mid_block``, and torch registers children in
    assignment order, so IP-Adapter checkpoints number their layers that
    way: in SD 1.5 the odd indices 1..29 are down and up, 31 is the mid
    block."""
    names = []

    def add(base, level):
        for ti in range(max(config.transformer_layers_per_block[level], 1)):
            names.append(f"{base}.transformer_blocks.{ti}.attn2")

    for level in range(config.num_levels):
        if config.cross_attention_levels[level]:
            for j in range(config.layers_per_block):
                add(f"down_blocks.{level}.attentions.{j}", level)
    for up_idx, level in enumerate(reversed(range(config.num_levels))):
        if config.cross_attention_levels[level]:
            for j in range(config.layers_per_block + 1):
                add(f"up_blocks.{up_idx}.attentions.{j}", level)
    top = config.num_levels - 1
    mid_level = top if config.cross_attention_levels[top] else next(
        i for i in reversed(range(config.num_levels)) if config.cross_attention_levels[i])
    add("mid_block.attentions.0", mid_level)
    return names


def ip_adapter_state_dict(checkpoint: Mapping, config) -> "OrderedDict[str, torch.Tensor]":
    """An h94-format checkpoint's per-layer ``to_k_ip`` / ``to_v_ip``
    weights under the port's UNet names (``<attn2>.to_k_ip.weight``): its
    sorted layer indices are matched, one for one, with
    :func:`unet_attention_order`. Their counts must agree."""
    ip = checkpoint["ip_adapter"]
    idxs = sorted({int(k.split(".")[0]) for k in ip})
    order = unet_attention_order(config)
    if len(idxs) != len(order):
        raise ValueError(f"the IP checkpoint has {len(idxs)} cross-attention entries, the UNet {len(order)}")
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for idx, name in zip(idxs, order):
        for proj in ("to_k_ip", "to_v_ip"):
            out[f"{name}.{proj}.weight"] = torch.as_tensor(ip[f"{idx}.{proj}.weight"])
    return out


# ---------------------------------------------------------------------------
# single-file (original LDM .ckpt / .safetensors) checkpoints
# ---------------------------------------------------------------------------

_LDM_RES_MAP = {
    "in_layers.0": "norm1",
    "in_layers.2": "conv1",
    "emb_layers.1": "time_emb_proj",
    "out_layers.0": "norm2",
    "out_layers.3": "conv2",
    "skip_connection": "conv_shortcut",
}

_LDM_VAE_ATTN_MAP = {"norm": "group_norm", "q": "to_q", "k": "to_k", "v": "to_v", "proj_out": "to_out.0"}

# whole-prefix renames of the UNet's stems (LDM -> diffusers); label_emb is
# SDXL's text_time conditioning MLP
_LDM_UNET_PREFIXES = (
    ("time_embed.0.", "time_embedding.linear_1."),
    ("time_embed.2.", "time_embedding.linear_2."),
    ("out.0.", "conv_norm_out."),
    ("out.2.", "conv_out."),
    ("input_blocks.0.0.", "conv_in."),
    ("label_emb.0.0.", "add_embedding.linear_1."),
    ("label_emb.0.2.", "add_embedding.linear_2."),
)


def _ldm_res(rest: str) -> str:
    for src, dst in _LDM_RES_MAP.items():
        if rest.startswith(src + "."):
            return dst + rest[len(src):]
    return rest


def _ldm_unet_key(key: str, layers_per_block: int = 2) -> Optional[str]:
    """One ``model.diffusion_model.``-stripped LDM UNet key -> its diffusers
    key (params.py:282-342), or None for a key the UNet does not hold. LDM
    numbers the blocks of each side flat: ``input_blocks.i`` holds level
    (i - 1) // (layers_per_block + 1), its resnet at sub-module 0, its
    attention at 1, and the level's last slot the downsampler (``op``);
    ``output_blocks.i`` level i // (layers_per_block + 1), the upsampler
    (``conv``) after its last resnet and attention."""
    per = layers_per_block + 1  # the resnets and the sampler slot of a level
    for src, dst in _LDM_UNET_PREFIXES:
        if key.startswith(src):
            return dst + key[len(src):]
    parts = key.split(".")
    if parts[0] == "input_blocks":
        i, j, rest = int(parts[1]), int(parts[2]), ".".join(parts[3:])
        block, layer = (i - 1) // per, (i - 1) % per
        if rest.startswith("op."):
            return f"down_blocks.{block}.downsamplers.0.conv." + rest[len("op."):]
        if j == 0:
            return f"down_blocks.{block}.resnets.{layer}." + _ldm_res(rest)
        return f"down_blocks.{block}.attentions.{layer}." + rest
    if parts[0] == "middle_block":
        j, rest = int(parts[1]), ".".join(parts[2:])
        if j == 1:
            return "mid_block.attentions.0." + rest
        return f"mid_block.resnets.{j // 2}." + _ldm_res(rest)
    if parts[0] == "output_blocks":
        i, j, rest = int(parts[1]), int(parts[2]), ".".join(parts[3:])
        block, layer = i // per, i % per
        if j == 0:
            return f"up_blocks.{block}.resnets.{layer}." + _ldm_res(rest)
        if rest.startswith("conv."):  # the upsampler, the block's last sub-module
            return f"up_blocks.{block}.upsamplers.0." + rest
        return f"up_blocks.{block}.attentions.{layer}." + rest
    return None


def _ldm_vae_key(key: str, num_levels: int = 4) -> Optional[str]:
    """One ``first_stage_model.``-stripped LDM VAE key -> its diffusers key
    (params.py:345-380), or None. LDM numbers the decoder's levels
    high-resolution first, diffusers low-resolution first; ``nin_shortcut``
    is ``conv_shortcut``."""
    parts = key.split(".")
    if parts[0] in ("quant_conv", "post_quant_conv"):
        return key
    if parts[0] not in ("encoder", "decoder"):
        return None
    side = parts[0]

    def res(rest: str) -> str:
        return rest.replace("nin_shortcut", "conv_shortcut", 1)

    if parts[1] in ("conv_in", "conv_out"):
        return key
    if parts[1] == "norm_out":
        return f"{side}.conv_norm_out." + ".".join(parts[2:])
    if parts[1] == "mid":
        if parts[2] in ("block_1", "block_2"):
            return f"{side}.mid_block.resnets.{int(parts[2][-1]) - 1}." + res(".".join(parts[3:]))
        if parts[2] == "attn_1":
            return f"{side}.mid_block.attentions.0.{_LDM_VAE_ATTN_MAP[parts[3]]}." + ".".join(parts[4:])
    if parts[1] == "down" and side == "encoder":
        if parts[3] == "block":
            return f"encoder.down_blocks.{parts[2]}.resnets.{parts[4]}." + res(".".join(parts[5:]))
        if parts[3] == "downsample":
            return f"encoder.down_blocks.{parts[2]}.downsamplers.0." + ".".join(parts[4:])
    if parts[1] == "up" and side == "decoder":
        i = num_levels - 1 - int(parts[2])
        if parts[3] == "block":
            return f"decoder.up_blocks.{i}.resnets.{parts[4]}." + res(".".join(parts[5:]))
        if parts[3] == "upsample":
            return f"decoder.up_blocks.{i}.upsamplers.0." + ".".join(parts[4:])
    return None


def _tensor(v) -> torch.Tensor:
    """A checkpoint value as a torch tensor (numpy arrays are wrapped, not copied)."""
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))


def _unwrap(sd: Mapping) -> Mapping:
    """The weights of a torch .ckpt that wraps them in ``state_dict``."""
    if "state_dict" in sd and not hasattr(sd["state_dict"], "shape"):
        return sd["state_dict"]
    return sd


def _is_xl(sd: Mapping) -> bool:
    return any(k.startswith("conditioner.embedders.") for k in sd)


def _split_ldm(sd: Mapping, layers_per_block: int, vae_levels: int, text_prefixes: Tuple[str, str]):
    """(unet, vae, transformers-named text, OpenCLIP-named text) state dicts
    of an unwrapped LDM checkpoint; ``model_ema.*`` and unknown keys are
    skipped. The VAE mid block's q/k/v/proj_out, 1x1 convs in LDM, are
    squeezed to the linear layers' 2-D weights."""
    clip_prefix, open_clip_prefix = text_prefixes
    unet, vae, text, open_clip = OrderedDict(), OrderedDict(), OrderedDict(), OrderedDict()
    for k, v in sd.items():
        if k.startswith("model.diffusion_model."):
            nk = _ldm_unet_key(k[len("model.diffusion_model."):], layers_per_block)
            if nk is not None:
                unet[nk] = _tensor(v)
        elif k.startswith("first_stage_model."):
            nk = _ldm_vae_key(k[len("first_stage_model."):], vae_levels)
            if nk is not None:
                w = _tensor(v)
                if ".attentions.0.to_" in nk and w.dim() == 4:
                    w = w.reshape(w.shape[0], w.shape[1])
                vae[nk] = w
        elif k.startswith(clip_prefix):
            text[k[len(clip_prefix):]] = _tensor(v)
        elif k.startswith(open_clip_prefix):
            open_clip[k[len(open_clip_prefix):]] = v
    return unet, vae, text, open_clip


def convert_ldm_checkpoint(sd: Mapping[str, Any], layers_per_block: int = 2, vae_levels: int = 4):
    """An original single-file SD 1.x / 2.x checkpoint -> (unet, vae, text)
    state dicts under the port's (diffusers / transformers) names
    (params.py:383-445). A file that wraps its weights in ``state_dict`` is
    unwrapped, and ``model_ema.*`` is skipped. SD 1.x's CLIP tower
    (``cond_stage_model.transformer.*``) is in transformers' naming already.
    SD 2.x's OpenCLIP ViT-H tower (``cond_stage_model.model.*``) goes
    through :func:`convert_open_clip_text_state_dict`, and its last resblock
    and ``text_projection`` are dropped: SD 2.x conditions on the
    penultimate hidden state, which the 23-layer tower's last layer and
    ``final_layer_norm`` (``ln_final``) then give. Raises on a truncated
    OpenCLIP tower and on an SDXL-layout file."""
    sd = _unwrap(sd)
    if _is_xl(sd):
        raise ValueError("this is an SDXL-format single-file checkpoint; use convert_ldm_checkpoint_xl or "
                         "load_single_file_pipeline, which detects the layout")
    unet, vae, text, open_clip = _split_ldm(sd, layers_per_block, vae_levels,
                                            ("cond_stage_model.transformer.", "cond_stage_model.model."))
    if open_clip:
        text = convert_open_clip_text_state_dict(open_clip)
        layers = [int(k.split(".")[3]) for k in text if k.startswith("text_model.encoder.layers.")]
        if not layers:
            raise ValueError("cond_stage_model.model.* present but no transformer.resblocks.* layers found: a "
                             "truncated or non-text OpenCLIP state dict in an SD 2.x checkpoint")
        last = f"text_model.encoder.layers.{max(layers)}."
        text = OrderedDict((k, v) for k, v in text.items()
                           if not k.startswith(last) and k != "text_projection.weight")
    return unet, vae, text


def convert_open_clip_text_state_dict(sd: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """An OpenCLIP text tower (``transformer.resblocks.N.*``,
    ``token_embedding``, ``positional_embedding``, ``ln_final``,
    ``text_projection``) -> transformers' CLIPTextModel names
    (params.py:448-494). The packed ``attn.in_proj_{weight,bias}`` is split
    into q/k/v; ``text_projection``, applied by OpenCLIP as ``pooled @ P``,
    is transposed into the Linear weight (proj, width), unless the file
    stores it as ``text_projection.weight`` already. ``logit_scale`` and
    ``attn_mask`` are dropped."""
    leaves = {"attn.out_proj": "self_attn.out_proj", "ln_1": "layer_norm1", "ln_2": "layer_norm2",
              "mlp.c_fc": "mlp.fc1", "mlp.c_proj": "mlp.fc2"}
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for k, v in sd.items():
        w = _tensor(v)
        if k == "token_embedding.weight":
            out["text_model.embeddings.token_embedding.weight"] = w
        elif k == "positional_embedding":
            out["text_model.embeddings.position_embedding.weight"] = w
        elif k in ("ln_final.weight", "ln_final.bias"):
            out["text_model.final_layer_norm." + k.split(".")[1]] = w
        elif k == "text_projection":
            out["text_projection.weight"] = w.t()
        elif k == "text_projection.weight":  # exports that store an nn.Linear
            out["text_projection.weight"] = w
        elif k.startswith("transformer.resblocks."):
            parts = k.split(".")
            prefix, rest = f"text_model.encoder.layers.{parts[2]}.", ".".join(parts[3:])
            if rest in ("attn.in_proj_weight", "attn.in_proj_bias"):
                leaf = rest.rsplit("_", 1)[1]
                for name, part in zip("qkv", w.chunk(3, dim=0)):
                    out[prefix + f"self_attn.{name}_proj.{leaf}"] = part
            else:
                module, leaf = rest.rsplit(".", 1)
                if module in leaves:
                    out[prefix + f"{leaves[module]}.{leaf}"] = w
    return out


def convert_ldm_checkpoint_xl(sd: Mapping[str, Any], layers_per_block: int = 2, vae_levels: int = 4):
    """An original SDXL single-file checkpoint -> (unet, vae, text, text_2)
    state dicts (params.py:497-536): the UNet and VAE as in
    :func:`convert_ldm_checkpoint` plus ``label_emb`` (``add_embedding``),
    CLIP ViT-L under ``conditioner.embedders.0.transformer.`` (transformers'
    naming) and OpenCLIP bigG under ``conditioner.embedders.1.model.``
    (through :func:`convert_open_clip_text_state_dict`, every layer and its
    projection kept). Raises on a file that is not SDXL."""
    sd = _unwrap(sd)
    if not _is_xl(sd):
        raise ValueError("not an SDXL single-file checkpoint (no conditioner.embedders.*)")
    unet, vae, text, open_clip = _split_ldm(
        sd, layers_per_block, vae_levels, ("conditioner.embedders.0.transformer.", "conditioner.embedders.1.model."))
    return unet, vae, text, convert_open_clip_text_state_dict(open_clip)


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------

def _f32_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32).numpy()
    return np.asarray(v, np.float32)


def _resolve_underscore_path(name: str, module: nn.Module) -> Optional[str]:
    """A kohya underscore-joined module name resolved against ``module``'s
    own tree by a greedy longest-prefix walk of ``named_children`` at each
    level (params.py:604-621; no name table)."""
    path = []
    while name:
        children = dict(module.named_children())
        matches = [k for k in children if name == k or name.startswith(k + "_")]
        if not matches:
            return None
        k = max(matches, key=len)
        path.append(k)
        module = children[k]
        name = name[len(k):].lstrip("_")
    return ".".join(path)


def _lora_pairs(lora_state_dict: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """stem -> {"A": down, "B": up, "alpha": alpha} of a LoRA state dict
    (params.py:675-693): PEFT ``lora_A`` / ``lora_B``, ``lora.down`` /
    ``lora.up`` and kohya ``lora_down`` / ``lora_up``, under the prefixes
    ``unet.``, ``base_model.model.`` and ``lora_unet_``; text-encoder keys
    are skipped."""
    pairs: Dict[str, Dict[str, Any]] = {}
    for key, value in lora_state_dict.items():
        k = key
        if k.startswith(("text_encoder.", "text_encoder_2.", "lora_te")):
            continue
        for pre in ("unet.", "base_model.model.", "lora_unet_"):
            if k.startswith(pre):
                k = k[len(pre):]
        k = k.replace(".lora.down.", ".lora_A.").replace(".lora.up.", ".lora_B.")
        k = k.replace(".lora_down.", ".lora_A.").replace(".lora_up.", ".lora_B.")
        if ".lora_A." in k:
            stem, role = k.split(".lora_A.")[0], "A"
        elif ".lora_B." in k:
            stem, role = k.split(".lora_B.")[0], "B"
        elif k.endswith(".alpha"):
            stem, role = k[: -len(".alpha")], "alpha"
        else:
            continue
        pairs.setdefault(stem, {})[role] = value
    return pairs


def lora_deltas(unet: nn.Module, lora_state_dict: Mapping[str, Any], scale: float = 1.0) -> Dict[str, np.ndarray]:
    """The f32 weight updates ``scale * alpha / r * B @ A`` of a LoRA, by the
    name of the UNet weight each lands on, in that weight's layout (an
    (out, in) Linear, an (out, in, kh, kw) conv; 2-D factors on a 1x1 conv
    reshaped). ``alpha`` defaults to the rank r. Computed on the host in
    f32 as the JAX package computes them (params.py:695-714). Raises
    KeyError for a target the UNet does not hold."""
    deltas = {}
    for stem, d in _lora_pairs(lora_state_dict).items():
        if "A" not in d or "B" not in d:
            continue
        A, B = _f32_numpy(d["A"]), _f32_numpy(d["B"])  # (r, in[, kh, kw]), (out, r[, 1, 1])
        r = A.shape[0]
        alpha = float(d.get("alpha", r))
        path = stem if "." in stem else _resolve_underscore_path(stem, unet)
        try:
            weight = unet.get_submodule(path).weight if path is not None else None
        except AttributeError:
            weight = None
        if weight is None:
            raise KeyError(f"LoRA target not found in the UNet: {stem}")
        if A.ndim == 4:  # conv LoRA: A (r, in, kh, kw), B (out, r, 1, 1)
            delta = (B.reshape(B.shape[0], -1) @ A.reshape(r, -1)) * (scale * alpha / r)
            delta = delta.reshape(B.shape[0], *A.shape[1:])
        else:
            delta = (B @ A) * (scale * alpha / r)
            if weight.dim() == 4:  # 2-D factors on a 1x1 conv
                delta = delta.reshape(*delta.shape, 1, 1)
        deltas[f"{path}.weight"] = delta
    return deltas


def merge_lora(unet: nn.Module, lora_state_dict: Mapping[str, Any], scale: float = 1.0) -> nn.Module:
    """A LoRA merged into a copy of ``unet`` (params.py:643-715): a new
    module of the same class and config whose target weights are
    ``W + cast(scale * alpha / r * B @ A)`` (the f32 update of
    :func:`lora_deltas` cast to W's dtype, then added in that dtype on W's
    device, as the JAX package rounds) and whose every other tensor IS the
    caller's (shared, not copied). The caller's module and tensors are never
    written. Keys: PEFT ``lora_A/lora_B``, ``lora.down/up``, kohya
    ``lora_down/up`` (underscore stems resolved against the module tree),
    prefixes ``unet.`` / ``base_model.model.`` / ``lora_unet_``, optional
    per-module ``.alpha``; text-encoder keys are skipped. Merging is exact
    at inference and leaves the kernels' path as it is."""
    merged = OrderedDict(unet.state_dict())
    for name, delta in lora_deltas(unet, lora_state_dict, scale).items():
        w = merged[name]
        merged[name] = w + torch.from_numpy(delta).to(device=w.device, dtype=w.dtype)
    with torch.device("meta"):
        out = type(unet)(unet.config, dtype=getattr(unet, "dtype", torch.float32))
    out.load_state_dict(merged, strict=True, assign=True)
    return out.eval()


# ---------------------------------------------------------------------------
# textual inversion
# ---------------------------------------------------------------------------

def _read_embedding_file(path: str) -> Mapping:
    if path.endswith(".safetensors"):
        from aid_tpu_torch.utils.safetensors import load_safetensors

        return load_safetensors(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def textual_inversion_embedding(checkpoint, token: Optional[str] = None) -> Tuple[str, torch.Tensor]:
    """(placeholder token, (n, dim) embedding) of a textual-inversion file
    or dict (params.py:718-752): the diffusers ``{token: (n, dim)}``, A1111's
    ``string_to_param["*"]`` with its ``name``, civitai's ``emb_params``, or
    one tensor under any key. ``checkpoint`` may be a path to a
    ``.safetensors`` file (or a torch ``.pt`` / ``.bin``, read with
    ``weights_only``); the file's name is then the placeholder where the
    file names none. An explicit ``token`` wins."""
    name_hint = None
    if isinstance(checkpoint, (str, os.PathLike)):
        checkpoint = os.fspath(checkpoint)
        name_hint = os.path.splitext(os.path.basename(checkpoint))[0]
        checkpoint = _read_embedding_file(checkpoint)
    if "string_to_param" in checkpoint:  # A1111 .pt
        embedding = checkpoint["string_to_param"]["*"]
        token = token or checkpoint.get("name", name_hint or "<concept>")
    elif "emb_params" in checkpoint:  # A1111 / civitai .safetensors
        embedding = checkpoint["emb_params"]
        token = token or name_hint or "<concept>"
    elif token is not None and token in checkpoint:
        embedding = checkpoint[token]
    elif len(checkpoint) == 1:
        only_key = next(iter(checkpoint))
        embedding = checkpoint[only_key]
        token = token or name_hint or only_key
    else:
        token = token or next(iter(checkpoint))
        embedding = checkpoint[token]
    embedding = _tensor(embedding)
    return token, embedding[None] if embedding.dim() == 1 else embedding


@torch.no_grad()
def load_textual_inversion(text_encoder: nn.Module, tokenizer, checkpoint, token: Optional[str] = None) -> int:
    """Add a textual-inversion embedding to ``text_encoder`` (a
    ``CLIPTextModel``) and ``tokenizer`` (params.py:718-765): the token
    table grows by the embedding's n rows on its own device and in its own
    dtype (a new tensor; the old one is not written), the config's
    ``vocab_size`` with it, and the placeholder maps to the new ids through
    ``tokenizer.add_tokens``. Returns n."""
    token, embedding = textual_inversion_embedding(checkpoint, token)
    table = text_encoder.text_model.embeddings.token_embedding
    old = table.weight
    new_ids = list(range(old.shape[0], old.shape[0] + embedding.shape[0]))
    table.weight = nn.Parameter(torch.cat([old, embedding.to(device=old.device, dtype=old.dtype)]),
                                requires_grad=False)
    table.num_embeddings = table.weight.shape[0]
    text_encoder.config = dataclasses.replace(text_encoder.config, vocab_size=table.num_embeddings)
    tokenizer.add_tokens(token, new_ids)
    return len(new_ids)
