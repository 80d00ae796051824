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
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, List, Mapping

import numpy as np
import torch

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


def _state_dict(tree: Dict, unfold) -> "OrderedDict[str, torch.Tensor]":
    """Walk a flax tree; ``unfold(name, depth)`` gives each module name's dotted path."""
    if "params" in tree:
        tree = tree["params"]
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def walk(node, prefix):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, prefix + [unfold(key, len(prefix))])
            else:
                name, w = _leaf_to_torch(key, np.asarray(value))
                out[".".join(prefix + [name])] = torch.tensor(w)  # a copy: the input may be read-only

    walk(tree, [])
    return out


def unet_state_dict_from_flax(tree: Dict) -> "OrderedDict[str, torch.Tensor]":
    """JAX UNet2DCondition params (numpy leaves) -> the port's state_dict."""
    return _state_dict(tree, lambda key, depth: _unfold(key))


_VAE_UNFOLD = (
    # the VAE's up- and downsamplers are bare flax Convs; diffusers wraps
    # them as upsamplers.0.conv / downsamplers.0.conv
    (re.compile(r"^(up|down)_blocks_(\d+)_(up|down)samplers_0$"), r"\1_blocks.\2.\3samplers.0.conv"),
    # nested mid block (params.py:139-152): mid_block/resnets_0 -> mid_block.resnets.0
    (re.compile(r"^(resnets|attentions)_(\d+)$"), r"\1.\2"),
)


def vae_state_dict_from_flax(tree: Dict) -> "OrderedDict[str, torch.Tensor]":
    """JAX AutoencoderKL params (encoder, decoder, ``quant_conv``,
    ``post_quant_conv``) -> the port's AutoencoderKL state_dict."""

    def unfold(key, depth):
        for pattern, repl in _VAE_UNFOLD:
            if pattern.match(key):
                return pattern.sub(repl, key)
        return _unfold(key)

    return _state_dict(tree, unfold)


_CLIP_TOP = {
    "token_embedding": "text_model.embeddings.token_embedding",
    "position_embedding": "text_model.embeddings.position_embedding",
    "final_layer_norm": "text_model.final_layer_norm",
}


def clip_text_state_dict_from_flax(tree: Dict) -> "OrderedDict[str, torch.Tensor]":
    """JAX CLIPTextModel params -> the port's CLIPTextModel state_dict
    (transformers names; ``text_projection`` when the config has one)."""

    def unfold(key, depth):
        if depth == 0:
            m = re.match(r"^layers_(\d+)$", key)
            return f"text_model.encoder.layers.{m.group(1)}" if m else _CLIP_TOP.get(key, key)
        m = re.match(r"^mlp_(fc[12])$", key)
        return f"mlp.{m.group(1)}" if m else key

    return _state_dict(tree, unfold)


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
