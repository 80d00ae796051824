"""Parameter conversion between the JAX package's flax trees and the port's modules.

Each ``*_state_dict_from_flax`` takes a parameter tree of the JAX package
(nested dicts of numpy arrays, with or without the top-level ``"params"``
key) and returns the ``state_dict`` that the port's module loads with
``strict=True``: it inverts ``aid_tpu.models.params``'s ``_convert_leaf``
and ``_torch_path_to_flax`` (params.py:45-100) and the per-model renames of
``convert_vae_state_dict`` and ``convert_clip_text_state_dict``
(params.py:139-162). Diffusers and transformers checkpoints need no
conversion at all: the port's modules carry their names and layouts.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict

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


def _state_dict(tree: Dict, unfold, skip=()) -> "OrderedDict[str, torch.Tensor]":
    """Walk a flax tree; ``unfold(name, depth)`` gives each module name's dotted path."""
    if "params" in tree:
        tree = tree["params"]
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def walk(node, prefix):
        for key, value in node.items():
            if isinstance(value, dict):
                if prefix or key not in skip:
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
    # the VAE's upsampler is a bare flax Conv; diffusers wraps it as upsamplers.0.conv
    (re.compile(r"^up_blocks_(\d+)_upsamplers_0$"), r"up_blocks.\1.upsamplers.0.conv"),
    # nested mid block (params.py:139-152): mid_block/resnets_0 -> mid_block.resnets.0
    (re.compile(r"^(resnets|attentions)_(\d+)$"), r"\1.\2"),
)


def vae_state_dict_from_flax(tree: Dict) -> "OrderedDict[str, torch.Tensor]":
    """JAX AutoencoderKL params -> the port's (decode-side) AutoencoderKL
    state_dict. The encoder and ``quant_conv`` are dropped: the port has no
    encoder yet."""

    def unfold(key, depth):
        for pattern, repl in _VAE_UNFOLD:
            if pattern.match(key):
                return pattern.sub(repl, key)
        return _unfold(key)

    return _state_dict(tree, unfold, skip=("encoder", "quant_conv"))


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
