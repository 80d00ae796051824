"""Parameter conversion between the JAX package's flax trees and the port's modules.

``unet_state_dict_from_flax`` inverts ``aid_tpu.models.params``'s
``_convert_leaf`` and ``_torch_path_to_flax`` (params.py:45-100): it takes a
UNet2DCondition parameter tree (nested dicts of numpy arrays, with or without
the top-level ``"params"`` key) and returns the diffusers-named
``state_dict`` that ``aid_tpu_torch.models.UNet2DCondition`` loads with
``strict=True``. Diffusers checkpoints need no conversion at all: the port's
modules carry diffusers names and layouts.
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


def unet_state_dict_from_flax(tree: Dict) -> "OrderedDict[str, torch.Tensor]":
    """JAX UNet2DCondition params (numpy leaves) -> the port's state_dict."""
    if "params" in tree:
        tree = tree["params"]
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def walk(node, prefix):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, prefix + [_unfold(key)])
            else:
                name, w = _leaf_to_torch(key, np.asarray(value))
                out[".".join(prefix + [name])] = torch.tensor(w)  # a copy: the input may be read-only

    walk(tree, [])
    return out
