"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Both packages see the same inputs: arrays are made with numpy from a seed
and handed to JAX and to torch; weights come from the JAX package's own init
(perturbed, so biases and norm affines are not trivially 0/1) and reach the
port through ``unet_state_dict_from_flax``. Everything runs in f32 on the CPU.
Layouts differ: ``aid_tpu`` is NHWC, the port NCHW; transpose only here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

# The tier-1 run uses several xdist workers on a shared machine: keep each
# worker's torch to a couple of intra-op threads.
torch.set_num_threads(2)


def rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def normal(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (rng(seed).standard_normal(shape) * scale).astype(np.float32)


def nhwc_to_nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nchw_to_nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().transpose(0, 2, 3, 1)


def max_rel_err(got, want) -> float:
    """max |got - want| / max |want|: the error measure every parity test states."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def sdxl_added_cond(cfg, frames: int, seed: int):
    """(numpy) SDXL micro-conditioning: pooled text embeds + 1024px time_ids."""
    if cfg.addition_embed_type != "text_time":
        return None
    pooled = cfg.projection_class_embeddings_input_dim - 6 * cfg.addition_time_embed_dim
    return {
        "text_embeds": normal(seed, (frames, pooled)),
        "time_ids": np.tile(np.array([[1024.0, 1024.0, 0.0, 0.0, 1024.0, 1024.0]], np.float32), (frames, 1)),
    }


def jax_unet_and_params(cfg, seed: int = 0, perturb: float = 0.05):
    """The JAX UNet2DCondition for ``cfg`` and its params (numpy leaves):
    the flax init plus seeded N(0, perturb) noise on every leaf."""
    from aid_tpu.models import UNet2DCondition as JaxUNet

    model = JaxUNet(cfg)
    s = cfg.sample_size
    added = sdxl_added_cond(cfg, 1, seed)
    params = model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, s, s, cfg.in_channels)), jnp.array(0),
        jnp.zeros((1, 77, cfg.cross_attention_dim)), None,
        None if added is None else {k: jnp.asarray(v) for k, v in added.items()})
    noise = rng(seed + 1000)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + (noise.standard_normal(a.shape) * perturb).astype(np.float32),
        params)
    return model, params


def port_unet(cfg, params):
    """The port's UNet2DCondition (f32, CPU) loaded strictly from JAX params."""
    from aid_tpu_torch.models.params import unet_state_dict_from_flax
    from aid_tpu_torch.models.unet import UNet2DCondition

    unet = UNet2DCondition(cfg)
    unet.load_state_dict(unet_state_dict_from_flax(params), strict=True)
    return unet.eval()


def to_jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def to_torch(d):
    return None if d is None else {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
