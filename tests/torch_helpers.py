"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Both packages see the same inputs: arrays are made with numpy from a seed
and handed to JAX and to torch; weights come from the JAX package's own init
(perturbed, so biases and norm affines are not trivially 0/1) and reach the
port through ``unet_state_dict_from_flax``. Everything runs in f32 on the CPU.
Layouts differ: ``aid_tpu`` is NHWC, the port NCHW; transpose only here.
"""

from __future__ import annotations

import copy
import dataclasses

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


def port_unet(cfg, params, dtype=torch.float32):
    """The port's UNet2DCondition (CPU, in ``dtype``: f32 by default) loaded
    strictly from JAX params, each leaf rounded once from its f32 value."""
    from aid_tpu_torch.models.params import unet_state_dict_from_flax
    from aid_tpu_torch.models.unet import UNet2DCondition

    unet = UNet2DCondition(cfg, dtype=dtype)
    unet.load_state_dict(unet_state_dict_from_flax(params, dtype), strict=True)
    return unet.eval()


def to_jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def to_torch(d):
    return None if d is None else {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


# The bf16 decode's uint8 frames: bf16 decoders on both sides agree to ~2e-2
# of the [0, 1] range (tests/test_torch_vae.py, BF16_DECODE_TOL 5e-2), so a
# frame may differ by a few uint8 steps; 0.05 * 255 = 12 steps.
BF16_UINT8_STEPS = 12


def with_pipeline_option(jax_pipe, pipe, option):
    """Copies of both pipelines with one option on (enable_bf16_vae_decode
    casts the VAE in place, so the port's copy gets its own VAE)."""
    jax_pipe = dataclasses.replace(jax_pipe)
    pipe = dataclasses.replace(pipe, vae=copy.deepcopy(pipe.vae))
    if option == "bf16_vae":
        jax_pipe.enable_bf16_vae_decode(), pipe.enable_bf16_vae_decode()
        assert all(p.dtype == torch.bfloat16 for p in pipe.vae.parameters())
    elif option == "vae_tiling":
        jax_pipe.enable_vae_tiling(6), pipe.enable_vae_tiling(6)  # 2 x 2 tiles of 6 at 8x8 latents
        assert pipe.vae_tile_latent_size == 6
    else:
        jax_pipe.cfg_mode = pipe.cfg_mode = "batched"
    return jax_pipe, pipe


def seed_module(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every parameter of ``module`` from numpy's seeded normal: tensors of
    rank >= 2 scaled by 1/sqrt(fan-in), norm scales 1 + 0.1 n, other vectors
    0.1 n. The port's ``state_dict()`` then feeds the JAX converters, so both
    packages hold the same weights."""
    r = rng(seed)
    norms = (torch.nn.LayerNorm, torch.nn.GroupNorm)
    norm_scales = {f"{n}.weight" for n, m in module.named_modules() if isinstance(m, norms)}
    with torch.no_grad():
        for name, p in module.named_parameters():
            n = r.standard_normal(tuple(p.shape))
            if p.dim() >= 2:
                n = n / np.sqrt(np.prod(p.shape[1:]))
            else:
                n = 1.0 + 0.1 * n if name in norm_scales else 0.1 * n
            p.copy_(torch.from_numpy(n.astype(np.float32)))
    return module.eval()


def numpy_state_dict(module: torch.nn.Module) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}
