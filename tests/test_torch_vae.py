"""The port's VAE decode and its f32 D=512 attention against aid_tpu's.

TINY_VAE, f32 on the CPU, the same perturbed flax init on both sides
through ``vae_state_dict_from_flax``; latents made with numpy. The VAE
attention's plain version is held against the JAX Pallas kernel in
interpret mode at the VAE's head dim (512) and a reduced sequence, as
tests/test_flash_attention.py::test_vae_wide_head_shape_numerics runs it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_helpers as th
from aid_tpu.models.params import convert_vae_state_dict
from aid_tpu.models.vae import AutoencoderKL as JaxVAE
from aid_tpu.ops.flash_attention import flash_interpolated_attention as jax_flash
from aid_tpu.pipelines import engine as jax_engine
from aid_tpu_torch.models import configs
from aid_tpu_torch.models.params import vae_state_dict_from_flax
from aid_tpu_torch.models.vae import AutoencoderKL
from aid_tpu_torch.ops.attention import dispatch_attention
from aid_tpu_torch.ops.flash_attention import flash_self_attention_f32
from aid_tpu_torch.pipelines import engine

# f32 decode on both sides; GroupNorm statistics (flax one-pass vs torch
# two-pass), conv and matmul sums run in other orders: a few 1e-6 of max
# |ref| over ~20 layers. 1e-4 catches a wrong epsilon, upsample, shortcut
# or attention scale (each >= 1e-3 here).
DECODE_TOL = 1e-4
# The interpret-mode Pallas kernel is an online (tiled) softmax: its f32
# rescaling chain rounds differently from one softmax, ~1e-6 of max |ref|.
FLASH_TOL = 1e-4


@pytest.fixture(scope="module")
def vaes():
    cfg = configs.TINY_VAE
    jvae = JaxVAE(cfg)
    params = jvae.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    noise = th.rng(5)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + (noise.standard_normal(a.shape) * 0.05).astype(np.float32), params)
    vae = AutoencoderKL(cfg)
    vae.load_state_dict(vae_state_dict_from_flax(params), strict=True)
    return cfg, jvae, params, vae.eval()


def test_vae_decode_matches_jax(vaes):
    cfg, jvae, params, vae = vaes
    z = th.normal(1, (2, 8, 8, cfg.latent_channels))
    want = jvae.apply(th.to_jnp(params), jnp.asarray(z), method="decode")
    with torch.no_grad():
        got = vae.decode(th.nhwc_to_nchw(z))
    assert tuple(got.shape) == (2, cfg.out_channels, 16, 16)
    assert th.max_rel_err(th.nchw_to_nhwc(got), np.asarray(want)) < DECODE_TOL


def test_vae_state_dict_round_trip(vaes):
    """convert_vae_state_dict(port.state_dict()) is the JAX tree's decode
    side (decoder + post_quant_conv), leaf for leaf, but for one level: the
    JAX converter keeps diffusers' ``upsamplers.0.conv`` module, which the
    JAX VAE's bare upsampler Conv does not have (a trap of the reference,
    ROADMAP Queue 3), so that level is dropped here before comparing."""
    _, _, params, vae = vaes
    back = convert_vae_state_dict(vae.state_dict())
    for name, node in back["params"]["decoder"].items():
        if name.endswith("_upsamplers_0"):
            back["params"]["decoder"][name] = node.pop("conv")
    want = [(p, leaf) for p, leaf in jax.tree_util.tree_flatten_with_path(params)[0]
            if p[1].key in ("decoder", "post_quant_conv")]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("per_frame", [False, True])
@pytest.mark.parametrize("denorm", [False, True])
def test_decode_latents_and_uint8_match_jax(vaes, per_frame, denorm):
    """The engine's decode: scaling (or mean/std denormalisation), per-frame
    decode, the [0, 1] clip and the uint8 rounding."""
    cfg, jvae, params, vae = vaes
    if denorm:
        cfg = dataclasses.replace(cfg, latents_mean=(0.1, -0.2, 0.3, 0.0), latents_std=(2.0, 1.5, 0.5, 1.0))
    z = th.normal(2, (3, 8, 8, cfg.latent_channels), scale=0.3)
    want = jax_engine.decode_latents(jvae, th.to_jnp(params), jnp.asarray(z), cfg.scaling_factor,
                                     latents_mean=cfg.latents_mean, latents_std=cfg.latents_std, per_frame=per_frame)
    got = engine.decode_latents(vae, th.nhwc_to_nchw(z), cfg.scaling_factor, latents_mean=cfg.latents_mean,
                                latents_std=cfg.latents_std, per_frame=per_frame)
    assert tuple(got.shape) == (3, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=DECODE_TOL)
    got8, want8 = engine.to_uint8(got), jax_engine.to_uint8(want)
    assert got8.dtype == np.uint8 and got8.shape == want8.shape
    # values within DECODE_TOL of a rounding boundary may land one step apart
    assert np.abs(got8.astype(int) - want8.astype(int)).max() <= 1


@pytest.mark.parametrize("S", [1024, 1000])
def test_vae_attention_d512_matches_pallas_interpret(S):
    """The f32 D=512 self contract (what the VAE mid block sends): the
    wrapper's CPU route, and dispatch_attention as the VAE calls it, against
    the Pallas kernel in interpret mode; S=1000 is not a multiple of any tile."""
    q, k, v = (th.normal(30 + i, (1, 1, S, 512)) for i in range(3))
    coef = np.zeros((1,), np.float32)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(coef), "self", interpret=True)
    got = flash_self_attention_f32(*map(torch.from_numpy, (q, k, v)))
    assert got.dtype == torch.float32
    assert th.max_rel_err(got.numpy(), np.asarray(want)) < FLASH_TOL
    via_dispatch = dispatch_attention(*map(torch.from_numpy, (q, k, v)), torch.from_numpy(coef), "self")
    torch.testing.assert_close(via_dispatch, got, rtol=0, atol=0)
