"""The port's VAE (decode in f32 and bf16, tiled decode, encode) and its
D=512 attention in f32 and bf16 against aid_tpu's.

TINY_VAE on the CPU, the same perturbed flax init on both sides through
``vae_state_dict_from_flax``; latents, images and noise made with numpy.
The bf16 side runs the JAX module with ``dtype=bfloat16`` against the port's
module cast to bf16. The VAE attention's plain versions are held against the
JAX Pallas kernel in interpret mode at the VAE's head dim (512) and a
reduced sequence, as
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
from aid_tpu_torch.ops.flash_attention import flash_self_attention_bf16, flash_self_attention_f32
from aid_tpu_torch.pipelines import engine

# f32 decode on both sides; GroupNorm statistics (flax one-pass vs torch
# two-pass), conv and matmul sums run in other orders: a few 1e-6 of max
# |ref| over ~20 layers. 1e-4 catches a wrong epsilon, upsample, shortcut
# or attention scale (each >= 1e-3 here).
DECODE_TOL = 1e-4
# The interpret-mode Pallas kernel is an online (tiled) softmax: its f32
# rescaling chain rounds differently from one softmax, ~1e-6 of max |ref|.
FLASH_TOL = 1e-4
# bf16 decode and encode, both sides computing every layer in bf16 from the
# same weights: each conv, norm and matmul output rounds to bf16 (2^-9
# relative) at other points in XLA's fused CPU code than in torch's per-op
# kernels, compounding over the ~20 layers of TINY_VAE. Measured: decode
# 1.5e-2, encode 1.8e-2 of max |ref|, tiled decode_latents 2.2e-2 absolute
# on [0, 1]; an f32 decode sits 1.0e-2 from the JAX bf16 one. 5e-2 holds
# those, and a doubled attention logit scale (2.0e-1) fails it. Faults
# finer than bf16's own noise are the f32 tests' to find (the same modules
# at 1e-4); the dtype assertions find a decode left in f32.
BF16_DECODE_TOL = 5e-2
# bf16 D=512 attention: both round the probabilities to bf16 before P V,
# the Pallas kernel unnormalised per tile, the plain version normalised;
# with the output's own bf16 rounding that is a few 2^-9 of max |ref|
# (measured 5.8e-3 at S=512, 3.6e-3 at 300). 2e-2, as the other bf16
# attention tests.
BF16_FLASH_TOL = 2e-2


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
    """convert_vae_state_dict(port.state_dict()) is the JAX tree (encoder,
    decoder, quant_conv, post_quant_conv), leaf for leaf, but for one level:
    the JAX converter keeps diffusers' ``upsamplers.0.conv`` and
    ``downsamplers.0.conv`` modules, which the JAX VAE's bare sampler Convs
    do not have (a trap of the reference, ROADMAP Queue 3), so that level is
    dropped here before comparing."""
    _, _, params, vae = vaes
    back = convert_vae_state_dict(vae.state_dict())
    for part in ("encoder", "decoder"):
        for name, node in back["params"][part].items():
            if name.endswith(("_upsamplers_0", "_downsamplers_0")):
                back["params"][part][name] = node.pop("conv")
    want = jax.tree_util.tree_flatten_with_path(params)[0]
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


def _bf16_vaes(vaes):
    """(JAX bf16 VAE, the port's VAE cast to bf16 in place on a copy)."""
    cfg, _, params, vae = vaes
    port = AutoencoderKL(cfg)
    port.load_state_dict(vae.state_dict(), strict=True)
    return JaxVAE(cfg, dtype=jnp.bfloat16), port.eval().to(torch.bfloat16)


def test_vae_bf16_decode_matches_jax(vaes):
    """The bf16 decoder (what enable_bf16_vae_decode runs) against the JAX
    AutoencoderKL(dtype=bfloat16) from the same f32 latents."""
    cfg, _, params, _ = vaes
    jvae, vae = _bf16_vaes(vaes)
    z = th.normal(3, (2, 8, 8, cfg.latent_channels))
    want = jvae.apply(th.to_jnp(params), jnp.asarray(z), method="decode")
    with torch.no_grad():
        got = vae.decode(th.nhwc_to_nchw(z))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert th.max_rel_err(th.nchw_to_nhwc(got.float()), np.asarray(want, np.float32)) < BF16_DECODE_TOL


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_vae_encode_mean_matches_jax(vaes, dtype):
    """encode() without sampling: the posterior mean, through the encoder
    (asymmetric-pad stride-2 downsamplers, mid block) and quant_conv."""
    cfg, jvae, params, vae = vaes
    tol = DECODE_TOL
    if dtype == "bf16":
        jvae, vae = _bf16_vaes(vaes)
        tol = BF16_DECODE_TOL
    x = th.normal(4, (2, 16, 16, cfg.in_channels), scale=0.5)
    want = jvae.apply(th.to_jnp(params), jnp.asarray(x), method="encode")
    with torch.no_grad():
        got = vae.encode(th.nhwc_to_nchw(x))
    assert tuple(got.shape) == (2, cfg.latent_channels, 8, 8)
    assert th.max_rel_err(th.nchw_to_nhwc(got.float()), np.asarray(want, np.float32)) < tol


def test_vae_encode_sample_matches_jax_formula(vaes):
    """encode(sample=True) = mean + exp(0.5 * clip(logvar, -30, 20)) * eps:
    the JAX formula checked on JAX's own draw, then the port's result
    against that formula on the JAX moments with the eps the port's
    generator draws (the two packages draw different numbers from a seed)."""
    cfg, jvae, params, vae = vaes
    x = th.normal(5, (2, 16, 16, cfg.in_channels), scale=0.5)
    jp = th.to_jnp(params)
    moments = jvae.apply(jp, jnp.asarray(x), method=lambda m, a: m.quant_conv(m.encoder(a)))
    mean, logvar = np.split(np.asarray(moments), 2, axis=-1)
    logvar = logvar * 40.0  # reach both clip edges
    std = np.exp(0.5 * np.clip(logvar, -30.0, 20.0))
    key = jax.random.PRNGKey(6)
    jax_sample = jvae.apply(jp, jnp.asarray(x), rng=key, sample=True, method="encode")
    jax_eps = np.asarray(jax.random.normal(key, mean.shape, jnp.float32))
    np.testing.assert_allclose(np.asarray(jax_sample), mean + np.exp(0.5 * np.clip(np.split(
        np.asarray(moments), 2, axis=-1)[1], -30.0, 20.0)) * jax_eps, rtol=1e-5, atol=1e-6)

    with torch.no_grad():  # the same logvar scaling on the port's side
        vae.quant_conv.weight[cfg.latent_channels:] *= 40.0
        vae.quant_conv.bias[cfg.latent_channels:] *= 40.0
        try:
            got = vae.encode(th.nhwc_to_nchw(x), generator=torch.Generator().manual_seed(7), sample=True)
        finally:
            vae.quant_conv.weight[cfg.latent_channels:] /= 40.0
            vae.quant_conv.bias[cfg.latent_channels:] /= 40.0
    eps = torch.randn(got.shape, generator=torch.Generator().manual_seed(7))
    want = mean + std * th.nchw_to_nhwc(eps)
    assert th.max_rel_err(th.nchw_to_nhwc(got), want) < DECODE_TOL


@pytest.mark.parametrize("tl", [5, 12], ids=["tl5_3x3_tiles", "tl12_one_tile"])
def test_tiled_decode_matches_jax(vaes, tl):
    """tiled_decode on 8x8 latents: tl=5 (tl % 4 != 0: stride 3, a 3x3 grid,
    a 2-pixel blend at f=2) and tl=12 (one tile, edge-padded past the
    latent and cropped back); both against the JAX tiled_decode."""
    cfg, jvae, params, vae = vaes
    z = th.normal(8, (2, 8, 8, cfg.latent_channels))
    want = jax_engine.tiled_decode(jvae, th.to_jnp(params), jnp.asarray(z), tile_latent_size=tl)
    got = engine.tiled_decode(vae, th.nhwc_to_nchw(z), tile_latent_size=tl)
    assert tuple(got.shape) == (2, cfg.out_channels, 16, 16)
    assert th.max_rel_err(th.nchw_to_nhwc(got), np.asarray(want)) < DECODE_TOL


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_latents_tiled_matches_jax(vaes, dtype):
    """decode_latents with tile_latent_size (the pipelines' VAE tiling), per
    frame, in the VAE's dtype; the output is f32 in [0, 1]."""
    cfg, jvae, params, vae = vaes
    tol = DECODE_TOL
    if dtype == "bf16":
        jvae, vae = _bf16_vaes(vaes)
        tol = BF16_DECODE_TOL
    z = th.normal(9, (2, 8, 8, cfg.latent_channels), scale=0.3)
    want = jax_engine.decode_latents(jvae, th.to_jnp(params), jnp.asarray(z), cfg.scaling_factor, per_frame=True,
                                     tile_latent_size=6)
    got = engine.decode_latents(vae, th.nhwc_to_nchw(z), cfg.scaling_factor, per_frame=True, tile_latent_size=6)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), rtol=0, atol=tol)


@pytest.mark.parametrize("S", [512, 300])
def test_vae_attention_bf16_d512_matches_pallas_interpret(S):
    """The bf16 D=512 self contract (a bf16 VAE's mid block): the wrapper's
    CPU route, and dispatch_attention as the VAE calls it, against the Pallas
    kernel in interpret mode on the same bf16 inputs; S=300 is ragged."""
    q, k, v = (th.normal(40 + i, (1, 1, S, 512)) for i in range(3))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (tq, tk, tv))
    coef = np.zeros((1,), np.float32)
    want = jax_flash(jq, jk, jv, jnp.asarray(coef), "self", interpret=True)
    got = flash_self_attention_bf16(tq, tk, tv)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert th.max_rel_err(got.float().numpy(), np.asarray(want, np.float32)) < BF16_FLASH_TOL
    via_dispatch = dispatch_attention(tq, tk, tv, torch.from_numpy(coef), "self")
    torch.testing.assert_close(via_dispatch, got, rtol=0, atol=0)
