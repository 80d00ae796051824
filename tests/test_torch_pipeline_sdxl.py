"""The port's SDXL ``interpolate`` against aid_tpu's: prompts in, frames out.

The JAX pipeline is built as tests/test_sdxl_ip.py::xl_pipe builds it (tiny
SDXL UNet whose cross-attention width is the two tiny text encoders'
widths together, TINY_VAE, HashTokenizers), with Euler; every module's
weights are its perturbed flax init, loaded into the port's modules through
the ``*_state_dict_from_flax`` converters. Both pipelines start from the
same numpy latents. f32 on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_helpers as th
from aid_tpu.models import AutoencoderKL as JaxVAE
from aid_tpu.models import CLIPTextModel as JaxCLIP
from aid_tpu.pipelines.sdxl import InterpolationXLPipeline as JaxXLPipeline
from aid_tpu.schedulers.euler import EulerDiscreteScheduler as JaxEuler
from aid_tpu.utils.tokenizer import HashTokenizer as JaxHashTokenizer
from aid_tpu_torch.models import configs
from aid_tpu_torch.models.clip import CLIPTextModel
from aid_tpu_torch.models.params import clip_text_state_dict_from_flax, vae_state_dict_from_flax
from aid_tpu_torch.models.vae import AutoencoderKL
from aid_tpu_torch.pipelines.sdxl import InterpolationXLPipeline
from aid_tpu_torch.schedulers.euler import EulerDiscreteScheduler
from aid_tpu_torch.utils.tokenizer import HashTokenizer

TEXT2_CFG = dataclasses.replace(configs.TINY_CLIP_TEXT, hidden_size=24, intermediate_size=48, projection_dim=24)
UNET_CFG = dataclasses.replace(configs.TINY_SDXL_UNET,
                               cross_attention_dim=configs.TINY_CLIP_TEXT.hidden_size + TEXT2_CFG.hidden_size)

# f32 over 2 steps x 2 UNet passes, after two text encoders: the per-forward
# ~1e-6 relative difference (test_torch_models.py) compounds through the
# guidance (x5) and the Euler updates; 1e-4 of max |ref| holds that with
# margin and fails on any real fault (a wrong hidden-state layer, pooled
# source, time_ids or lerp point moves the latents by >= 1e-3).
SLICE_TOL = 1e-4


def _perturbed(params, seed):
    noise = th.rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + (noise.standard_normal(a.shape) * 0.05).astype(np.float32), params)


@pytest.fixture(scope="module")
def pipes():
    from aid_tpu.models import configs as jax_configs

    jax_unet, unet_params = th.jax_unet_and_params(UNET_CFG, seed=3)
    jvae = JaxVAE(configs.TINY_VAE)
    vae_params = _perturbed(jvae.init(jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3))), 11)
    encoders = []
    for i, cfg in enumerate((configs.TINY_CLIP_TEXT, TEXT2_CFG)):
        jtext = JaxCLIP(jax_configs.CLIPTextConfig(**dataclasses.asdict(cfg)))
        params = _perturbed(jtext.init(jax.random.PRNGKey(2 + i), jnp.zeros((1, 77), jnp.int32)), 12 + i)
        text = CLIPTextModel(cfg)
        text.load_state_dict(clip_text_state_dict_from_flax(params), strict=True)
        encoders.append((jtext, params, text.eval()))
    (jt1, tp1, t1), (jt2, tp2, t2) = encoders

    jax_pipe = JaxXLPipeline(
        unet=jax_unet, unet_params=th.to_jnp(unet_params), vae=jvae, vae_params=th.to_jnp(vae_params),
        text_encoder=jt1, text_params=th.to_jnp(tp1), tokenizer=JaxHashTokenizer(configs.TINY_CLIP_TEXT.vocab_size),
        text_encoder_2=jt2, text_params_2=th.to_jnp(tp2), tokenizer_2=JaxHashTokenizer(TEXT2_CFG.vocab_size),
        scheduler=JaxEuler(), vae_scale_factor=2, default_size=16)
    vae = AutoencoderKL(configs.TINY_VAE)
    vae.load_state_dict(vae_state_dict_from_flax(vae_params), strict=True)
    pipe = InterpolationXLPipeline(
        unet=th.port_unet(UNET_CFG, unet_params), vae=vae.eval(), text_encoder=t1,
        tokenizer=HashTokenizer(configs.TINY_CLIP_TEXT.vocab_size), scheduler=EulerDiscreteScheduler(),
        text_encoder_2=t2, tokenizer_2=HashTokenizer(TEXT2_CFG.vocab_size), vae_scale_factor=2, default_size=16)
    return jax_pipe, pipe


def _latents():
    s, c = UNET_CFG.sample_size, UNET_CFG.in_channels
    return th.normal(40, (1, s, s, c)), th.normal(41, (1, s, s, c))


@pytest.mark.parametrize("guide", [None, "a small bird"], ids=["aid", "paid"])
@pytest.mark.parametrize("output_type", ["latent", "np"])
def test_interpolate_matches_jax(pipes, guide, output_type):
    jax_pipe, pipe = pipes
    a, b = _latents()
    kw = dict(prompt_start="a red cat", prompt_end="a blue dog", guide_prompt=guide, size=4,
              num_inference_steps=2, output_type=output_type)
    want = np.asarray(jax_pipe.interpolate(jnp.asarray(a), jnp.asarray(b), **kw))
    got = pipe.interpolate(th.nhwc_to_nchw(a), th.nhwc_to_nchw(b), **kw)
    if output_type == "latent":
        assert tuple(got.shape) == (4, UNET_CFG.in_channels, 8, 8)
        assert torch.isfinite(got).all()
        assert th.max_rel_err(th.nchw_to_nhwc(got), want) < SLICE_TOL
    else:
        assert got.dtype == np.uint8 and got.shape == want.shape == (4, 16, 16, 3)
        # the [0, 1] floats agree to ~1e-5; a value that close to a rounding
        # boundary may land one uint8 step apart
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        assert 0 < got.min() or got.max() < 255 or np.unique(got).size > 2  # not all saturated


def test_interpolate_ts_and_denoising_end_match_jax(pipes):
    """Explicit ts (latent slerp, embed lerp and attention coef at these
    points) with denoising_end, which returns latents after fewer steps."""
    jax_pipe, pipe = pipes
    a, b = _latents()
    kw = dict(prompt_start="a red cat", prompt_end="a blue dog", ts=[0.0, 0.3, 0.8, 1.0],
              num_inference_steps=4, denoising_end=0.6)
    assert pipe._effective_steps(4, 0.6) == jax_pipe._effective_steps(4, 0.6) < 4
    want = np.asarray(jax_pipe.interpolate(jnp.asarray(a), jnp.asarray(b), **kw))
    got = pipe.interpolate(th.nhwc_to_nchw(a), th.nhwc_to_nchw(b), **kw)
    assert th.max_rel_err(th.nchw_to_nhwc(got), want) < SLICE_TOL


def test_encode_prompt_and_time_ids_match_jax(pipes):
    jax_pipe, pipe = pipes
    for got, want in zip(pipe.encode_prompt("a red cat", "blurry"), jax_pipe.encode_prompt("a red cat", "blurry")):
        assert tuple(got.shape) == tuple(want.shape)
        assert th.max_rel_err(got.numpy(), np.asarray(want)) < 1e-5
    kw = dict(original_size=(20, 24), crops_coords_top_left=(1, 2), negative_original_size=(8, 8),
              negative_target_size=(12, 12))
    for got, want in zip(pipe._time_ids_pair(3, 16, 16, **kw), jax_pipe._time_ids_pair(3, 16, 16, **kw)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
