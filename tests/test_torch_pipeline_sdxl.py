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


def xl_pipes(unet_cfg=UNET_CFG):
    """(JAX XL pipeline, port XL pipeline) over the same perturbed weights;
    an ``ip_num_tokens > 0`` config gives UNets with the IP-Adapter's
    projections."""
    from aid_tpu.models import configs as jax_configs

    jax_unet, unet_params = th.jax_unet_and_params(unet_cfg, seed=3)
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
        unet=th.port_unet(unet_cfg, unet_params), vae=vae.eval(), text_encoder=t1,
        tokenizer=HashTokenizer(configs.TINY_CLIP_TEXT.vocab_size), scheduler=EulerDiscreteScheduler(),
        text_encoder_2=t2, tokenizer_2=HashTokenizer(TEXT2_CFG.vocab_size), vae_scale_factor=2, default_size=16)
    return jax_pipe, pipe


@pytest.fixture(scope="module")
def pipes():
    return xl_pipes()


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


@pytest.mark.parametrize("guide,init", [(None, "linear"), ("a small bird", "slerp")])
def test_interpolate_single_matches_jax(pipes, guide, init):
    """XL interpolate_single: pooled embeds interpolated beside the text
    embeds (the guide prompt brings its own), micro-conditioning kwargs whose
    negatives change only the uncond pass's time_ids."""
    jax_pipe, pipe = pipes
    a, b = _latents()
    kw = dict(prompt_start="a red cat", prompt_end="a blue dog", guide_prompt=guide, init=init,
              num_inference_steps=2, output_type="latent", original_size=(20, 24), crops_coords_top_left=(1, 2),
              negative_original_size=(8, 8), negative_target_size=(12, 12))
    want = np.asarray(jax_pipe.interpolate_single(0.4, jnp.asarray(a), jnp.asarray(b), **kw))
    got = pipe.interpolate_single(0.4, th.nhwc_to_nchw(a), th.nhwc_to_nchw(b), **kw)
    assert tuple(got.shape) == (3, UNET_CFG.in_channels, 8, 8)
    assert th.max_rel_err(th.nchw_to_nhwc(got), want) < SLICE_TOL


def test_vanilla_entry_points_match_jax(pipes):
    """__call__ and denoising_interpolate, inherited from the SD1.x class,
    run SDXL with the added conditioning of the XL _cond_kwargs."""
    jax_pipe, pipe = pipes
    a, b = _latents()
    kw = dict(prompt="a red cat", negative_prompt="blurry", num_inference_steps=2, output_type="latent")
    want = np.asarray(jax_pipe(latents=jnp.asarray(a), **kw))
    got = pipe(latents=th.nhwc_to_nchw(a), **kw)
    assert th.max_rel_err(th.nchw_to_nhwc(got), want) < SLICE_TOL
    lat = np.concatenate([a, b])
    kw = dict(text_1="a red cat", text_2="a blue dog", interpolated_ratio=0.5, timesteps=2)
    want = jax_pipe.denoising_interpolate(jnp.asarray(lat), **kw)
    got = pipe.denoising_interpolate(th.nhwc_to_nchw(lat), **kw)
    assert got.dtype == np.uint8 and got.shape == want.shape == (2, 16, 16, 3)
    assert np.abs(got.astype(int) - np.asarray(want).astype(int)).max() <= 1


def test_xl_image_embeds_raise(pipes):
    """Image embeds on the XL entry point raise without an IP-Adapter, as on
    the SD1.x one; with one loaded on both sides (a UNet with IP tokens)
    interpolate_single agrees with the JAX XL pipeline."""
    from test_torch_ip_adapter import checkpoint

    _, pipe = pipes
    a, b = _latents()
    with pytest.raises(ValueError, match="load_aid_ip_adapter"):
        pipe.interpolate_single(0.5, th.nhwc_to_nchw(a), th.nhwc_to_nchw(b), image_embeds_end=torch.zeros(1, 8),
                                num_inference_steps=1)
    cfg = dataclasses.replace(UNET_CFG, ip_num_tokens=4, ip_hidden_dim=8)
    jax_ip, ip_pipe = xl_pipes(cfg)
    sd = checkpoint(cfg, 15)
    jax_ip.load_aid_ip_adapter(sd, scale=0.6)
    ip_pipe.load_aid_ip_adapter(sd, scale=0.6)
    e0, e1 = (th.normal(90 + i, (1, 8)) for i in range(2))
    kw = dict(prompt_start="a red cat", prompt_end="a blue dog", num_inference_steps=2, output_type="latent")
    want = jax_ip.interpolate_single(0.5, jnp.asarray(a), jnp.asarray(b), image_embeds_start=jnp.asarray(e0),
                                     image_embeds_end=jnp.asarray(e1), **kw)
    got = ip_pipe.interpolate_single(0.5, th.nhwc_to_nchw(a), th.nhwc_to_nchw(b),
                                     image_embeds_start=torch.from_numpy(e0), image_embeds_end=torch.from_numpy(e1),
                                     **kw)
    assert torch.isfinite(got).all()
    assert th.max_rel_err(th.nchw_to_nhwc(got), np.asarray(want)) < SLICE_TOL


@pytest.mark.parametrize("option", ["bf16_vae", "vae_tiling", "batched_cfg"])
def test_xl_pipeline_options_match_jax(pipes, option):
    """XL interpolate (frame-by-frame decode) with the bf16 VAE decode, VAE
    tiling or batched CFG on, both pipelines alike (the options are the
    SD1.x class's; torch_helpers states the bounds)."""
    jax_pipe, pipe = th.with_pipeline_option(*pipes, option)
    a, b = _latents()
    kw = dict(prompt_start="a red cat", prompt_end="a blue dog", size=4, num_inference_steps=2)
    want = np.asarray(jax_pipe.interpolate(jnp.asarray(a), jnp.asarray(b), **kw))
    got = pipe.interpolate(th.nhwc_to_nchw(a), th.nhwc_to_nchw(b), **kw)
    assert got.dtype == np.uint8 and got.shape == want.shape == (4, 16, 16, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= (th.BF16_UINT8_STEPS if option == "bf16_vae" else 1)
    if option == "batched_cfg":
        kw["output_type"] = "latent"
        want = np.asarray(jax_pipe.interpolate(jnp.asarray(a), jnp.asarray(b), **kw))
        got = pipe.interpolate(th.nhwc_to_nchw(a), th.nhwc_to_nchw(b), **kw)
        assert th.max_rel_err(th.nchw_to_nhwc(got), want) < SLICE_TOL


@pytest.mark.parametrize("case", ["endpoints", "endpoints_guide", "endpoints_guide_no_pooled",
                                  "guide_only", "guide_only_pooled"])
def test_xl_interpolate_single_prompt_embeds_match_jax(pipes, case):
    """Pre-computed (1, 77, 56) embeddings and (1, 24) pooled embeddings in
    place of both text encoders (sdxl.py:263-340): the endpoints' with the
    negatives, with a guide's with and without its pooled embeds (the
    middle frame's pooled embeds are then interpolated), and a guide's
    alone beside the prompts. The same seeded numpy arrays to both
    pipelines, latents at SLICE_TOL; embeds off the port's own
    encode_prompt give the prompt path's latents bit for bit; a missing
    partner raises."""
    jax_pipe, pipe = pipes
    a, b = _latents()
    seq, pool = (1, 77, UNET_CFG.cross_attention_dim), (1, TEXT2_CFG.projection_dim)
    e_s, e_e, neg, g = (th.normal(110 + i, seq) for i in range(4))
    p_s, p_e, neg_p, g_p = (th.normal(120 + i, pool) for i in range(4))
    ends = dict(prompt_embeds_start=e_s, prompt_embeds_end=e_e, pooled_prompt_embeds_start=p_s,
                pooled_prompt_embeds_end=p_e, negative_prompt_embeds=neg, negative_pooled_prompt_embeds=neg_p)
    embeds = {"endpoints": ends, "endpoints_guide": {**ends, "guide_prompt_embeds": g, "guide_pooled_prompt_embeds": g_p},
              "endpoints_guide_no_pooled": {**ends, "guide_prompt_embeds": g},
              "guide_only": {"guide_prompt_embeds": g},
              "guide_only_pooled": {"guide_prompt_embeds": g, "guide_pooled_prompt_embeds": g_p}}[case]
    kw = dict(prompt_start="a red cat", prompt_end="a blue dog", num_inference_steps=2, output_type="latent")
    want = np.asarray(jax_pipe.interpolate_single(0.4, jnp.asarray(a), jnp.asarray(b), **kw,
                                                  **{k: jnp.asarray(v) for k, v in embeds.items()}))
    got = pipe.interpolate_single(0.4, th.nhwc_to_nchw(a), th.nhwc_to_nchw(b), **kw,
                                  **{k: torch.from_numpy(v) for k, v in embeds.items()})
    assert torch.isfinite(got).all()
    assert th.max_rel_err(th.nchw_to_nhwc(got), want) < SLICE_TOL

    ta, tb = th.nhwc_to_nchw(a), th.nhwc_to_nchw(b)
    emb_a, un, pooled_a, un_pooled = pipe.encode_prompt("a red cat")
    emb_b, _, pooled_b, _ = pipe.encode_prompt("a blue dog")
    prompts = pipe.interpolate_single(0.4, ta, tb, **kw)
    via = pipe.interpolate_single(0.4, ta, tb, prompt_embeds_start=emb_a, prompt_embeds_end=emb_b,
                                  pooled_prompt_embeds_start=pooled_a, pooled_prompt_embeds_end=pooled_b,
                                  negative_prompt_embeds=un, negative_pooled_prompt_embeds=un_pooled,
                                  num_inference_steps=2, output_type="latent")
    torch.testing.assert_close(via, prompts, rtol=0, atol=0)
    with pytest.raises(ValueError, match="negative_pooled_prompt_embeds"):
        pipe.interpolate_single(0.4, ta, tb, prompt_embeds_start=emb_a, prompt_embeds_end=emb_b,
                                negative_prompt_embeds=un, num_inference_steps=1)
