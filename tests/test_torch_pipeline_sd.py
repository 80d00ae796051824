"""The port's SD1.x ``InterpolationPipeline`` against aid_tpu's.

The JAX pipeline is ``helpers.tiny_pipeline()`` (as tests/test_pipeline.py
builds it: TINY_UNET, TINY_VAE, TINY_CLIP_TEXT, HashTokenizer, DDIM) with
every parameter perturbed by seeded noise, so biases and norm affines are not
0/1; the port's modules get the same weights through the
``*_state_dict_from_flax`` converters. Both pipelines start from the same
numpy latents. f32 on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_helpers as th
from aid_tpu.ops.interp import slerp as jax_slerp
from aid_tpu_torch.models import configs
from aid_tpu_torch.models.clip import CLIPTextModel
from aid_tpu_torch.models.params import clip_text_state_dict_from_flax, vae_state_dict_from_flax
from aid_tpu_torch.models.vae import AutoencoderKL
from aid_tpu_torch.ops.interp import slerp
from aid_tpu_torch.pipelines.interpolation import InterpolationPipeline, slerp_latent, slerp_latents
from aid_tpu_torch.schedulers.ddim import DDIMScheduler
from aid_tpu_torch.utils.tokenizer import HashTokenizer
from helpers import tiny_pipeline

# f32 over 2-3 DDIM steps x 2 UNet passes after the text encoder: the
# per-forward ~1e-6 relative difference (test_torch_models.py) grows through
# the guidance (x7.5) and the steps; 1e-4 of max |ref| holds that with margin,
# while a wrong slerp axis, lerp point, embed row, coefficient or step moves
# the latents by >= 1e-3.
SLICE_TOL = 1e-4
STEPS = 2


def _perturbed(params, seed):
    noise = th.rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + (noise.standard_normal(a.shape) * 0.05).astype(np.float32), params)


def sd_pipes(unet_cfg=configs.TINY_UNET):
    """(JAX pipeline, port pipeline) over the same perturbed weights; an
    ``ip_num_tokens > 0`` config (TINY_UNET_IP) gives UNets with the
    IP-Adapter's projections."""
    base = tiny_pipeline(unet_cfg=unet_cfg)
    unet_p, vae_p, text_p = (_perturbed(p, s) for p, s in ((base.unet_params, 21), (base.vae_params, 22),
                                                            (base.text_params, 23)))
    jax_pipe = dataclasses.replace(base, unet_params=th.to_jnp(unet_p), vae_params=th.to_jnp(vae_p),
                                   text_params=th.to_jnp(text_p))
    vae = AutoencoderKL(configs.TINY_VAE)
    vae.load_state_dict(vae_state_dict_from_flax(vae_p), strict=True)
    text = CLIPTextModel(configs.TINY_CLIP_TEXT)
    text.load_state_dict(clip_text_state_dict_from_flax(text_p), strict=True)
    pipe = InterpolationPipeline(
        unet=th.port_unet(unet_cfg, unet_p), vae=vae.eval(), text_encoder=text.eval(),
        tokenizer=HashTokenizer(configs.TINY_CLIP_TEXT.vocab_size), scheduler=DDIMScheduler(),
        vae_scale_factor=base.vae_scale_factor)
    return jax_pipe, pipe


@pytest.fixture(scope="module")
def pipes():
    return sd_pipes()


def _latents(seed=40):
    s, c = configs.TINY_UNET.sample_size, configs.TINY_UNET.in_channels
    return th.normal(seed, (1, s, s, c)), th.normal(seed + 1, (1, s, s, c))


def _both(a, b):
    """(JAX NHWC, port NCHW) forms of two numpy NHWC latents."""
    return (jnp.asarray(a), jnp.asarray(b)), (th.nhwc_to_nchw(a), th.nhwc_to_nchw(b))


def _same_latents(got, want):
    assert torch.isfinite(got).all()
    assert th.max_rel_err(th.nchw_to_nhwc(got), np.asarray(want)) < SLICE_TOL


def _same_images(got, want):
    want = np.asarray(want)
    assert got.dtype == np.uint8 and got.shape == want.shape
    # the [0, 1] floats agree to ~1e-5; a value that close to a rounding
    # boundary may land one uint8 step apart
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert np.unique(got).size > 2  # not all saturated


@pytest.mark.parametrize("guide", [None, "a small bird"], ids=["aid", "paid"])
@pytest.mark.parametrize("output_type", ["latent", "np"])
def test_interpolate_matches_jax(pipes, guide, output_type):
    jax_pipe, pipe = pipes
    (ja, jb), (ta, tb) = _both(*_latents())
    kw = dict(prompt_start="a red cat", prompt_end="a blue dog", guide_prompt=guide, size=4,
              num_inference_steps=STEPS, output_type=output_type)
    want = jax_pipe.interpolate(ja, jb, **kw)
    got = pipe.interpolate(ta, tb, **kw)
    if output_type == "latent":
        assert tuple(got.shape) == (4, configs.TINY_UNET.in_channels, 8, 8)
        _same_latents(got, want)
    else:
        assert got.shape == (4, 16, 16, 3)
        _same_images(got, want)


def test_interpolate_ts_matches_jax(pipes):
    """Explicit ts: latent slerp, embed lerp and attention coef at these points."""
    jax_pipe, pipe = pipes
    (ja, jb), (ta, tb) = _both(*_latents())
    kw = dict(prompt_start="a red cat", prompt_end="a blue dog", ts=[0.0, 0.3, 0.8, 1.0],
              num_inference_steps=STEPS, output_type="latent")
    _same_latents(pipe.interpolate(ta, tb, **kw), jax_pipe.interpolate(ja, jb, **kw))
    with pytest.raises(ValueError):
        pipe.interpolate(ta, tb, "a", "b", ts=[0.1, 1.0])


@pytest.mark.parametrize("guide,init,early", [(None, "linear", "fused_outer"), ("a small bird", "linear", "fused_outer"),
                                              (None, "slerp", "pure_inner")])
def test_interpolate_single_matches_jax(pipes, guide, init, early):
    jax_pipe, pipe = pipes
    (ja, jb), (ta, tb) = _both(*_latents(50))
    kw = dict(prompt_start="a red cat", prompt_end="a blue dog", guide_prompt=guide, init=init, early=early,
              num_inference_steps=STEPS, output_type="latent")
    want = jax_pipe.interpolate_single(0.4, ja, jb, **kw)
    got = pipe.interpolate_single(0.4, ta, tb, **kw)
    assert tuple(got.shape) == (3, configs.TINY_UNET.in_channels, 8, 8)
    _same_latents(got, want)


def test_slerp_latent_is_per_pixel_channel_slerp():
    """The layout trap: JAX slerps NHWC latents over their last axis, the
    channels. slerp_latent / slerp_latents give that on NCHW latents; a slerp
    over the NCHW tensor's own last axis (the width) would not."""
    a, b = _latents(60)
    (ja, jb), (ta, tb) = _both(a, b)
    want = np.asarray(jax_slerp(ja, jb, 0.3))
    got = slerp_latent(ta, tb, 0.3)
    np.testing.assert_allclose(th.nchw_to_nhwc(got), want, rtol=1e-5, atol=1e-6)
    assert th.max_rel_err(th.nchw_to_nhwc(slerp(ta, tb, 0.3)), want) > 1e-2
    seq = slerp_latents(ta, tb, 5)
    torch.testing.assert_close(seq[1:2], slerp_latent(ta, tb, 0.25), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("batched", [False, True])
def test_interpolate_save_gpu_matches_jax(pipes, batched):
    jax_pipe, pipe = pipes
    (ja, jb), (ta, tb) = _both(*_latents(70))
    kw = dict(prompt_start="a red cat", prompt_end="a blue dog", size=4, num_inference_steps=STEPS, batched=batched)
    got = pipe.interpolate_save_gpu(ta, tb, **kw)
    assert got.shape == (4, 16, 16, 3)
    _same_images(got, jax_pipe.interpolate_save_gpu(ja, jb, **kw))


def test_denoising_interpolate_matches_jax(pipes):
    """The baseline: text_1 for the first half of the steps, then text_2,
    vanilla attention throughout."""
    jax_pipe, pipe = pipes
    a, b = _latents(80)
    lat = np.concatenate([a, b])
    kw = dict(text_1="a red cat", text_2="a blue dog", negative_prompt="blurry", interpolated_ratio=0.5,
              timesteps=STEPS)
    got = pipe.denoising_interpolate(th.nhwc_to_nchw(lat), **kw)
    assert got.shape == (2, 16, 16, 3)
    _same_images(got, jax_pipe.denoising_interpolate(jnp.asarray(lat), **kw))


def test_call_matches_jax(pipes):
    jax_pipe, pipe = pipes
    a, _ = _latents(90)
    kw = dict(prompt="a red cat", negative_prompt="blurry", num_inference_steps=STEPS, output_type="latent")
    _same_latents(pipe(latents=th.nhwc_to_nchw(a), **kw), jax_pipe(latents=jnp.asarray(a), **kw))
    seeded = pipe("a red cat", num_inference_steps=1, num_images_per_prompt=2, output_type="latent")
    assert tuple(seeded.shape) == (2, 4, 8, 8) and not torch.equal(seeded[0], seeded[1])
    with pytest.raises(ValueError):
        pipe("a red cat", latents=th.nhwc_to_nchw(np.concatenate([a, a])), num_images_per_prompt=3)


def test_chunked_generation_with_interrupt_matches_jax(pipes):
    """Chunks of one step; a chunk callback that edits the latents and, after
    the first chunk, interrupts: both pipelines stop after that step."""
    jax_pipe, pipe = pipes
    (ja, jb), (ta, tb) = _both(*_latents(100))
    kw = dict(prompt_start="a red cat", prompt_end="a blue dog", size=3, num_inference_steps=3, output_type="latent")
    seen = {"jax": [], "port": []}

    def callback(name):
        def cb(p, step_end, latents):
            seen[name].append(step_end)
            if step_end == 1:
                p.interrupt()
            return latents * 0.5
        return cb

    want = dataclasses.replace(jax_pipe, denoise_chunk_size=1).interpolate(
        ja, jb, callback_on_chunk_end=callback("jax"), **kw)
    got = dataclasses.replace(pipe, denoise_chunk_size=1).interpolate(ta, tb, callback_on_chunk_end=callback("port"),
                                                                      **kw)
    assert seen["port"] == seen["jax"] == [1]
    _same_latents(got, want)


def test_step_callback_matches_jax(pipes):
    """The reference-style per-step callback: (i, t) at every step, and the
    latents it returns replace the running ones."""
    jax_pipe, pipe = pipes
    (ja, jb), (ta, tb) = _both(*_latents(110))
    seen = {"jax": [], "port": []}

    def callback(name):
        def cb(p, i, t, tensors):
            seen[name].append((i, int(t)))
            return {"latents": tensors["latents"] * 0.9}
        return cb

    kw = dict(prompt_start="a red cat", prompt_end="a blue dog", num_inference_steps=STEPS, output_type="latent")
    want = jax_pipe.interpolate_single(0.5, ja, jb, callback_on_step_end=callback("jax"), **kw)
    got = pipe.interpolate_single(0.5, ta, tb, callback_on_step_end=callback("port"), **kw)
    assert seen["port"] == seen["jax"] and len(seen["port"]) == STEPS
    _same_latents(got, want)
    with pytest.raises(ValueError):
        pipe.interpolate_single(0.5, ta, tb, callback_on_step_end=callback("port"),
                                callback_on_chunk_end=lambda *a: None, **kw)


def test_entry_point_guards(pipes):
    """Image embeds need an IP-Adapter: without one they raise, with one
    (a UNet with IP tokens, an h94-format checkpoint loaded on both sides)
    interpolate_single agrees with the JAX pipeline; t must lie in (0, 1)."""
    from test_torch_ip_adapter import checkpoint

    _, pipe = pipes
    _, (ta, tb) = _both(*_latents())
    with pytest.raises(ValueError, match="load_aid_ip_adapter"):
        pipe.interpolate_single(0.5, ta, tb, image_embeds_end=torch.zeros(1, 8), num_inference_steps=1)
    jax_ip, ip_pipe = sd_pipes(configs.TINY_UNET_IP)
    sd = checkpoint(configs.TINY_UNET_IP, 14)
    jax_ip.load_aid_ip_adapter(sd, scale=0.6)
    ip_pipe.load_aid_ip_adapter(sd, scale=0.6)
    e0, e1 = (th.normal(80 + i, (1, configs.TINY_UNET_IP.ip_hidden_dim)) for i in range(2))
    (ja, jb), (ta, tb) = _both(*_latents())
    kw = dict(prompt_start="a red cat", prompt_end="a blue dog", num_inference_steps=STEPS, output_type="latent")
    want = jax_ip.interpolate_single(0.5, ja, jb, image_embeds_start=jnp.asarray(e0),
                                     image_embeds_end=jnp.asarray(e1), **kw)
    got = ip_pipe.interpolate_single(0.5, ta, tb, image_embeds_start=torch.from_numpy(e0),
                                     image_embeds_end=torch.from_numpy(e1), **kw)
    _same_latents(got, want)
    for it in (0.0, 1.0):
        with pytest.raises(ValueError):
            pipe.interpolate_single(it, ta, tb, num_inference_steps=1)
    with pytest.raises(ValueError):
        pipe.interpolate(ta, tb, "a", "b", size=3, num_inference_steps=1, output_type="pil")


@pytest.mark.parametrize("option", ["bf16_vae", "vae_tiling", "batched_cfg"])
def test_pipeline_options_match_jax(pipes, option):
    """interpolate with the bf16 VAE decode, VAE tiling or batched CFG on,
    both pipelines alike: frames (bf16 within BF16_UINT8_STEPS, the others
    one step), and for batched CFG the latents too."""
    jax_pipe, pipe = th.with_pipeline_option(*pipes, option)
    (ja, jb), (ta, tb) = _both(*_latents(120))
    kw = dict(prompt_start="a red cat", prompt_end="a blue dog", size=4, num_inference_steps=STEPS)
    want, got = jax_pipe.interpolate(ja, jb, **kw), pipe.interpolate(ta, tb, **kw)
    assert got.shape == (4, 16, 16, 3)
    if option == "bf16_vae":
        want = np.asarray(want)
        assert got.dtype == np.uint8 and got.shape == want.shape and np.unique(got).size > 2
        assert np.abs(got.astype(int) - want.astype(int)).max() <= th.BF16_UINT8_STEPS
    else:
        _same_images(got, want)
    if option == "batched_cfg":
        kw["output_type"] = "latent"
        _same_latents(pipe.interpolate(ta, tb, **kw), jax_pipe.interpolate(ja, jb, **kw))
    pipe.disable_vae_tiling()
    assert pipe.vae_tile_latent_size is None


@pytest.mark.parametrize("case", ["endpoints", "endpoints_guide", "guide_only"])
def test_interpolate_single_prompt_embeds_match_jax(pipes, case):
    """Pre-computed embeddings in place of the prompts (interpolation.py:
    525-545): the endpoints' with the negative embeds, with and without a
    guide's; a guide's alone beside the prompts. The same seeded numpy
    embeds to both pipelines, latents at SLICE_TOL; embeds taken off the
    port's own encode_prompt give the prompt path's latents bit for bit;
    prompt_embeds_start without its partners raises."""
    jax_pipe, pipe = pipes
    (ja, jb), (ta, tb) = _both(*_latents(55))
    shape = (1, 77, configs.TINY_CLIP_TEXT.hidden_size)
    e_s, e_e, neg, g = (th.normal(100 + i, shape) for i in range(4))
    embeds = {"endpoints": dict(prompt_embeds_start=e_s, prompt_embeds_end=e_e, negative_prompt_embeds=neg),
              "endpoints_guide": dict(prompt_embeds_start=e_s, prompt_embeds_end=e_e, negative_prompt_embeds=neg,
                                      guide_prompt_embeds=g),
              "guide_only": dict(guide_prompt_embeds=g)}[case]
    kw = dict(prompt_start="a red cat", prompt_end="a blue dog", guide_prompt="ignored when embeds are given",
              num_inference_steps=STEPS, output_type="latent")
    want = jax_pipe.interpolate_single(0.4, ja, jb, **kw, **{k: jnp.asarray(v) for k, v in embeds.items()})
    got = pipe.interpolate_single(0.4, ta, tb, **kw, **{k: torch.from_numpy(v) for k, v in embeds.items()})
    _same_latents(got, want)

    emb_a, un = pipe.encode_prompt("a red cat")
    emb_b, _ = pipe.encode_prompt("a blue dog")
    prompts = pipe.interpolate_single(0.4, ta, tb, prompt_start="a red cat", prompt_end="a blue dog",
                                      num_inference_steps=STEPS, output_type="latent")
    via = pipe.interpolate_single(0.4, ta, tb, prompt_embeds_start=emb_a, prompt_embeds_end=emb_b,
                                  negative_prompt_embeds=un, num_inference_steps=STEPS, output_type="latent")
    torch.testing.assert_close(via, prompts, rtol=0, atol=0)
    with pytest.raises(ValueError, match="negative_prompt_embeds"):
        pipe.interpolate_single(0.4, ta, tb, prompt_embeds_start=emb_a, prompt_embeds_end=emb_b)
