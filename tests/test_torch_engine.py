"""The port's denoise slice against aid_tpu's, and the port's import boundary.

The whole slice: tiny-SDXL ``denoise_sequence`` over 5 frames, 4 Euler
steps (2 fused_outer warmup + 2 vanilla), sequential CFG at guidance 5, Beta
(28, 28) frame coefficients, f32 on the CPU, the same weights and inputs on
both sides. The SD1.x engine pieces, ``denoise_steps`` (chunks of one
schedule) and ``denoise_range`` (vanilla CFG), run a tiny SD UNet with DDIM.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_helpers as th
from aid_tpu.models.layers import AidMode as JaxAidMode
from aid_tpu.pipelines import engine as jax_engine
from aid_tpu.schedulers.ddim import DDIMScheduler as JaxDDIM
from aid_tpu.schedulers.euler import EulerDiscreteScheduler as JaxEuler
from aid_tpu_torch.models import configs
from aid_tpu_torch.models.layers import AidMode
from aid_tpu_torch.ops.interp import generate_beta_schedule
from aid_tpu_torch.pipelines import engine
from aid_tpu_torch.schedulers.base import SchedulerConfig
from aid_tpu_torch.schedulers.ddim import DDIMScheduler
from aid_tpu_torch.schedulers.euler import EulerDiscreteScheduler

# f32 over 4 steps x 2 UNet passes: the per-forward ~1e-6 relative
# difference (test_torch_models.py) compounds through the guidance
# (x5 on the text-uncond difference) and the Euler updates; 1e-4 of
# max |ref| holds that with margin and still fails on any real fault.
SLICE_TOL = 1e-4


@pytest.mark.parametrize("kw", [
    {},
    {"use_karras_sigmas": True},
    {"config": SchedulerConfig(timestep_spacing="trailing", prediction_type="v_prediction")},
], ids=["default", "karras", "trailing_v"])
def test_euler_schedule_and_step_match_jax(kw):
    ours, theirs = EulerDiscreteScheduler(**kw), JaxEuler(**kw)
    s, js = ours.init(28), theirs.init(28)
    np.testing.assert_array_equal(s.timesteps.numpy(), np.asarray(js.timesteps))
    np.testing.assert_array_equal(s.sigmas.numpy(), np.asarray(js.sigmas))
    assert s.init_noise_sigma == js.init_noise_sigma
    x, eps = th.normal(0, (2, 4, 8, 8)), th.normal(1, (2, 4, 8, 8))
    for i in (0, 13, 27):
        got, _ = ours.step(s, torch.from_numpy(eps), i, torch.from_numpy(x))
        want, _ = theirs.step(js, jnp.asarray(eps), i, jnp.asarray(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ours.scale_model_input(s, torch.from_numpy(x), i).numpy(),
                                   np.asarray(theirs.scale_model_input(js, jnp.asarray(x), i)), rtol=1e-6)
        np.testing.assert_allclose(ours.add_noise(s, torch.from_numpy(x), torch.from_numpy(eps), i).numpy(),
                                   np.asarray(theirs.add_noise(js, jnp.asarray(x), jnp.asarray(eps), i)),
                                   rtol=1e-6, atol=1e-6)


def test_rescale_noise_cfg_matches_jax():
    a, b = th.normal(2, (3, 4, 8, 8)), th.normal(3, (3, 4, 8, 8))
    got = engine.rescale_noise_cfg(torch.from_numpy(a), torch.from_numpy(b), 0.7)
    want = jax_engine.rescale_noise_cfg(jnp.asarray(a), jnp.asarray(b), 0.7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("early", ["fused_outer", "pure_inner"])
def test_denoise_sequence_slice_matches_jax(early):
    cfg = configs.TINY_SDXL_UNET
    frames, steps, warmup, s = 5, 4, 2, cfg.sample_size
    jax_unet, params = th.jax_unet_and_params(cfg, seed=7)
    unet = th.port_unet(cfg, params)

    latents = th.normal(8, (frames, s, s, cfg.in_channels))
    embs = th.normal(9, (frames, 77, cfg.cross_attention_dim))
    uncond = th.normal(10, (frames, 77, cfg.cross_attention_dim))
    added = th.sdxl_added_cond(cfg, frames, 11)
    coef = generate_beta_schedule(frames, 28, 28, force_endpoints=True)

    jsched = JaxEuler()
    want = jax_engine.denoise_sequence(
        jax_unet, jsched, th.to_jnp(params), jnp.asarray(latents), jnp.asarray(embs), jnp.asarray(uncond),
        jnp.asarray(coef), jsched.init(steps), jnp.float32(5.0),
        early=JaxAidMode.from_name(early), late=JaxAidMode.vanilla(), num_steps=steps, warmup_steps=warmup,
        added_cond=th.to_jnp(added))

    sched = EulerDiscreteScheduler()
    x0 = th.nhwc_to_nchw(latents)
    x0_copy = x0.clone()
    got = engine.denoise_sequence(
        unet, sched, x0, torch.from_numpy(embs), torch.from_numpy(uncond), torch.from_numpy(coef),
        sched.init(steps), 5.0, early=AidMode.from_name(early), late=AidMode.vanilla(),
        num_steps=steps, warmup_steps=warmup, added_cond=th.to_torch(added))
    torch.testing.assert_close(x0, x0_copy, rtol=0, atol=0)  # the caller's latents are not written
    assert torch.isfinite(got).all()
    assert th.max_rel_err(th.nchw_to_nhwc(got), np.asarray(want)) < SLICE_TOL


def test_denoise_steps_and_range_match_jax():
    """denoise_steps over the chunks [0, 1) and [1, 3) of a 3-step DDIM
    schedule (warmup 2, so the split falls inside the second chunk) and
    denoise_range over [1, 3), against the JAX functions; the port's chunks
    compose exactly to one denoise_sequence."""
    cfg = configs.TINY_UNET
    frames, steps, warmup, s = 3, 3, 2, cfg.sample_size
    jax_unet, params = th.jax_unet_and_params(cfg, seed=12)
    unet = th.port_unet(cfg, params)
    latents = th.normal(13, (frames, s, s, cfg.in_channels))
    embs = th.normal(14, (frames, 77, cfg.cross_attention_dim))
    uncond = th.normal(15, (frames, 77, cfg.cross_attention_dim))
    coef = np.array([0.0, 0.4, 1.0], np.float32)
    jsched, sched = JaxDDIM(), DDIMScheduler()
    jargs = (jax_unet, jsched, th.to_jnp(params))
    jin = (jnp.asarray(embs), jnp.asarray(uncond), jnp.asarray(coef))
    jmodes = dict(early=JaxAidMode.from_name("fused_outer"), late=JaxAidMode.vanilla(), warmup_steps=warmup)
    args = (unet, sched)
    tin = (torch.from_numpy(embs), torch.from_numpy(uncond), torch.from_numpy(coef))
    modes = dict(early=AidMode.from_name("fused_outer"), late=AidMode.vanilla(), warmup_steps=warmup)

    want, jstate = jnp.asarray(latents), jsched.init(steps)
    got, state = th.nhwc_to_nchw(latents), sched.init(steps)
    for start, end in ((0, 1), (1, steps)):
        want, jstate = jax_engine.denoise_steps(*jargs, want, *jin, jstate, jnp.float32(7.5), start=start, end=end,
                                                **jmodes)
        got, state = engine.denoise_steps(*args, got, *tin, state, 7.5, start=start, end=end, **modes)
        assert th.max_rel_err(th.nchw_to_nhwc(got), np.asarray(want)) < SLICE_TOL
    whole = engine.denoise_sequence(*args, th.nhwc_to_nchw(latents), *tin, sched.init(steps), 7.5,
                                    num_steps=steps, **modes)
    torch.testing.assert_close(got, whole, rtol=0, atol=0)

    want, _ = jax_engine.denoise_range(*jargs, jnp.asarray(latents), jin[0], jin[1], jsched.init(steps),
                                       jnp.float32(7.5), start=1, end=steps)
    got, _ = engine.denoise_range(*args, th.nhwc_to_nchw(latents), tin[0], tin[1], sched.init(steps), 7.5,
                                  start=1, end=steps)
    assert th.max_rel_err(th.nchw_to_nhwc(got), np.asarray(want)) < SLICE_TOL


def test_import_leaves_jax_out():
    """The port never imports jax, flax or the JAX package (only modules the
    import itself adds count, so a jax preloaded at interpreter start does not)."""
    code = ("import sys; before = set(sys.modules); "
            "import aid_tpu_torch, aid_tpu_torch.ops.flash_attention, aid_tpu_torch.ops.conv, "
            "aid_tpu_torch.ops._build, aid_tpu_torch.models.params, aid_tpu_torch.models.vae, "
            "aid_tpu_torch.models.clip, aid_tpu_torch.pipelines.sdxl, aid_tpu_torch.pipelines.interpolation, "
            "aid_tpu_torch.schedulers.ddim, aid_tpu_torch.utils.tokenizer; "
            "bad = sorted(m for m in set(sys.modules) - before if m.split('.')[0] in ('jax', 'flax', 'aid_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
