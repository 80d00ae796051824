"""The port's denoise slice against aid_tpu's, and the port's import boundary.

The whole slice: tiny-SDXL ``denoise_sequence`` over 5 frames, 4 Euler
steps (2 fused_outer warmup + 2 vanilla), sequential CFG at guidance 5, Beta
(28, 28) frame coefficients, f32 on the CPU, the same weights and inputs on
both sides; then the same slice with batched CFG (one 2N-row pass a step)
and with the fused loop (force_vanilla late steps), each against the JAX
engine in the same mode and against the port's sequential / split run. The
SD1.x engine pieces, ``denoise_steps`` (chunks of one schedule) and
``denoise_range`` (vanilla CFG), run a tiny SD UNet with DDIM.
``dispatch_attention``'s ``force_vanilla`` is held against the JAX
``dispatch_attention`` in all five modes.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_helpers as th
from aid_tpu.models.layers import AidMode as JaxAidMode
from aid_tpu.ops.attention import dispatch_attention as jax_dispatch
from aid_tpu.pipelines import engine as jax_engine
from aid_tpu.schedulers.ddim import DDIMScheduler as JaxDDIM
from aid_tpu.schedulers.euler import EulerDiscreteScheduler as JaxEuler
from aid_tpu_torch.models import configs
from aid_tpu_torch.models.layers import AidMode
from aid_tpu_torch.ops.attention import AttnMode, _softmax_attn, dispatch_attention
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


@pytest.fixture(scope="module")
def sdxl_slice():
    """The tiny-SDXL slice's model and inputs (4 frames), numpy on the JAX side."""
    cfg = configs.TINY_SDXL_UNET
    frames, s = 4, cfg.sample_size
    jax_unet, params = th.jax_unet_and_params(cfg, seed=17)
    ins = dict(latents=th.normal(18, (frames, s, s, cfg.in_channels)),
               embs=th.normal(19, (frames, 77, cfg.cross_attention_dim)),
               uncond=th.normal(20, (frames, 77, cfg.cross_attention_dim)),
               coef=generate_beta_schedule(frames, 28, 28, force_endpoints=True))
    added = th.sdxl_added_cond(cfg, frames, 21)
    added_uncond = dict(added, text_embeds=th.normal(22, added["text_embeds"].shape))
    return jax_unet, params, th.port_unet(cfg, params), ins, added, added_uncond


def _slice_runs(sdxl_slice, early, steps, warmup, port_modes, **jax_modes):
    """The JAX engine's run in ``jax_modes`` and the port's run in each of
    ``port_modes`` (dicts of cfg_mode / loop_mode), from the same inputs;
    the uncond pass has its own pooled embeds. Returns (want, [got, ...])."""
    jax_unet, params, unet, ins, added, added_uncond = sdxl_slice
    jsched, sched = JaxEuler(), EulerDiscreteScheduler()
    want = jax_engine.denoise_sequence(
        jax_unet, jsched, th.to_jnp(params), jnp.asarray(ins["latents"]), jnp.asarray(ins["embs"]),
        jnp.asarray(ins["uncond"]), jnp.asarray(ins["coef"]), jsched.init(steps), jnp.float32(5.0),
        early=JaxAidMode.from_name(early), late=JaxAidMode.vanilla(), num_steps=steps, warmup_steps=warmup,
        added_cond=th.to_jnp(added), added_cond_uncond=th.to_jnp(added_uncond), **jax_modes)
    got = [engine.denoise_sequence(
        unet, sched, th.nhwc_to_nchw(ins["latents"]), torch.from_numpy(ins["embs"]), torch.from_numpy(ins["uncond"]),
        torch.from_numpy(ins["coef"]), sched.init(steps), 5.0, early=AidMode.from_name(early), late=AidMode.vanilla(),
        num_steps=steps, warmup_steps=warmup, added_cond=th.to_torch(added),
        added_cond_uncond=th.to_torch(added_uncond), **modes) for modes in port_modes]
    return np.asarray(want), got


@pytest.mark.parametrize("early", ["fused_outer", "pure_inner"])
def test_batched_cfg_matches_sequential_and_jax(sdxl_slice, early):
    """cfg_mode="batched": ONE UNet forward a step over the 2N rows [cond;
    uncond] (counted), equal to the JAX batched engine and to the port's
    sequential CFG (the uncond rows' own K/V as both endpoints is vanilla
    attention), within SLICE_TOL."""
    unet = sdxl_slice[2]
    calls = []
    hook = unet.register_forward_pre_hook(lambda mod, args: calls.append(args[0].shape[0]))
    try:
        want, (batched, sequential) = _slice_runs(
            sdxl_slice, early, 2, 1, [dict(cfg_mode="batched"), dict(cfg_mode="sequential")], cfg_mode="batched")
    finally:
        hook.remove()
    assert calls == [8, 8, 4, 4, 4, 4]  # 2 batched steps, then 2 sequential steps of 2 passes
    assert torch.isfinite(batched).all()
    assert th.max_rel_err(th.nchw_to_nhwc(batched), want) < SLICE_TOL
    assert th.max_rel_err(batched, sequential) < SLICE_TOL


@pytest.mark.parametrize("cfg_mode", ["sequential", "batched"])
def test_fused_loop_matches_split_and_jax(sdxl_slice, cfg_mode):
    """loop_mode="fused": every step runs fused_outer, the late ones with
    force_vanilla, against the JAX fused loop and the port's split loop
    (1 warmup step, 2 late steps)."""
    want, (fused, split) = _slice_runs(
        sdxl_slice, "fused_outer", 3, 1, [dict(cfg_mode=cfg_mode, loop_mode="fused"),
                                          dict(cfg_mode=cfg_mode, loop_mode="split")],
        cfg_mode=cfg_mode, loop_mode="fused")
    assert th.max_rel_err(th.nchw_to_nhwc(fused), want) < SLICE_TOL
    assert th.max_rel_err(fused, split) < SLICE_TOL


# force_vanilla in dispatch_attention: f32 on the CPU, the port's plain
# version against the JAX XLA route; a few 1e-7 of max |ref| (summation
# order). 1e-5 catches a forced interior row left interpolated (0.43-1.07
# of max |ref| here).
FORCE_TOL = 1e-5


@pytest.mark.parametrize("endpoints", ["rows", "shared", "per_row_other_length"])
@pytest.mark.parametrize("force", ["true", "false", "per_row"])
@pytest.mark.parametrize("mode", [m.value for m in AttnMode])
def test_force_vanilla_matches_jax_dispatch(mode, force, endpoints):
    """Forced rows are vanilla attention in every mode (fused modes fold the
    force into the skip rows, pure modes substitute each forced row's own
    K/V for both endpoints, and endpoints of another length than the own
    KV's select the vanilla result), the others unchanged; scalar and
    per-row; against the JAX dispatch_attention on the same inputs."""
    B, H, S, D = 4, 2, 12, 8
    q, k, v = (th.normal(60 + i, (B, H, S, D)) for i in range(3))
    coef = np.array([0.0, 0.3, 0.7, 1.0], np.float32)
    fv = {"true": True, "false": False, "per_row": np.array([False, True, False, True])}[force]
    eps = {}
    if endpoints != "rows":
        shape = (H, S, D) if endpoints == "shared" else (B, H, 5, D)
        eps = {n: th.normal(70 + i, shape) for i, n in enumerate(("k_begin", "v_begin", "k_end", "v_end"))}
    want = jax_dispatch(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(coef), mode, backend="xla",
                        force_vanilla=jnp.asarray(fv), **{n: jnp.asarray(x) for n, x in eps.items()})
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    t_fv = fv if isinstance(fv, bool) else torch.from_numpy(fv)
    got = dispatch_attention(tq, tk, tv, torch.from_numpy(coef), mode, force_vanilla=t_fv,
                             **{n: torch.from_numpy(x) for n, x in eps.items()})
    assert th.max_rel_err(got.numpy(), np.asarray(want)) < FORCE_TOL
    rows = np.broadcast_to(np.asarray(fv), (B,)).copy()
    vanilla = _softmax_attn(tq, tk, tv, D ** -0.5)
    torch.testing.assert_close(got[rows], vanilla[rows], rtol=0, atol=FORCE_TOL)
    if mode != "self" and not rows.all():
        free = dispatch_attention(tq, tk, tv, torch.from_numpy(coef), mode,
                                  **{n: torch.from_numpy(x) for n, x in eps.items()})
        torch.testing.assert_close(got[~rows], free[~rows], rtol=0, atol=FORCE_TOL)


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
    """The port never imports jax, flax or the JAX package, nor the
    safetensors package, which the card's machine lacks, nor PIL at import
    (the card's machine is not known to have it; utils/images.py imports it
    inside its functions). Only modules the import itself adds count, so a
    jax preloaded at interpreter start does not."""
    code = ("import sys; before = set(sys.modules); "
            "import aid_tpu_torch, aid_tpu_torch.ops.flash_attention, aid_tpu_torch.ops.conv, "
            "aid_tpu_torch.ops._build, aid_tpu_torch.ops.attention, aid_tpu_torch.models.params, "
            "aid_tpu_torch.models.vae, aid_tpu_torch.models.freeu, aid_tpu_torch.models.unet, "
            "aid_tpu_torch.models.layers, aid_tpu_torch.models.clip, aid_tpu_torch.pipelines.engine, "
            "aid_tpu_torch.pipelines.sdxl, aid_tpu_torch.pipelines.interpolation, "
            "aid_tpu_torch.schedulers.ddim, aid_tpu_torch.utils.tokenizer, aid_tpu_torch.models.loader, "
            "aid_tpu_torch.schedulers.unipc, aid_tpu_torch.schedulers.pndm, aid_tpu_torch.schedulers.edm_dpm, "
            "aid_tpu_torch.utils.safetensors, aid_tpu_torch.models.safety, aid_tpu_torch.utils.watermark, "
            "aid_tpu_torch.prior.clip_scorer, aid_tpu_torch.prior.beta, aid_tpu_torch.prior.bayes, "
            "aid_tpu_torch.prior.dp_solver, aid_tpu_torch.metrics.gini, aid_tpu_torch.metrics.lpips, "
            "aid_tpu_torch.models.ip_adapter, aid_tpu_torch.utils.parity, aid_tpu_torch.utils.profiling, "
            "aid_tpu_torch.utils.images, aid_tpu_torch.parallel, aid_tpu_torch.parallel.mesh, "
            "aid_tpu_torch.apps, aid_tpu_torch.apps.gradio_app; "
            "bad = sorted(m for m in set(sys.modules) - before "
            "if m.split('.')[0] in ('jax', 'flax', 'aid_tpu', 'safetensors', 'PIL')); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
