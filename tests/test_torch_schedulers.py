"""The port's schedulers against aid_tpu's: DDIM, UniPC, PNDM and EDM DPM++.

Same seeded numpy samples and model outputs through both, f32 on the CPU,
over the prediction types and the timestep spacings (and for DDIM
``clip_sample``). The multistep schedulers are fed the JAX output as the
next step's sample, so both carry the same history. DDIM's eta > 0 draws its
noise from a torch.Generator (JAX draws from its own keys), so that case
checks shapes and statistics only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_helpers as th
from aid_tpu.schedulers.base import SchedulerConfig as JaxSchedulerConfig
from aid_tpu.schedulers.ddim import DDIMScheduler as JaxDDIM
from aid_tpu.schedulers.edm_dpm import EDMDPMSolverScheduler as JaxEDM
from aid_tpu.schedulers.pndm import PNDMScheduler as JaxPNDM
from aid_tpu.schedulers.unipc import UniPCScheduler as JaxUniPC
from aid_tpu_torch.schedulers import EDMDPMSolverScheduler, PNDMScheduler, UniPCScheduler
from aid_tpu_torch.schedulers.base import SchedulerConfig
from aid_tpu_torch.schedulers.ddim import DDIMScheduler

STEPS = 10
# f32 on both sides, the same formulas: only the order of a few f32 ops can
# differ (XLA may fuse them), ~1e-7 of the sample's scale per step.
STEP_TOL = 1e-5


def _pair(**cfg):
    return DDIMScheduler(SchedulerConfig(**cfg)), JaxDDIM(JaxSchedulerConfig(**cfg))


@pytest.mark.parametrize("spacing", ["leading", "trailing", "linspace"])
@pytest.mark.parametrize("clip_sample", [False, True])
@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction", "sample"])
def test_ddim_steps_match_jax(prediction_type, clip_sample, spacing):
    sched, jsched = _pair(prediction_type=prediction_type, clip_sample=clip_sample, timestep_spacing=spacing)
    state, jstate = sched.init(STEPS), jsched.init(STEPS)
    np.testing.assert_array_equal(state.timesteps.numpy(), np.asarray(jstate.timesteps))
    assert state.timesteps.dtype == torch.int64 and state.init_noise_sigma == jstate.init_noise_sigma == 1.0
    x = th.normal(0, (2, 4, 8, 8))
    for i in range(STEPS):
        out = th.normal(100 + i, (2, 4, 8, 8))
        got, state = sched.step(state, torch.from_numpy(out), i, torch.from_numpy(x))
        want, jstate = jsched.step(jstate, jnp.asarray(out), i, jnp.asarray(x))
        assert got.dtype == torch.float32
        assert th.max_rel_err(got.numpy(), np.asarray(want)) < STEP_TOL, f"step {i}"
        x = np.array(want)


@pytest.mark.parametrize("set_alpha_to_one", [False, True])
def test_ddim_final_alpha_rule_matches_jax(set_alpha_to_one):
    """The last step's previous timestep is negative: it takes
    final_alpha_cumprod (1 or alphas_cumprod[0])."""
    sched, jsched = _pair(set_alpha_to_one=set_alpha_to_one, steps_offset=0)
    state, jstate = sched.init(4), jsched.init(4)
    x, out = th.normal(1, (1, 4, 4, 4)), th.normal(2, (1, 4, 4, 4))
    got, _ = sched.step(state, torch.from_numpy(out), 3, torch.from_numpy(x))
    want, _ = jsched.step(jstate, jnp.asarray(out), 3, jnp.asarray(x))
    assert th.max_rel_err(got.numpy(), np.asarray(want)) < STEP_TOL
    want_prev = 1.0 if set_alpha_to_one else float(jstate.alphas_cumprod[0])
    assert float(state.alpha_prod_prev[3]) == np.float32(want_prev)


def test_ddim_keeps_sample_dtype_and_device_tables():
    sched = DDIMScheduler()
    state = sched.init(5)
    x = torch.from_numpy(th.normal(3, (1, 4, 4, 4))).to(torch.bfloat16)
    out, _ = sched.step(state, torch.from_numpy(th.normal(4, (1, 4, 4, 4))), 0, x)
    assert out.dtype == torch.bfloat16
    assert sched.scale_model_input(state, x, 0) is x
    for table in (state.alpha_prod, state.alpha_prod_prev, state.alphas_cumprod):
        assert table.dtype == torch.float32 and table.device == x.device
    noised = sched.add_noise(state, torch.zeros(3), torch.ones(3), 999)
    want = JaxDDIM().add_noise(JaxDDIM().init(5), jnp.zeros(3), jnp.ones(3), 999)
    np.testing.assert_allclose(noised.numpy(), np.asarray(want), rtol=1e-6)


def test_ddim_eta_noise_statistics():
    """eta > 0: prev = (deterministic part) + std * N(0, 1), std =
    eta * sqrt(variance). The noise has that std, comes from the generator
    (same seed, same bits), and eta = 0 needs no generator."""
    sched = DDIMScheduler()
    state = sched.init(STEPS)
    x = torch.from_numpy(th.normal(5, (4, 4, 64, 64)))
    out = torch.from_numpy(th.normal(6, (4, 4, 64, 64)))
    i, eta = 3, 0.7
    with pytest.raises(ValueError):
        sched.step(state, out, i, x, eta=eta)
    a_t, a_prev = state.alpha_prod[i].double(), state.alpha_prod_prev[i].double()
    std = eta * torch.sqrt((1 - a_prev) / (1 - a_t) * (1 - a_t / a_prev))
    # the deterministic part of an eta step: the direction term shrinks with std
    pred_x0 = (x.double() - torch.sqrt(1 - a_t) * out.double()) / torch.sqrt(a_t)
    mean = torch.sqrt(a_prev) * pred_x0 + torch.sqrt(1 - a_prev - std ** 2) * out.double()
    got, _ = sched.step(state, out, i, x, eta=eta, generator=torch.Generator().manual_seed(0))
    again, _ = sched.step(state, out, i, x, eta=eta, generator=torch.Generator().manual_seed(0))
    assert got.shape == x.shape and torch.isfinite(got).all()
    torch.testing.assert_close(got, again, rtol=0, atol=0)
    z = (got.double() - mean) / std  # ~N(0, 1) over 65536 draws
    assert abs(z.mean().item()) < 0.02 and abs(z.std().item() - 1.0) < 0.02


# The multistep schedulers compute their per-step coefficients on the host in
# float64 where the JAX package computes them in f32 on the device; the
# difference is a few f32 ulps of each coefficient (bh2's phi_3 loses ~1e-6
# of its value to cancellation in f32 at these step sizes) times a
# correction term far smaller than the sample. The same STEP_TOL, 1e-5 of
# max |ref|, holds every step; a wrong order, history slot, boundary or
# prediction form moves a step by >= 1e-3.
MULTISTEP = {"unipc": (UniPCScheduler, JaxUniPC), "pndm": (PNDMScheduler, JaxPNDM)}


def _run_pair(sched, jsched, steps, shape=(2, 4, 8, 8), seed=0):
    """Step both schedulers over every timestep, feeding the JAX output to
    both as the next sample; assert each step within STEP_TOL."""
    state, jstate = sched.init(steps), jsched.init(steps, latent_shape=shape)
    np.testing.assert_allclose(state.timesteps.numpy(), np.asarray(jstate.timesteps), rtol=1e-6)
    assert state.init_noise_sigma == pytest.approx(jstate.init_noise_sigma, rel=1e-6)
    x = th.normal(seed, shape)
    for i in range(state.timesteps.shape[0]):
        out = th.normal(200 + seed + i, shape)
        xin = sched.scale_model_input(state, torch.from_numpy(x), i)
        jxin = jsched.scale_model_input(jstate, jnp.asarray(x), i)
        assert th.max_rel_err(xin.numpy(), np.asarray(jxin)) < STEP_TOL
        got, state = sched.step(state, torch.from_numpy(out), i, torch.from_numpy(x))
        want, jstate = jsched.step(jstate, jnp.asarray(out), i, jnp.asarray(x))
        assert got.dtype == torch.float32 and got.shape == shape
        assert th.max_rel_err(got.numpy(), np.asarray(want)) < STEP_TOL, f"step {i}"
        x = np.array(want)
    return state, jstate


@pytest.mark.parametrize("spacing", ["leading", "trailing"])
@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("name", sorted(MULTISTEP))
def test_multistep_steps_match_jax(name, prediction_type, spacing):
    """UniPC and PNDM step by step; PNDM over its n + 1 timesteps."""
    cls, jcls = MULTISTEP[name]
    cfg = dict(prediction_type=prediction_type, timestep_spacing=spacing)
    state, jstate = _run_pair(cls(SchedulerConfig(**cfg)), jcls(JaxSchedulerConfig(**cfg)), STEPS)
    n_evals = STEPS + 1 if name == "pndm" else STEPS
    assert state.timesteps.shape[0] == n_evals and state.num_inference_steps == STEPS


def test_unipc_sample_prediction_and_spacing_rule():
    """The "sample" branch, and the JAX rule that UniPC's timesteps are
    linspace over n + 1 points whatever the spacing and offset."""
    cfg = dict(prediction_type="sample")
    _run_pair(UniPCScheduler(SchedulerConfig(**cfg)), JaxUniPC(JaxSchedulerConfig(**cfg)), 6)
    a = UniPCScheduler(SchedulerConfig(timestep_spacing="leading", steps_offset=1)).init(25).timesteps
    b = UniPCScheduler(SchedulerConfig(timestep_spacing="trailing", steps_offset=0)).init(25).timesteps
    torch.testing.assert_close(a, b)
    assert int(a[0]) == 999 and int(a[-1]) == 40


def test_pndm_timesteps_repeat_second_entry():
    state = PNDMScheduler().init(5)
    ts = state.timesteps.tolist()
    assert ts == [801, 601, 601, 401, 201, 1]
    with pytest.raises(NotImplementedError):
        PNDMScheduler(skip_prk_steps=False).init(5)


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_edm_dpm_steps_match_jax(prediction_type):
    """Karras sigmas, c_noise timesteps, EDM preconditioning and the 2M
    update; add_noise by step index."""
    kw = dict(sigma_min=0.002, sigma_max=80.0, sigma_data=0.5, prediction_type=prediction_type)
    state, jstate = _run_pair(EDMDPMSolverScheduler(**kw), JaxEDM(**kw), STEPS)
    x, noise = th.normal(7, (1, 4, 4, 4)), th.normal(8, (1, 4, 4, 4))
    got = EDMDPMSolverScheduler(**kw).add_noise(state, torch.from_numpy(x), torch.from_numpy(noise), 3)
    want = JaxEDM(**kw).add_noise(jstate, jnp.asarray(x), jnp.asarray(noise), 3)
    assert th.max_rel_err(got.numpy(), np.asarray(want)) < STEP_TOL


@pytest.mark.parametrize("name", ["unipc", "pndm"])
def test_multistep_add_noise_matches_jax(name):
    cls, jcls = MULTISTEP[name]
    x, noise = th.normal(9, (1, 4, 4, 4)), th.normal(10, (1, 4, 4, 4))
    got = cls().add_noise(cls().init(5), torch.from_numpy(x), torch.from_numpy(noise), 501)
    want = jcls().add_noise(jcls().init(5), jnp.asarray(x), jnp.asarray(noise), 501)
    assert th.max_rel_err(got.numpy(), np.asarray(want)) < STEP_TOL


@pytest.mark.parametrize("name", ["unipc", "pndm", "edm"])
def test_multistep_keeps_sample_dtype(name):
    """bf16 latents in, bf16 out; the history stays f32."""
    sched = {"unipc": UniPCScheduler(), "pndm": PNDMScheduler(), "edm": EDMDPMSolverScheduler()}[name]
    state = sched.init(4)
    x = torch.from_numpy(th.normal(11, (1, 4, 4, 4))).to(torch.bfloat16)
    for i in range(3):
        x, state = sched.step(state, torch.from_numpy(th.normal(12 + i, (1, 4, 4, 4))), i, x)
        assert x.dtype == torch.bfloat16
    history = [t for t in state[2:] if isinstance(t, torch.Tensor)] + list(getattr(state, "ets", ()))
    assert history and all(t.dtype == torch.float32 for t in history)
