"""The port's frame and tensor parallelism on gloo groups of 2 and 4 CPU processes.

Mirrors tests/test_parallel.py on the port's tiny configs (TINY_UNET,
TINY_UNET_IP, TINY_SDXL_UNET) in f32: 8 frames, 2 DDIM steps, fused_outer
then self, guidance 7.5. Each sharded run (``parallel.sharded_denoise_steps``
in spawned ranks, tests/torch_dist_helpers.py) is held against the port's
unsharded ``engine.denoise_steps`` on the same inputs and against the JAX
package's ``sharded_denoise_sequence`` on its 8-device virtual CPU mesh
(tests/conftest.py), and every rank must return the same whole sequence.
All cases of one world size run in one spawn; the ranks never import jax.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_helpers as tdh
import torch_helpers as th
from aid_tpu.models.layers import AidMode as JaxAidMode
from aid_tpu.parallel import make_mesh as jax_make_mesh
from aid_tpu.parallel import make_multislice_mesh as jax_multislice_mesh
from aid_tpu.parallel import sharded_denoise_sequence as jax_sharded
from aid_tpu.schedulers.ddim import DDIMScheduler as JaxDDIM
from aid_tpu_torch.models import configs
from aid_tpu_torch.models.layers import CrossAttention, FeedForward
from aid_tpu_torch.ops.interp import generate_beta_schedule
from aid_tpu_torch.parallel import mesh as pm
from aid_tpu_torch.pipelines import engine
from aid_tpu_torch.schedulers.ddim import DDIMScheduler
from aid_tpu_torch.schedulers.pndm import PNDMScheduler
from aid_tpu_torch.schedulers.unipc import UniPCScheduler

# Against the JAX package, as tests/test_torch_engine.py holds the engine:
# the per-forward ~1e-6 relative difference of the two packages grows through
# the guidance and 2 steps; 1e-4 of max |ref| fails on any real fault.
SLICE_TOL = 1e-4
# Against the port's own unsharded run: the same f32 arithmetic at a smaller
# batch (and, under TP, partial sums added by an all-reduce) reorders
# matmul sums, ~2e-6 of max |ref| after 2 steps; 1e-5 leaves 5x room.
SHARD_TOL = 1e-5
FRAMES, STEPS = 8, 2
# A coefficient list with 0 and 1 in the interior: at dp=4 shard 1's first
# row (frame 2) is 0 and shard 2's last row (frame 5) is 1, so local skip
# rows would drop their endpoint segments.
TRAP_COEF = np.array([0.0, 0.2, 0.0, 0.5, 0.6, 1.0, 0.8, 1.0], np.float32)
MODELS = {"sd": (configs.TINY_UNET, 3), "ip": (configs.TINY_UNET_IP, 5), "xl": (configs.TINY_SDXL_UNET, 7)}


def _inputs(cfg, seed, coef=None):
    """numpy NHWC latents, embeds and coefficients of an 8-frame sequence."""
    s, d = cfg.sample_size, cfg.cross_attention_dim
    ins = dict(latents=th.normal(seed, (FRAMES, s, s, cfg.in_channels)), embs=th.normal(seed + 1, (FRAMES, 77, d)),
               uncond=th.normal(seed + 2, (FRAMES, 77, d)),
               coef=generate_beta_schedule(FRAMES, 3, 3, force_endpoints=True) if coef is None else coef)
    kwargs = {}
    if cfg.ip_num_tokens:
        kwargs = dict(ip_embeds=th.normal(seed + 3, (FRAMES, cfg.ip_num_tokens, d)),
                      ip_uncond_embeds=th.normal(seed + 4, (FRAMES, cfg.ip_num_tokens, d)), ip_scale=0.7)
    added = th.sdxl_added_cond(cfg, FRAMES, seed + 5)
    if added is not None:
        kwargs = dict(added_cond=added, added_cond_uncond=dict(added, text_embeds=th.normal(seed + 6, (FRAMES, 24))))
    return ins, kwargs


def _torch_kwargs(kwargs):
    return {k: th.to_torch(v) if isinstance(v, dict) else torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in kwargs.items()}


def _case(model, mesh, coef=None, scheduler=None, steps=STEPS, **extra):
    """A sharded-run case of the payload: torch inputs, scheduler and state."""
    cfg, seed = MODELS[model]
    ins, kwargs = _inputs(cfg, 10 * seed, coef)
    scheduler = scheduler or DDIMScheduler()
    case = dict(kind="run", model=model, mesh=mesh, scheduler=scheduler, latents=th.nhwc_to_nchw(ins["latents"]),
                embs=torch.from_numpy(ins["embs"]), uncond=torch.from_numpy(ins["uncond"]),
                coef=torch.from_numpy(ins["coef"]), state=scheduler.init(steps), end=steps,
                kwargs=_torch_kwargs(kwargs), has_ip=model == "ip", numpy=(ins, kwargs))
    case.update(extra)
    return case


def _unsharded(unets, case):
    """The port's unsharded run of a case: (latents, state)."""
    return engine.denoise_steps(
        unets[case["model"]], case["scheduler"], case["latents"], case["embs"], case["uncond"], case["coef"],
        case["state"], 7.5, start=case.get("start", 0), end=case["end"], warmup_steps=case.get("warmup", 1),
        **tdh._modes(case), **case.get("kwargs", {}))


def _jax_run(jax_models, case, mesh):
    """The JAX package's sharded_denoise_sequence of a case on ``mesh``."""
    jmodel, params = jax_models[case["model"]]
    ins, kwargs = case["numpy"]
    kw = {k: th.to_jnp(v) if isinstance(v, dict) else jnp.asarray(v) if isinstance(v, np.ndarray) else v
          for k, v in kwargs.items()}
    ip = case["has_ip"]
    sched = JaxDDIM()
    return np.asarray(jax_sharded(
        mesh, jmodel, sched, th.to_jnp(params), jnp.asarray(ins["latents"]), jnp.asarray(ins["embs"]),
        jnp.asarray(ins["uncond"]), jnp.asarray(ins["coef"]), sched.init(STEPS), jnp.float32(7.5),
        early=JaxAidMode.from_name("fused_outer", has_ip=ip), late=JaxAidMode.vanilla(has_ip=ip),
        num_steps=STEPS, warmup_steps=1, **kw))


@pytest.fixture(scope="module")
def models():
    """The JAX models with their params, and the port's UNets loaded from them."""
    jax_models, unets = {}, {}
    for name, (cfg, seed) in MODELS.items():
        jax_models[name] = th.jax_unet_and_params(cfg, seed=seed)
        unets[name] = th.port_unet(cfg, jax_models[name][1])
    return jax_models, unets


def _payload(unets, cases):
    strip = {name: {k: v for k, v in case.items() if k != "numpy"} for name, case in cases.items()}
    return {"models": {name: (MODELS[name][0], unets[name].state_dict()) for name in MODELS}, "cases": strip}


def _jax_meshes():
    """The JAX meshes the cases' ``jax`` entries name (a case without one is
    held against the port's own unsharded run only)."""
    d = jax.devices()
    return {"dp2": jax_make_mesh(dp=2, tp=1, devices=d[:2]), "dp4": jax_make_mesh(dp=4, tp=1, devices=d[:4]),
            "dp2_tp2": jax_make_mesh(dp=2, tp=2, devices=d[:4]),
            "multislice": jax_multislice_mesh(dp_dcn=2, dp_ici=2, tp=1)}


WORLD2 = {
    "dp2": dict(mesh=("dp", 2, 1), jax="dp2"),
    "dp2_fused_loop": dict(mesh=("dp", 2, 1), kwargs_extra=dict(loop_mode="fused")),
    "dp2_pure_inner": dict(mesh=("dp", 2, 1), early="pure_inner"),
}
WORLD4 = {
    "dp4": dict(mesh=("dp", 4, 1), jax="dp4"),
    "dp4_local_endpoints": dict(mesh=("dp", 4, 1), fault="local_endpoints"),
    "skip_trap": dict(mesh=("dp", 4, 1), coef=TRAP_COEF, jax="dp4"),
    "skip_trap_local_skip": dict(mesh=("dp", 4, 1), coef=TRAP_COEF, fault="local_skip"),
    "ip": dict(model="ip", mesh=("dp", 4, 1), jax="dp4"),
    "sdxl": dict(model="xl", mesh=("dp", 4, 1), jax="dp4"),
    "multislice": dict(mesh=("multislice", 2, 2, 1), jax="multislice"),
    "multislice_tp": dict(mesh=("multislice", 2, 1, 2), tp=True),
    "dp2_tp2": dict(mesh=("dp", 2, 2), tp=True, jax="dp2_tp2"),
    "dp2_tp2_ip": dict(model="ip", mesh=("dp", 2, 2), tp=True),
}


def _cases(spec):
    cases, jax_of = {}, {}
    for name, s in spec.items():
        s = dict(s)
        jax_of[name] = s.pop("jax", None)
        extra = s.pop("kwargs_extra", {})
        case = _case(s.pop("model", "sd"), s.pop("mesh"), coef=s.pop("coef", None), **s)
        case["kwargs"].update(extra)
        cases[name] = case
    return cases, jax_of


def _mid_schedule_cases(unets):
    """UniPC and PNDM handed the state of an unsharded run's first 2 steps
    of 4 (multistep history in it), for steps [2, end)."""
    cases = {}
    for name, sched in (("unipc_mid", UniPCScheduler()), ("pndm_mid", PNDMScheduler())):
        case = _case("sd", ("dp", 4, 1), scheduler=sched, steps=4, warmup=3)
        case["end"] = 2
        latents, state = _unsharded(unets, case)
        case.update(latents=latents, state=state, start=2, end=len(state.timesteps))
        cases[name] = case
    return cases


def _other_cases():
    """The calls that must raise, the collectives of one forward, and the meshes' shapes."""
    base = _case("sd", ("dp", 4, 1))
    six = _case("sd", ("dp", 4, 1))
    six.update(latents=six["latents"][:6], embs=six["embs"][:6], uncond=six["uncond"][:6], coef=six["coef"][:6])
    ip = _case("ip", ("dp", 4, 1))
    return {
        "raises_batched_cfg": dict(base, kind="raises", kwargs=dict(cfg_mode="batched")),
        "raises_indivisible": dict(six, kind="raises"),
        "raises_eta": dict(base, kind="raises", kwargs=dict(eta=0.5, generator=None)),
        "forward_text": dict(base, kind="forward"),
        "forward_ip": dict(ip, kind="forward", early="pure_outer", ip=ip["kwargs"]["ip_embeds"]),
        "forward_tp": dict(base, kind="forward", mesh=("dp", 2, 2), tp=True),
        "mesh_dp4": dict(base, kind="mesh", tree=base["latents"]),
        "mesh_multislice": dict(base, kind="mesh", mesh=("multislice", 2, 2, 1), tree=base["latents"]),
        "mesh_multislice_tp": dict(base, kind="mesh", mesh=("multislice", 2, 1, 2), tree=base["latents"]),
    }


@pytest.fixture(scope="module")
def world2(models, tmp_path_factory):
    jax_models, unets = models
    cases, jax_of = _cases(WORLD2)
    ranks = tdh.spawn(2, tmp_path_factory.mktemp("world2"), _payload(unets, cases))
    return cases, jax_of, ranks


@pytest.fixture(scope="module")
def world4(models, tmp_path_factory):
    jax_models, unets = models
    cases, jax_of = _cases(WORLD4)
    cases.update(_mid_schedule_cases(unets))
    cases.update(_other_cases())
    ranks = tdh.spawn(4, tmp_path_factory.mktemp("world4"), _payload(unets, cases))
    return cases, jax_of, ranks


@pytest.fixture(scope="module")
def jax_meshes():
    return _jax_meshes()


def _check_run(models, world, name, jax_meshes=None):
    """Every rank's latents bit-equal, within SHARD_TOL of the port's
    unsharded run and (where the case names a mesh) within SLICE_TOL of the
    JAX package's sharded run. Returns (sharded, unsharded) latents."""
    jax_models, unets = models
    cases, jax_of, ranks = world
    got = ranks[0][name]["latents"]
    for r in ranks:
        assert torch.equal(r[name]["latents"], got), "the ranks returned different sequences"
        assert r[name]["untouched"], "the caller's latents were written"
    want, _ = _unsharded(unets, cases[name])
    assert torch.isfinite(got).all() and got.shape == want.shape
    assert th.max_rel_err(got, want) < SHARD_TOL
    if jax_of.get(name) is not None:
        ref = _jax_run(jax_models, cases[name], jax_meshes[jax_of[name]])
        assert th.max_rel_err(th.nchw_to_nhwc(got), ref) < SLICE_TOL
    return got, want


@pytest.mark.parametrize("name", list(WORLD2))
def test_world2_matches_unsharded_and_jax(models, world2, jax_meshes, name):
    """dp=2: the split and the fused loop (force_vanilla late step), fused_outer and pure_inner."""
    _check_run(models, world2, name, jax_meshes)


@pytest.mark.parametrize("name", ["dp4", "skip_trap", "ip", "sdxl", "multislice", "multislice_tp", "dp2_tp2",
                                  "dp2_tp2_ip"])
def test_world4_matches_unsharded_and_jax(models, world4, jax_meshes, name):
    """dp=4 (2 frames a shard: the endpoints are global frames 0 and 7),
    interior 0/1 coefficients, IP embeds (ip_scale 0.7) and SDXL
    added_cond / added_cond_uncond sharded, the dcn=2 x data=2 multislice
    mesh, dcn=2 x model=2, and dp=2 x tp=2 with and without IP."""
    _check_run(models, world4, name, jax_meshes)


@pytest.mark.parametrize("sound,fault", [("dp4", "dp4_local_endpoints"), ("skip_trap", "skip_trap_local_skip")])
def test_planted_fault_is_caught(models, world4, sound, fault):
    """Each shard's own rows 0 / B-1 as endpoints, and skip rows by local row
    index on interior 0/1 coefficients, move the sequence by far more than
    SLICE_TOL: the sound runs above pass because the endpoints and skip rows
    are global."""
    _, unets = models
    cases, _, ranks = world4
    want, _ = _unsharded(unets, cases[sound])
    assert th.max_rel_err(ranks[0][fault]["latents"], want) > 10 * SLICE_TOL


def _leaves(tree):
    """The tensors of a scheduler state, in field order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


@pytest.mark.parametrize("name", ["unipc_mid", "pndm_mid"])
def test_mid_schedule_state_is_sharded(models, world4, name):
    """A multistep state handed in mid-schedule: its latent-shaped history
    (UniPC m_prev / m_prev2 / last_sample, PNDM ets / cur_sample) is
    sliced with the frames and gathered back."""
    _, unets = models
    cases, _, ranks = world4
    want, want_state = _unsharded(unets, cases[name])
    got, got_state = ranks[0][name]["latents"], ranks[0][name]["state"]
    assert th.max_rel_err(got, want) < SHARD_TOL
    history = [(a, b) for a, b in zip(_leaves(got_state), _leaves(want_state)) if a.dim() >= 4]
    assert history and all(a.shape == b.shape and th.max_rel_err(a, b) < SHARD_TOL for a, b in history)


def test_errors_raise_on_every_rank(world4):
    """Batched CFG, frames that do not divide the shards, and DDIM's eta > 0 raise ValueError."""
    _, _, ranks = world4
    for r in ranks:
        assert "batched CFG" in r["raises_batched_cfg"]["error"]
        assert "do not divide" in r["raises_indivisible"]["error"]
        assert "eta" in r["raises_eta"]["error"]


def _attention_layers(unet, cross_only=False):
    return [m for name, m in unet.named_modules() if isinstance(m, CrossAttention)
            and (not cross_only or name.endswith("attn2"))]


def test_collectives_per_forward(models, world4):
    """The endpoint all-gather is the only frame-parallel traffic: 4 a
    forward per interpolating attention layer (k and v, first and last
    rows), 4 more per IP branch in an interpolating IP mode, and nothing
    else; dp=2 x tp=2 adds one all-reduce per row-parallel projection. A
    whole dp=4 run issues all-gathers only."""
    _, unets = models
    _, _, ranks = world4
    n_attn = len(_attention_layers(unets["sd"]))
    n_ip = len(_attention_layers(unets["ip"], cross_only=True))
    n_ff = sum(isinstance(m, FeedForward) for m in unets["sd"].modules())
    for r in ranks:
        text, ip, tp = r["forward_text"]["counts"], r["forward_ip"]["counts"], r["forward_tp"]["counts"]
        assert text == dict(dict.fromkeys(tdh.COLLECTIVES, 0), all_gather=4 * n_attn)
        assert ip == dict(dict.fromkeys(tdh.COLLECTIVES, 0), all_gather=4 * (len(_attention_layers(unets["ip"])) + n_ip))
        assert tp == dict(dict.fromkeys(tdh.COLLECTIVES, 0), all_gather=4 * n_attn, all_reduce=n_attn + n_ff)
        run = r["dp4"]["counts"]
        assert run["all_gather"] > 0 and sum(run.values()) == run["all_gather"]


def test_tp_param_layout(models, world4):
    """dp=2 x tp=2: every attention's to_q / to_k / to_v column-parallel and
    every to_out.0 and feed-forward net.2 row-parallel (TINY_UNET's 2 heads
    and 4x hidden widths divide 2)."""
    _, unets = models
    _, _, ranks = world4
    n_attn = len(_attention_layers(unets["sd"]))
    n_ff = sum(isinstance(m, FeedForward) for m in unets["sd"].modules())
    assert ranks[0]["dp2_tp2"]["layout"] == {"col": n_attn, "row": n_attn + n_ff}


@pytest.mark.parametrize("name,shape,shards", [("mesh_dp4", (4, 1), 4), ("mesh_multislice", (2, 2, 1), 4),
                                               ("mesh_multislice_tp", (2, 1, 2), 2)])
def test_mesh_shapes_and_shard_frames(world4, name, shape, shards):
    """The meshes' dims and shape, their frame-shard count, and
    ``shard_frames``: each rank's contiguous slice of the frames."""
    cases, _, ranks = world4
    full = cases[name]["tree"]
    b = full.shape[0] // shards
    for r in ranks:
        info = r[name]
        assert info["dims"] == (("dcn", "data", "model") if len(shape) == 3 else ("data", "model"))
        assert info["shape"] == shape and info["frame_shards"] == shards
        i = info["frame_rank"]
        assert torch.equal(info["tree"][0], full[i * b:(i + 1) * b]) and torch.equal(info["tree"][1], full[:1])


class _StubMesh:
    """A one-process stand-in for a (data, model) DeviceMesh: ``shard_params``
    reads only the model dim's size, this rank's index on it and its group."""

    mesh_dim_names = ("data", "model")

    def __init__(self, tp, rank):
        self.tp, self.rank = tp, rank

    def size(self, dim):
        return (1, self.tp)[dim]

    def get_local_rank(self, name):
        return self.rank

    def get_group(self, name):
        return None


def test_geglu_split_keeps_hidden_and_gate_paired(models):
    """Each rank's GEGLU up-projection holds the same rows of the hidden and
    the gate half, so the ranks' partial down-projections sum to the whole
    feed-forward."""
    _, unets = models
    unet = unets["sd"]
    ff = next(m for m in unet.modules() if isinstance(m, FeedForward))
    path = next(name for name, m in unet.named_modules() if m is ff)
    inner = ff.net[2].in_features
    x = torch.from_numpy(th.normal(90, (2, 5, ff.net[0].proj.in_features)))
    total = 0
    for r in range(2):
        part = pm.shard_params(unet, _StubMesh(2, r)).get_submodule(path)
        half = torch.arange(r * inner // 2, (r + 1) * inner // 2)
        rows = torch.cat([half, inner + half])
        assert torch.equal(part.net[0].proj.weight, ff.net[0].proj.weight[rows])
        assert torch.equal(part.net[0].proj.bias, ff.net[0].proj.bias[rows])
        total = total + torch.nn.functional.linear(part.net[0](x), part.net[2].weight)
    with torch.no_grad():
        torch.testing.assert_close(total + ff.net[2].bias, ff(x), rtol=1e-5, atol=1e-6)


def test_indivisible_blocks_stay_whole(models):
    """tp=3 divides neither TINY_UNET's 2 heads nor its hidden widths: no
    projection is split, and every tensor is the caller's own."""
    _, unets = models
    unet = unets["sd"]
    sharded = pm.shard_params(unet, _StubMesh(3, 1))
    assert not any(isinstance(m, pm.RowParallelLinear) for m in sharded.modules())
    mine = unet.state_dict()
    assert all(v.data_ptr() == mine[k].data_ptr() for k, v in sharded.state_dict().items())
