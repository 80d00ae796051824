"""The rank side of the port's multi-process tests (tests/test_torch_parallel.py).

Imports torch and the port only, never jax: the spawned ranks import this
module, so they stay free of the JAX package (the parent test process
computes the JAX references). :func:`spawn` starts a gloo group of
``world`` processes through a ``FileStore`` (no TCP port, so parallel test
workers never collide), runs every case of a payload in each rank and
returns each rank's results; a rank that raises fails the spawn, and one
that hangs (a collective some rank skipped) is killed at the deadline.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
import torch.distributed as dist

# The collectives a rank may issue; the tests count each per run.
COLLECTIVES = ("all_gather", "all_reduce", "broadcast", "all_gather_into_tensor", "reduce_scatter_tensor",
               "all_to_all", "reduce", "gather", "scatter", "send", "recv")


def spawn(world: int, tmp_path, payload: dict, timeout: float = 300.0) -> list:
    """Run :func:`run_rank` in ``world`` spawned gloo ranks; returns the
    results of every rank, in rank order."""
    import torch.multiprocessing as mp

    store, out = os.path.join(str(tmp_path), "store"), str(tmp_path)
    ctx = mp.start_processes(run_rank, args=(world, store, payload, out), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the {world}-rank group did not finish in {timeout:.0f} s")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(world)]


@contextlib.contextmanager
def counted():
    """Count every ``torch.distributed`` collective called inside."""
    counts = dict.fromkeys(COLLECTIVES, 0)
    real = {name: getattr(dist, name) for name in COLLECTIVES}

    def wrapped(name):
        def call(*args, **kwargs):
            counts[name] += 1
            return real[name](*args, **kwargs)
        return call

    for name in COLLECTIVES:
        setattr(dist, name, wrapped(name))
    try:
        yield counts
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)


@contextlib.contextmanager
def planted(fault):
    """A planted fault of frame sharding: ``"local_endpoints"`` (each shard
    attends its own first and last rows) or ``"local_skip"`` (skip rows by
    local row index)."""
    from aid_tpu_torch.models import layers

    if fault is None:
        yield
        return
    if fault == "local_endpoints":
        cls, name, fake = layers.FrameShard, "endpoints", lambda self, x: (x[0], x[-1])
    else:
        cls, name, fake = layers, "frame_skip_mask", lambda c, offset, total: layers.skip_mask(c, c.shape[0])
    real = getattr(cls, name)
    setattr(cls, name, fake)
    try:
        yield
    finally:
        setattr(cls, name, real)


def make_mesh(spec):
    from aid_tpu_torch.parallel import make_mesh as mesh2d
    from aid_tpu_torch.parallel import make_multislice_mesh

    kind, *dims = spec
    return make_multislice_mesh(*dims, devices="cpu") if kind == "multislice" else mesh2d(*dims, devices="cpu")


def _unet(model):
    from aid_tpu_torch.models.unet import UNet2DCondition

    cfg, state = model
    unet = UNet2DCondition(cfg)
    unet.load_state_dict(state, strict=True)
    return unet.eval()


def _modes(case):
    from aid_tpu_torch.models.layers import AidMode

    ip = case.get("has_ip", False)
    return dict(early=AidMode.from_name(case.get("early", "fused_outer"), has_ip=ip),
                late=AidMode.vanilla(has_ip=ip))


def run_case(case: dict, unets: dict, meshes: dict) -> dict:
    """One case on this rank: a sharded run (``"run"``), the collectives of
    one UNet forward on a frame shard (``"forward"``), a call that must
    raise (``"raises"``), or the mesh's shape and ``shard_frames`` of a
    tensor (``"mesh"``)."""
    from aid_tpu_torch.models.layers import AidContext, FrameShard
    from aid_tpu_torch.parallel import mesh as pm

    if case["mesh"] not in meshes:  # every rank makes the meshes in the same order
        meshes[case["mesh"]] = make_mesh(case["mesh"])
    mesh = meshes[case["mesh"]]
    unet = unets[case["model"]]
    if case.get("tp"):
        unet = pm.shard_params(unet, mesh)
    if case["kind"] == "mesh":
        return {"dims": mesh.mesh_dim_names, "shape": tuple(mesh.shape), "frame_shards": pm.frame_shard_count(mesh),
                "frame_rank": dist.get_rank(pm.frame_group(mesh)),
                "tree": pm.shard_frames((case["tree"], case["tree"][:1]), mesh)}
    if case["kind"] == "forward":
        group = pm.frame_group(mesh)
        n = case["latents"].shape[0]
        b = n // pm.frame_shard_count(mesh)
        lo = dist.get_rank(group) * b
        aid = AidContext(coef=case["coef"][lo:lo + b], mode=_modes(case)["early"], frames=FrameShard(group, lo, n),
                         ip_hidden_states=None if case.get("ip") is None else case["ip"][lo:lo + b])
        with counted() as counts, torch.no_grad():
            unet(case["latents"][lo:lo + b], torch.tensor(500.0), case["embs"][lo:lo + b], aid)
        return {"counts": counts}
    args = (mesh, unet, case["scheduler"], case["latents"], case["embs"], case["uncond"], case["coef"],
            case["state"], 7.5)
    kw = dict(_modes(case), warmup_steps=case.get("warmup", 1), **case.get("kwargs", {}))
    if case["kind"] == "raises":
        try:
            pm.sharded_denoise_sequence(*args, num_steps=case["end"], **kw)
        except ValueError as e:
            return {"error": str(e)}
        return {"error": None}
    before = case["latents"].clone()
    with counted() as counts, planted(case.get("fault")):
        latents, state = pm.sharded_denoise_steps(*args, start=case.get("start", 0), end=case["end"], **kw)
    out = {"latents": latents, "state": state, "counts": counts, "untouched": torch.equal(before, case["latents"])}
    if case.get("tp"):
        out["layout"] = tp_layout(unet)
    return out


def tp_layout(unet) -> dict:
    """How many projections ``shard_params`` split: column-parallel ``to_q``
    and row-parallel ``to_out.0`` / ``net.2``."""
    from aid_tpu_torch.models.layers import CrossAttention
    from aid_tpu_torch.parallel.mesh import RowParallelLinear

    attn = [m for m in unet.modules() if isinstance(m, CrossAttention)]
    # the UNets' attention is as wide as its input, so a split to_q is narrower
    return {"col": sum(m.to_q.out_features < m.to_q.in_features for m in attn),
            "row": sum(isinstance(m, RowParallelLinear) for m in unet.modules())}


def run_rank(rank: int, world: int, store: str, payload: dict, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
    try:
        unets = {name: _unet(model) for name, model in payload["models"].items()}
        meshes = {}
        results = {name: run_case(case, unets, meshes) for name, case in payload["cases"].items()}
        torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
