"""Multi-GPU sharding: frame-axis data parallelism and tensor parallelism.

Counterpart of ``aid_tpu.parallel.mesh``, on ``torch.distributed``. The
JAX package states its sharding as ``NamedSharding`` specs and lets GSPMD
or ``shard_map`` partition its jitted programs; PyTorch runs eagerly, so
here every rank runs its own part and the collectives are explicit calls.

  * ``data`` mesh dim: the frame axis. Each frame's denoise is independent
    given the endpoint K/V, so every rank denoises a contiguous slice of the
    frames. Every interpolating attention layer all-gathers the boundary
    K/V rows of the shards over the frame group and keeps the GLOBAL frames
    0 and N-1 (``models.layers.FrameShard``): four all-gathers of one
    (H, L, D) row each per layer, the only traffic between frame shards.
    ``sharded_denoise_sequence`` is the port of the JAX ``shard_map`` path
    (mesh.py:141-224); the hand-written kernels run on each rank's frames.
  * ``model`` mesh dim: tensor parallelism over attention heads and
    feed-forward hidden units (``shard_params``): the megatron column / row
    splits of the JAX ``_param_spec`` (mesh.py:106-138), each row-parallel
    projection followed by an all-reduce over the model group.
  * ``make_multislice_mesh`` adds an outer ``dcn`` dim: frames shard over
    ``dcn`` x ``data`` (say, hosts x the GPUs of a host), TP stays inside.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over every rank of
the default process group (launched by ``torchrun`` or initialised by the
caller); its device type is ``"cuda"`` unless the caller asks for
``"cpu"`` (gloo). Parameters are replicated: every rank holds the whole UNet
(or, after ``shard_params``, its TP slice of it).

Not ported: ``frame_sharding`` / ``replicated`` (``NamedSharding`` specs
for GSPMD; the port places no tensor by a spec, each rank slices its own).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from aid_tpu_torch.models.layers import CrossAttention, FeedForward, FrameShard

DATA_AXIS = "data"
MODEL_AXIS = "model"
DCN_AXIS = "dcn"

# Per-frame keyword inputs of the engine, sliced with the frames (mesh.py:180-187)
FRAME_KWARGS = ("ip_embeds", "ip_uncond_embeds", "added_cond", "added_cond_uncond")


def _world(device_type: str) -> int:
    if not dist.is_initialized():  # torchrun's environment
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
    return dist.get_world_size()


def make_mesh(dp: Optional[int] = None, tp: int = 1, devices: Optional[str] = None):
    """A (data, model) mesh over every rank; ``dp`` defaults to the world
    size over ``tp``. ``devices`` is the mesh's device type, ``"cuda"``
    unless the caller asks for ``"cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = devices or "cuda"
    world = _world(device_type)
    dp = world // tp if dp is None else dp
    if dp * tp != world:
        raise ValueError(f"a {dp} x {tp} mesh needs {dp * tp} ranks; the world has {world}")
    return init_device_mesh(device_type, (dp, tp), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def make_multislice_mesh(dp_dcn: int, dp_ici: Optional[int] = None, tp: int = 1, devices: Optional[str] = None):
    """A (dcn, data, model) mesh: frames shard over dcn x data, TP inside a
    data shard (mesh.py:61-81). Every rank also creates the frame groups,
    one per model index over its dcn x data ranks, in the same order."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = devices or "cuda"
    world = _world(device_type)
    dp_ici = world // (dp_dcn * tp) if dp_ici is None else dp_ici
    if dp_dcn * dp_ici * tp != world:
        raise ValueError(f"a {dp_dcn} x {dp_ici} x {tp} mesh needs {dp_dcn * dp_ici * tp} ranks; the world has {world}")
    mesh = init_device_mesh(device_type, (dp_dcn, dp_ici, tp), mesh_dim_names=(DCN_AXIS, DATA_AXIS, MODEL_AXIS))
    me = dist.get_rank()
    for m in range(tp):
        ranks = mesh.mesh[:, :, m].flatten().tolist()
        group = dist.new_group(ranks)
        if me in ranks:
            mesh._aid_frame_group = group
    return mesh


def frame_axes(mesh):
    """The mesh dims the frame axis shards over: ("dcn", "data") on a
    multislice mesh, else "data"."""
    return (DCN_AXIS, DATA_AXIS) if DCN_AXIS in mesh.mesh_dim_names else DATA_AXIS


def _dim_size(mesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def frame_shard_count(mesh) -> int:
    ax = frame_axes(mesh)
    return _dim_size(mesh, DATA_AXIS) * (_dim_size(mesh, DCN_AXIS) if isinstance(ax, tuple) else 1)


def frame_group(mesh):
    """The process group over this rank's frame shards; its rank is the
    shard index (dcn-major on a multislice mesh)."""
    return mesh._aid_frame_group if isinstance(frame_axes(mesh), tuple) else mesh.get_group(DATA_AXIS)


def _map(fn, tree):
    """``fn`` on every tensor of a nest of dicts, lists, tuples and
    NamedTuples (a scheduler state); every other leaf as it is."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def _gather_frames(x: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def shard_frames(tree, mesh):
    """This rank's contiguous slice of every tensor in ``tree`` whose
    leading axis divides the frame shards; every other leaf whole."""
    dp = frame_shard_count(mesh)
    r = dist.get_rank(frame_group(mesh))

    def part(x):
        if x.dim() >= 1 and x.shape[0] % dp == 0:
            b = x.shape[0] // dp
            return x[r * b:(r + 1) * b]
        return x

    return _map(part, tree)


def sharded_denoise_steps(mesh, unet, scheduler, latents, embs, uncond_embs, coef, sched_state, guidance_scale, *,
                          early, late, start: int, end: int, warmup_steps: int, **kwargs):
    """``engine.denoise_steps`` with the frames sharded over ``mesh``;
    returns the whole ``(latents, sched_state)`` on every rank.

    Every rank calls it with the whole inputs. Each runs the steps on its
    contiguous slice of the frames (latents, embeds, coefficients, the
    per-frame ``FRAME_KWARGS`` leaf by leaf, and every scheduler-state
    tensor of dim >= 4: a multistep history handed in mid-schedule,
    mesh.py:205-209), with its ``FrameShard`` on every AID forward, then
    all-gathers the latents and those state tensors. The caller's tensors
    are never written. Refused: frame counts that do not divide the
    shards, batched CFG (layers.py:430-431) and DDIM's ``eta > 0``, whose
    step noise a shard cannot draw as the unsharded run draws it."""
    from aid_tpu_torch.pipelines import engine

    if kwargs.get("cfg_mode", "sequential") == "batched":
        raise ValueError("batched CFG is not supported under frame sharding")
    if kwargs.get("eta", 0.0) > 0.0:
        raise ValueError("eta > 0 is not supported under frame sharding: the step noise would differ from the "
                         "unsharded run's")
    dp, group = frame_shard_count(mesh), frame_group(mesh)
    n = latents.shape[0]
    if n % dp:
        raise ValueError(f"{n} frames do not divide into {dp} frame shards")
    b = n // dp
    lo = dist.get_rank(group) * b

    def rows(x):
        if x.shape[0] != n:
            raise ValueError(f"a per-frame input has {x.shape[0]} rows, not the {n} frames")
        return x[lo:lo + b]

    kwargs = {k: _map(rows, v) if k in FRAME_KWARGS and v is not None else v for k, v in kwargs.items()}
    state = _map(lambda x: rows(x) if x.dim() >= 4 else x, sched_state)
    out, state = engine.denoise_steps(
        unet, scheduler, rows(latents), rows(embs), rows(uncond_embs), None if coef is None else rows(coef), state,
        guidance_scale, early=early, late=late, start=start, end=end, warmup_steps=warmup_steps,
        frames=FrameShard(group, lo, n), **kwargs)
    return _gather_frames(out, group), _map(lambda x: _gather_frames(x, group) if x.dim() >= 4 else x, state)


def sharded_denoise_sequence(mesh, unet, scheduler, latents, embs, uncond_embs, coef, sched_state, guidance_scale, *,
                             early, late, num_steps: int, warmup_steps: int, **kwargs) -> torch.Tensor:
    """``engine.denoise_sequence`` with the frames sharded over ``mesh``
    (mesh.py:141-224): steps ``[0, num_steps)`` of
    :func:`sharded_denoise_steps`; every rank returns the whole sequence's
    final latents."""
    latents, _ = sharded_denoise_steps(mesh, unet, scheduler, latents, embs, uncond_embs, coef, sched_state,
                                       guidance_scale, early=early, late=late, start=0, end=num_steps,
                                       warmup_steps=warmup_steps, **kwargs)
    return latents


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

class RowParallelLinear(nn.Module):
    """``nn.Linear`` with its input features split over the model group:
    each rank multiplies its slice of the input by its columns of the
    weight, an all-reduce sums the partial outputs in their dtype (as the
    JAX layout's psum does) and the bias is added once. Parameter names stay
    ``weight`` / ``bias``."""

    def __init__(self, linear: nn.Linear, cols: slice, group):
        super().__init__()
        self.weight = nn.Parameter(linear.weight.detach()[:, cols].contiguous(), requires_grad=False)
        self.bias = None if linear.bias is None else nn.Parameter(linear.bias.detach(), requires_grad=False)
        self.group = group

    def forward(self, x):
        y = F.linear(x, self.weight)
        dist.all_reduce(y, group=self.group)
        return y if self.bias is None else y + self.bias


def _keep_rows(linear: nn.Linear, rows: torch.Tensor) -> None:
    """Column-parallel: ``linear`` keeps the output features ``rows``."""
    linear.weight = nn.Parameter(linear.weight.detach()[rows].contiguous(), requires_grad=False)
    if linear.bias is not None:
        linear.bias = nn.Parameter(linear.bias.detach()[rows].contiguous(), requires_grad=False)
    linear.out_features = int(rows.numel())


def shard_params(unet, mesh):
    """The megatron TP layout of the JAX ``_param_spec`` / ``shard_params``
    (mesh.py:106-138), made eager: a new UNet whose every untouched tensor
    IS the caller's (shared), and whose attention and feed-forward blocks
    hold this rank's slice over the ``model`` dim.

    Column-parallel: ``to_q``, ``to_k``, ``to_v``, ``to_k_ip``, ``to_v_ip``
    keep this rank's ``H / tp`` heads, and the GEGLU up-projection this
    rank's rows of its ``hidden`` half and the same rows of its ``gate``
    half, so each pair stays together. Row-parallel: ``to_out.0`` and the
    down-projection ``net.2`` become :class:`RowParallelLinear`. A block
    whose head count (attention) or hidden width (feed-forward) does not
    divide ``tp`` stays whole on every rank, as the JAX layout falls back to
    ``P()``; no projection is split without its pair. Convs, norms and
    embeddings are replicated."""
    tp = _dim_size(mesh, MODEL_AXIS)
    with torch.device("meta"):
        out = type(unet)(unet.config, dtype=unet.dtype)
    out.load_state_dict(unet.state_dict(), strict=True, assign=True)
    out.eval()
    if tp == 1:
        return out
    r, group = mesh.get_local_rank(MODEL_AXIS), mesh.get_group(MODEL_AXIS)
    for m in list(out.modules()):
        if isinstance(m, CrossAttention) and m.num_heads % tp == 0:
            width = m.num_heads // tp * m.head_dim
            rows = torch.arange(r * width, (r + 1) * width, device=m.to_q.weight.device)
            for name in ("to_q", "to_k", "to_v", "to_k_ip", "to_v_ip"):
                if hasattr(m, name):
                    _keep_rows(getattr(m, name), rows)
            m.to_out[0] = RowParallelLinear(m.to_out[0], slice(r * width, (r + 1) * width), group)
            m.num_heads //= tp
        elif isinstance(m, FeedForward) and m.net[2].in_features % tp == 0:
            inner = m.net[2].in_features
            width = inner // tp
            half = torch.arange(r * width, (r + 1) * width, device=m.net[2].weight.device)
            _keep_rows(m.net[0].proj, torch.cat([half, inner + half]))  # [hidden | gate], each split alike
            m.net[2] = RowParallelLinear(m.net[2], slice(r * width, (r + 1) * width), group)
    return out
