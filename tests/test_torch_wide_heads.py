"""Head dims past 512: the port against aid_tpu, and the wide entries replayed.

An SD 1.x UNet with one head a level has heads 320, 640 and 1280 wide; the
JAX wrapper takes padded head dims up to 2048 (bf16, f16) and 1024 (f32)
(aid_tpu/ops/flash_attention.py:806-816), its XLA path any. Same seeded numpy
inputs through both packages on the CPU:
  * the port's plain version and ``dispatch_attention`` against JAX's
    ``dispatch_attention`` on its XLA path, at D = 520 / 640 / 1024 / 1280 /
    2048, every mode, bf16 / f16 / f32, skip rows, endpoints shared or per
    row of their own length;
  * a subset against the Pallas kernel in interpret mode, as
    tests/test_flash_attention.py runs it;
  * the wide entries (csrc/flash_attention_dwide.cu) replayed from their C
    arguments (``kernel_operands``): the operands read through the dims'
    strides, zero-filled past D and past each segment, the eight warps'
    column slices and their partial scores summed in warp order, key tiles
    of the kernel's size (``dwide_tiles``) with P rounded to the input type
    and each tile's P V folded into O, the outer modes' state parked word for
    word in the workspace; planted
    faults (a slice normalised over its own chunk's scores, a wrong chunk of
    Q, a thread-major read-back) miss the bound by orders of magnitude;
  * a tiny UNet with one head a level (widths 544 and 576) against the JAX
    UNet.
The kernels themselves are held to the plain version on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py phases 3 and 22).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_helpers as th
from aid_tpu.models.layers import AidContext as JaxAidContext
from aid_tpu.models.layers import AidMode as JaxAidMode
from aid_tpu.models.params import convert_unet_state_dict
from aid_tpu.ops.attention import dispatch_attention as jax_dispatch_attention
from aid_tpu.ops.flash_attention import flash_interpolated_attention as jax_flash
from aid_tpu_torch.models import configs
from aid_tpu_torch.models.layers import AidContext, AidMode
from aid_tpu_torch.models.unet import UNet2DCondition
from aid_tpu_torch.ops.attention import AttnMode, dispatch_attention
from aid_tpu_torch.ops.flash_attention import (
    DWIDE,
    DWIDE_ENTRIES,
    DWIDE_PARK_FLOATS,
    dwide_tiles,
    flash_interpolated_attention,
    flash_interpolated_attention_plain,
    kernel_operands,
    padded_head_dim,
)
from aid_tpu_torch.utils.flops import count_flops

MODES = [m.value for m in AttnMode]
WIDE_DIMS = [520, 640, 1024, 1280, 2048]
DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}
JAX_DTYPES = {"bf16": jnp.bfloat16, "f16": jnp.float16, "f32": jnp.float32}

# Both packages round the inputs once to the dtype, take f32 logits and an
# f32 softmax, round P to the dtype before P V and the output once: what
# differs is exp and the order of f32 sums, which may flip one rounding of P
# or of the output. One output ulp is 2^-8 (bf16) / 2^-11 (f16) of the
# element; the bounds are a few ulps of max |ref| (measured: 2.5e-3 / 4.9e-4).
# f32: summation order only (1.2e-6 of max |ref| measured); 1e-5 as
# tests/test_torch_ops.py.
XLA_TOL = {"bf16": 1e-2, "f16": 2e-3, "f32": 1e-5}
# The Pallas kernel is an online softmax: it rounds the unnormalised tile
# probabilities to the dtype, the plain version the normalised ones (bf16:
# the kernels' ATTN_RTOL; f32: tests/test_torch_ops.py's FLASH_TOL).
FLASH_TOL = {"bf16": 2e-2, "f16": 5e-3, "f32": 1e-4}
# The replay in f32 against the plain version: the same roundings as the
# kernel (P at each tile, unnormalised) against the plain version's (P
# normalised), the tile rescaling chain, and the output rounded once
# (measured: bf16 4.3e-3, f16 5.4e-4, f32 9.7e-7 of max |ref|); the bf16 and
# f16 bounds are the card tests' ATTN_RTOL and F16_ATTN_RTOL.
REPLAY_TOL = {"bf16": 2e-2, "f16": 5e-3, "f32": 1e-5}


def _inputs(D, dtype, ep, seed, B=3, H=2, S=24, L=40, Le=17):
    """q (B, H, S, D) as a (B, S, H*D) projection viewed by heads (strided),
    k / v (B, H, L, D) the same way, coefficients with both endpoint rows,
    skip rows 0 and B-1, and endpoints: None (rows 0 and B-1), shared (H,
    Le, D) or per row (B, H, Le, D), all numpy f32 values that ``dtype``
    holds exactly."""
    def heads(x):
        return np.ascontiguousarray(x).reshape(x.shape[0], x.shape[1], H, D).transpose(0, 2, 1, 3)

    def rounded(x):
        return torch.from_numpy(x).to(DTYPES[dtype]).float().numpy()

    q = heads(rounded(th.normal(seed, (B, S, H * D))))
    k, v = (heads(rounded(th.normal(seed + i, (B, L, H * D)))) for i in (1, 2))
    coef = np.linspace(0, 1, B).astype(np.float32)
    skip = np.zeros(B, bool)
    skip[0] = skip[-1] = True
    eps = {}
    if ep:
        shape = (H, Le, D) if ep == "shared" else (B, H, Le, D)
        eps = {n: rounded(th.normal(seed + 10 + i, shape)) for i, n in enumerate(("k_begin", "v_begin", "k_end",
                                                                                   "v_end"))}
    return q, k, v, coef, skip, eps


def _torch(x, dtype):
    # from the transposed numpy view: the port sees strided heads, as the model passes them
    return torch.from_numpy(np.asarray(x)).to(DTYPES[dtype])


def _jax(x, dtype):
    return jnp.asarray(x).astype(JAX_DTYPES[dtype])


def _err(got, want):
    def f32(x):
        return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)
    return th.max_rel_err(f32(got), f32(want))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("D", WIDE_DIMS)
def test_plain_and_dispatch_match_jax_xla(D, mode, dtype):
    """The plain version (fused-mode skip rows attend their own K/V) and
    dispatch_attention (skip rows, and the same rows forced vanilla) against
    JAX's dispatch_attention on its XLA path, endpoints from the rows, shared
    and per row of their own length."""
    for ep in (None, "shared", "per_row"):
        if ep and mode == "self":
            continue
        q, k, v, coef, skip, eps = _inputs(D, dtype, ep, seed=D + 7 * MODES.index(mode))
        fused = AttnMode(mode).is_fused
        jargs = [_jax(x, dtype) for x in (q, k, v)] + [jnp.asarray(coef)]
        jeps = {n: _jax(e, dtype) for n, e in eps.items()}
        targs = [_torch(x, dtype) for x in (q, k, v)] + [torch.from_numpy(coef)]
        teps = {n: _torch(e, dtype) for n, e in eps.items()}
        want = jax_dispatch_attention(*jargs, mode, backend="xla", force_vanilla=jnp.asarray(skip) if fused else None,
                                      **jeps)
        got = flash_interpolated_attention_plain(*targs, mode, skip_endpoints=torch.from_numpy(skip), **teps)
        assert got.dtype == DTYPES[dtype] and got.shape == tuple(want.shape)
        assert _err(got, want) < XLA_TOL[dtype], ("plain", ep)
        got = dispatch_attention(*targs, mode, skip_endpoints=torch.from_numpy(skip), **teps)
        assert _err(got, want) < XLA_TOL[dtype], ("dispatch", ep)
        if mode != "self":
            want = jax_dispatch_attention(*jargs, mode, backend="xla", force_vanilla=jnp.asarray(skip), **jeps)
            got = dispatch_attention(*targs, mode, force_vanilla=torch.from_numpy(skip), **teps)
            assert _err(got, want) < XLA_TOL[dtype], ("force_vanilla", ep)


# where the JAX Pallas wrapper takes the head dim (its 512 KB block budget:
# padded D up to 2048 in 2-byte types, 1024 in f32)
PALLAS_CASES = [("bf16", 640), ("bf16", 2048), ("f16", 1280), ("f32", 520), ("f32", 1024)]


@pytest.mark.parametrize("dtype,D", PALLAS_CASES)
@pytest.mark.parametrize("mode", MODES)
def test_wrapper_matches_pallas_interpret(dtype, D, mode):
    """The port's wrapper (its plain route on the CPU) against the Pallas
    kernel in interpret mode: skip rows (dropped in fused modes), shared
    endpoints of their own length outside self mode."""
    ep = None if mode == "self" else "shared"
    q, k, v, coef, skip, eps = _inputs(D, dtype, ep, seed=900 + D, S=16, L=24, Le=9)
    want = jax_flash(*[_jax(x, dtype) for x in (q, k, v)], jnp.asarray(coef), mode,
                     skip_endpoints=jnp.asarray(skip), block_q=64, block_k=64, interpret=True,
                     **{n: _jax(e, dtype) for n, e in eps.items()})
    got = flash_interpolated_attention(*[_torch(x, dtype) for x in (q, k, v)], torch.from_numpy(coef), mode,
                                       skip_endpoints=torch.from_numpy(skip),
                                       **{n: _torch(e, dtype) for n, e in eps.items()})
    assert _err(got, want) < FLASH_TOL[dtype]


def test_padded_head_dim_past_512():
    """513..2048 maps to the operands' head dim with 16-byte rows (a
    multiple of 8), in every mode; past 2048 raises, as the JAX wrapper
    does past its budget."""
    for mode in MODES:
        assert [padded_head_dim(D, mode) for D in (513, 520, 521, 640, 1000, 1280, 2041, 2048)] == [
            520, 520, 528, 640, 1000, 1280, 2048, 2048]
        with pytest.raises(NotImplementedError):
            padded_head_dim(2049, mode)
    # (padded D, rows a block, keys a tile): 32 / 16 keys where the Q tile and
    # one K and one V tile fit in 227 KB beside the scores
    assert [dwide_tiles(D) for D in (520, 640, 896, 1024, 1032, 1280, 1408, 2048)] == [
        (640, 32, 32), (640, 32, 32), (896, 32, 32), (1024, 32, 16), (1152, 16, 32), (1280, 16, 32),
        (1408, 16, 16), (2048, 16, 16)]
    assert [dwide_tiles(D, torch.float32) for D in (640, 1024, 1280, 2048)] == [
        (640, 32, 16), (1024, 32, 8), (1280, 16, 8), (2048, 16, 8)]
    assert dwide_tiles(640, torch.float16) == dwide_tiles(640)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", MODES)
def test_kernel_operands_wide(dtype, mode):
    """The wide entries' C arguments: the entry of the dtype in every mode
    (self included), dims[5] the caller's D where its rows are 16-byte
    multiples and the operands passed as they are (no padding copy; the
    kernel zero-fills past D), the output a (B, Sq, H, D) buffer, the outer
    modes' workspace one DWIDE_PARK_FLOATS block per 32 or 16 rows; a head
    dim off the 8-element grid is padded, with the scale kept."""
    q, k, v, coef, skip, eps = _inputs(640, dtype, "shared" if mode != "self" else None, seed=5)
    tq, tk, tv = (_torch(x, dtype) for x in (q, k, v))
    ops = kernel_operands(tq, tk, tv, torch.from_numpy(coef), mode, skip_endpoints=torch.from_numpy(skip),
                          **{n: _torch(e, dtype) for n, e in eps.items()})
    assert ops["entry"] == DWIDE_ENTRIES[DTYPES[dtype]]
    assert ops["dims"][5] == 640 and ops["tensors"][0] is tq and ops["tensors"][1] is tk
    assert ops["tensors"][7].transpose(1, 2).is_contiguous() and ops["out"].shape == tq.shape
    if AttnMode(mode).is_outer:
        assert tuple(ops["work"].shape) == (3 * 2 * math.ceil(24 / 32), DWIDE_PARK_FLOATS)
    else:
        assert ops["work"] is None
    assert ops["has_own"] == int(mode in ("self", "fused_outer", "fused_inner"))
    q5 = torch.zeros(2, 1, 20, 1001, dtype=DTYPES[dtype])
    ops = kernel_operands(q5, q5, q5, None, mode)
    assert ops["dims"][5] == 1008 and ops["tensors"][0].shape[-1] == 1008 and ops["scale"] == 1001 ** -0.5
    assert tuple(ops["out"].shape) == (2, 1, 20, 1001)
    with pytest.raises(NotImplementedError):
        kernel_operands(torch.zeros(1, 1, 4, 2056), torch.zeros(1, 1, 4, 2056), torch.zeros(1, 1, 4, 2056))


# ---------------------------------------------------------------------------
# The wide entries replayed from their C arguments

WARPS, THREADS, SLOTS, ROWS_MAX = 8, 256, 32, 32


def _strided(x, dims, i, shape):
    """Operand i as the kernel reads it: (b, h, s) element strides from the
    C arguments (a b stride of 0: one tensor shared by every row)."""
    sb, sh, ss = dims[6 + 3 * i: 9 + 3 * i]
    return x.as_strided(shape, (sb, sh, ss, 1))


def _park_index(block, Sq, Dp, BQ):
    """Word index in the workspace of each O element (row r < Sq of the
    block's rows, column c < Dp): word 4 i + e of thread tid at (4 i + e) *
    256 + tid, where warp c // (Dp / 8) holds the column, slot i = mi * (32
    / row blocks) + nj its n8 tile, lane 4 g + t its accumulator pair, e its
    place in it."""
    r, c = torch.arange(Sq).reshape(-1, 1), torch.arange(Dp).reshape(1, -1)
    rr = r % BQ
    mi, g, hf = rr // 16, rr % 8, (rr % 16) // 8
    Dw = Dp // WARPS
    w, cc = c // Dw, c % Dw
    nj, t, e = cc // 8, (cc % 8) // 2, 2 * hf + c % 2
    tid = w * 32 + 4 * g + t
    slot = mi * (SLOTS // (BQ // 16)) + nj
    return block[r // BQ] * DWIDE_PARK_FLOATS + (4 * slot + e) * THREADS + tid, slot, tid


def _emulate_dwide_kernel(ops, fault=None):
    """The wide entry's output rebuilt from its C arguments in its order of
    work (csrc/flash_attention_dwide.cu), in f32: per (b, h), all query
    rows; each warp's slice of Dp / 8 columns takes its partial scores over
    its slice of Q and K, the softmax sums the eight in warp order, each
    warp's P V covers its slice of V; key tiles of ``dwide_tiles``'s size
    over each segment, zero-filled past its length and past D, P rounded to the input
    type, each tile's product folded into O; the outer modes' first set
    parked in ``ops["work"]`` at the set boundaries. ``fault``: "own_chunk"
    (each slice's softmax over its own partial scores), "q_chunk" (each warp
    reads the next warp's slice of Q), "thread_major" (the parked words read
    back thread by thread)."""
    q, k, v, kb, vb, ke, ve, out = ops["tensors"]
    dims = ops["dims"]
    B, H, Sq, Lk, Le, D = dims[:6]
    dtype = q.dtype
    f32 = dtype == torch.float32
    Dp, BQ, BK = dwide_tiles(D, dtype)
    Dw = Dp // WARPS
    assert ops["entry"] == DWIDE_ENTRIES[dtype] and D <= DWIDE
    scale_log2 = float(np.float32(ops["scale"]) * np.float32(1.4426950408889634))
    has_own, n_sets = ops["has_own"], ops["n_sets"]
    n_blocks_x = -(-Sq // BQ)
    work = None if ops["work"] is None else ops["work"].reshape(-1)
    if n_sets == 2:
        assert work.numel() == B * H * n_blocks_x * DWIDE_PARK_FLOATS
        work.fill_(math.nan)  # a word read before it is written poisons the result

    def padded(x):  # the zero fill past D
        return torch.nn.functional.pad(x.float(), (0, Dp - D))

    ops_q = padded(_strided(q, dims, 0, (B, H, Sq, D)))
    seg = [(padded(_strided(x, dims, i, (B, H, n, D))), padded(_strided(y, dims, i + 1, (B, H, n, D))), n)
           for i, (x, y, n) in ((1, (k, v, Lk)), (3, (kb, vb, Le)), (5, (ke, ve, Le)))]
    res = torch.zeros(B, H, Sq, Dp)
    for b in range(B):
        skip = bool(has_own and n_sets and ops["skip"] is not None and ops["skip"][b])
        outer = n_sets == 2 and not skip
        order = ([0] if has_own else []) + ([] if skip else [1, 2][:n_sets])
        for h in range(H):
            block = (b * H + h) * n_blocks_x + torch.arange(n_blocks_x)
            idx, _, _ = _park_index(block, Sq, Dp, BQ)
            Q = ops_q[b, h].reshape(Sq, WARPS, Dw)
            if fault == "q_chunk":
                Q = Q.roll(-1, dims=1)
            m = torch.full((WARPS, Sq), -math.inf)
            l = torch.zeros(WARPS, Sq)
            o = torch.zeros(Sq, WARPS, Dw)
            for s in order:
                K, V, n = seg[s][0][b, h], seg[s][1][b, h], seg[s][2]
                for r0 in range(0, n, BK):
                    Kt, Vt = torch.zeros(BK, Dp), torch.zeros(BK, Dp)
                    Kt[:min(BK, n - r0)], Vt[:min(BK, n - r0)] = K[r0:r0 + BK], V[r0:r0 + BK]
                    part = torch.einsum("qwd,kwd->wqk", Q, Kt.reshape(BK, WARPS, Dw))
                    if fault == "own_chunk":
                        sc = part
                    else:
                        sc = part[0].clone()
                        for w in range(1, WARPS):  # warp order
                            sc = sc + part[w]
                        sc = sc.expand(WARPS, Sq, BK)
                    x = sc * scale_log2
                    x[..., min(BK, n - r0):] = -math.inf
                    m_new = torch.maximum(m, x.amax(-1))
                    p = torch.exp2(x - m_new[..., None])
                    a = torch.exp2(m - m_new)
                    l = l * a + p.sum(-1)
                    m = m_new
                    p = p if f32 else p.to(dtype).float()
                    pv = torch.einsum("wqk,kwd->qwd", p, Vt.reshape(BK, WARPS, Dw))
                    o = o * a.T[..., None] + pv
                    if not outer or s == 2:
                        continue
                    if r0 + BK >= n and s == 0:  # park the own segment's state
                        work[idx.reshape(-1)] = o.reshape(Sq, Dp).reshape(-1)
                        rows = block[torch.arange(Sq) // BQ] * DWIDE_PARK_FLOATS + 128 * THREADS
                        work[rows + torch.arange(Sq) % BQ] = m[0]
                        work[rows + ROWS_MAX + torch.arange(Sq) % BQ] = l[0]
                    elif r0 + BK >= n and s == 1:  # swap (1 - c) O / l with it, or park it
                        o = o * ((1.0 - ops["coef"][b]) / l.T[..., None])
                        back = idx if fault != "thread_major" else _thread_major(idx, block, Sq, Dp, BQ)
                        own = work[back.reshape(-1)].reshape(Sq, WARPS, Dw).clone() if has_own else None
                        work[idx.reshape(-1)] = o.reshape(-1)
                        if has_own:
                            o = own
                            rows = block[torch.arange(Sq) // BQ] * DWIDE_PARK_FLOATS + 128 * THREADS
                            m = work[rows + torch.arange(Sq) % BQ].expand(WARPS, Sq).clone()
                            l = work[rows + ROWS_MAX + torch.arange(Sq) % BQ].expand(WARPS, Sq).clone()
                        else:
                            o = torch.zeros_like(o)
                            m, l = torch.full((WARPS, Sq), -math.inf), torch.zeros(WARPS, Sq)
            if outer:
                o = o * (ops["coef"][b] / l.T[..., None]) + work[idx.reshape(-1)].reshape(Sq, WARPS, Dw)
            else:
                o = o / l.T[..., None]
            res[b, h] = o.reshape(Sq, Dp)
    stored = _strided(out, dims, 7, (B, H, Sq, out.shape[-1]))
    stored.copy_(res[..., :out.shape[-1]].to(dtype))
    return ops["out"]


def _thread_major(idx, block, Sq, Dp, BQ):
    """The workspace read back thread by thread (word w of thread tid at tid
    * 128 + w): a planted fault."""
    _, slot, tid = _park_index(block, Sq, Dp, BQ)
    word = (idx - block[torch.arange(Sq) // BQ].reshape(-1, 1) * DWIDE_PARK_FLOATS - tid) // THREADS
    return block[torch.arange(Sq) // BQ].reshape(-1, 1) * DWIDE_PARK_FLOATS + tid * 128 + word


def _replay_inputs(D, dtype, mode, ep, seed):
    q, k, v, coef, skip, eps = _inputs(D, dtype, ep, seed, S=40, L=23, Le=9)
    args = [_torch(x, dtype) for x in (q, k, v)] + [torch.from_numpy(coef), mode]
    return args, dict(skip_endpoints=torch.from_numpy(skip), **{n: _torch(e, dtype) for n, e in eps.items()})


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("D", [520, 640, 1280, 2048])
def test_dwide_replay_matches_plain(D, mode, dtype):
    """The wide entry replayed from its C arguments matches the plain
    version: 40 queries (a 32- or 16-row block and a ragged one), 23 own keys
    and 9 endpoint keys ragged against every key tile, skip rows,
    endpoints from the rows (pure modes) or shared (fused modes)."""
    ep = "shared" if AttnMode(mode).is_fused else None
    args, kw = _replay_inputs(D, dtype, mode, ep, seed=300 + D)
    if mode == "self":
        kw = {}
    got = _emulate_dwide_kernel(kernel_operands(*args, **kw))
    want = flash_interpolated_attention_plain(*args, **kw)
    assert got.dtype == DTYPES[dtype] and got.shape == want.shape
    assert _err(got, want) < REPLAY_TOL[dtype]


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("fault", ["own_chunk", "q_chunk", "thread_major"])
def test_dwide_replay_planted_faults_are_seen(dtype, fault):
    """Each planted fault misses the replay's bound by orders of magnitude:
    the bound is sharp enough to see a slice normalised over its own chunk,
    a wrong chunk of Q, or the parked words read back thread by thread
    (fused_outer at D = 640 and 1280, per-row endpoints)."""
    for D in (640, 1280):
        args, kw = _replay_inputs(D, dtype, "fused_outer", "per_row", seed=400 + D)
        want = flash_interpolated_attention_plain(*args, **kw)
        sound = _err(_emulate_dwide_kernel(kernel_operands(*args, **kw)), want)
        err = _err(_emulate_dwide_kernel(kernel_operands(*args, **kw), fault=fault), want)
        # a NaN (a parked word read before it was written) misses the bound too
        assert sound < REPLAY_TOL[dtype] and not err <= 10 * REPLAY_TOL[dtype], (D, sound, err)


# ---------------------------------------------------------------------------
# A tiny UNet with one head a level

# f32 on both sides; as tests/test_torch_models.py's FWD_TOL.
FWD_TOL = 1e-4
WIDE_UNET = dataclasses.replace(configs.TINY_UNET, block_out_channels=(544, 576), num_attention_heads=(1, 1),
                                norm_num_groups=32)


@pytest.fixture(scope="module")
def wide_unets():
    """The port's UNet at WIDE_UNET with seeded weights, and the JAX UNet with
    the same weights carried across by the JAX package's converter (its
    flax init at these widths is the slow part, so the port's state dict
    is the source)."""
    from aid_tpu.models import UNet2DCondition as JaxUNet

    unet = th.seed_module(UNet2DCondition(WIDE_UNET), 31)
    params = jax.tree_util.tree_map(np.asarray, convert_unet_state_dict(unet.state_dict()))
    return JaxUNet(WIDE_UNET), params, unet


@pytest.mark.parametrize("mode", ["self", "fused_outer"])
def test_wide_head_unet_matches_jax(wide_unets, monkeypatch, mode):
    """Heads 544 and 576 wide (one a level, GroupNorm 32): the port's forward
    against the JAX UNet's, every attention call at a head dim past 512
    (counted as it passes), and the FLOP counts equal."""
    from aid_tpu.utils.flops import count_flops as jax_count_flops

    jax_model, params, unet = wide_unets
    B, s = 3, WIDE_UNET.sample_size
    x = th.normal(1, (B, s, s, WIDE_UNET.in_channels), 0.5)
    ehs = th.normal(2, (B, 77, WIDE_UNET.cross_attention_dim))
    coef = np.array([0.0, 0.4, 1.0], np.float32)

    def jax_forward(p, x, e, c):
        aid = None if mode == "self" else JaxAidContext(coef=c, mode=JaxAidMode.from_name(mode))
        return jax_model.apply(p, x, jnp.array(321.0), e, aid, None)

    jargs = (th.to_jnp(params), jnp.asarray(x), jnp.asarray(ehs), jnp.asarray(coef))
    want = jax.jit(jax_forward)(*jargs)
    aid = None if mode == "self" else AidContext(coef=torch.from_numpy(coef), mode=AidMode.from_name(mode))
    seen = set()
    from aid_tpu_torch.ops import flash_attention

    real = flash_attention.flash_interpolated_attention

    def spy(q, *a, **kw):
        seen.add(q.shape[-1])
        return real(q, *a, **kw)

    monkeypatch.setattr(flash_attention, "flash_interpolated_attention", spy)

    def forward():
        return unet(th.nhwc_to_nchw(x), torch.tensor(321.0), torch.from_numpy(ehs), aid, None)

    with torch.no_grad():
        got = forward()
    assert seen == {544, 576}
    assert th.max_rel_err(th.nchw_to_nhwc(got), np.asarray(want)) < FWD_TOL
    assert count_flops(forward) == jax_count_flops(jax_forward, *jargs)
