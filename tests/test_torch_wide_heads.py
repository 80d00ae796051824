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
    strides, zero-filled past D and past each segment, key tiles, the two
    warpgroups' 64-column chunks and their partial scores added, P rounded
    to the input type and each tile's P V folded into O, the outer modes'
    states parked in the workspace, the key stream split across blocks where
    the grid is under one wave (``dwide_split``) and the splits' states
    merged as the combine step merges them, or the block finishing unsplit;
    planted faults (a warpgroup's softmax over its own partial scores, a
    wrong chunk of Q, a thread-major read-back, splits combined without
    their rescale) miss the bound by orders of magnitude;
  * the static-shift softmax past 512: the plain version's against the
    Pallas kernel's static branch in interpret mode, and the static wide
    entries (csrc/flash_attention_dwide_static.cu) replayed the same way,
    P = 2^min(s scale log2 e - C log2 e, 30 log2 e) with no max, each
    chunk's P V added with no factor, the combine step O = sum O_s / sum
    l_s; planted faults (each split normalised alone, the shift left in a
    per-tile rescale, the clip dropped) miss the bound;
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
    STATIC_DWIDE_ENTRIES,
    STATIC_SHIFT_C,
    dwide_split,
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


@pytest.mark.parametrize("dtype,D", [c for c in PALLAS_CASES if c[0] != "f16"])
@pytest.mark.parametrize("mode", MODES)
def test_plain_static_shift_matches_pallas_interpret(dtype, D, mode):
    """The plain static shift (static_smax = STATIC_SHIFT_C; what the static
    wide entries are held to on the card) against the Pallas `_kernel`'s
    static branch (aid_tpu/ops/flash_attention.py:210-256; onepass_max 0) in
    interpret mode past 512, as the exact case above: skip rows, shared
    endpoints of their own length outside self mode; on logits inside the
    window (scale D^-0.5) and far past its top (scale 32 / sqrt(D): the clip
    binds), where the two softmaxes both clip."""
    ep = None if mode == "self" else "shared"
    q, k, v, coef, skip, eps = _inputs(D, dtype, ep, seed=950 + D, S=16, L=24, Le=9)
    for scale in (D ** -0.5, 32.0 / math.sqrt(D)):
        want = jax_flash(*[_jax(x, dtype) for x in (q, k, v)], jnp.asarray(coef), mode,
                         skip_endpoints=jnp.asarray(skip), block_q=64, block_k=64, interpret=True, onepass_max=0,
                         static_smax=STATIC_SHIFT_C, scale=scale, **{n: _jax(e, dtype) for n, e in eps.items()})
        got = flash_interpolated_attention_plain(*[_torch(x, dtype) for x in (q, k, v)], torch.from_numpy(coef), mode,
                                                 skip_endpoints=torch.from_numpy(skip), scale=scale,
                                                 static_smax=STATIC_SHIFT_C,
                                                 **{n: _torch(e, dtype) for n, e in eps.items()})
        assert torch.isfinite(got).all()
        assert _err(got, want) < FLASH_TOL[dtype], scale


def test_padded_head_dim_past_512():
    """513..2048 maps to the operands' head dim with 16-byte rows (a
    multiple of 8), in every mode; past 2048 raises, as the JAX wrapper does
    past its budget. The kernel computes the first of 640 / 1024 / 1280 /
    2048 columns at or above it, for 32 or 16 query rows a block in 128-key
    tiles (bf16, f16) or 16 or 8 in 64-key tiles (f32: Q and lo(Q) stay in
    shared memory),
    and splits a row block's key stream where its grid is under 132 blocks."""
    for mode in MODES:
        assert [padded_head_dim(D, mode) for D in (513, 520, 521, 640, 1000, 1280, 2041, 2048)] == [
            520, 520, 528, 640, 1000, 1280, 2048, 2048]
        with pytest.raises(NotImplementedError):
            padded_head_dim(2049, mode)
    # (padded D, rows a block, keys a tile)
    assert [dwide_tiles(D) for D in (520, 640, 896, 1024, 1032, 1280, 1408, 2048)] == [
        (640, 32, 128), (640, 32, 128), (1024, 32, 128), (1024, 32, 128), (1280, 16, 128), (1280, 16, 128),
        (2048, 16, 128), (2048, 16, 128)]
    assert [dwide_tiles(D, torch.float32) for D in (640, 1024, 1280, 2048)] == [
        (640, 16, 64), (1024, 8, 64), (1280, 8, 64), (2048, 8, 64)]
    assert dwide_tiles(640, torch.float16) == dwide_tiles(640)
    # (row blocks, key tiles) -> blocks a row block's stream is split across:
    # phase 22's (7,1,64,1280) fused_outer, (2,1,512,2048) self, a full grid,
    # one block over many tiles (capped), one tile
    assert [dwide_split(blocks, tiles) for blocks, tiles in ((28, 3), (64, 8), (224, 16), (132, 5), (112, 12),
                                                              (1, 100), (4, 1))] == [3, 2, 1, 1, 1, 32, 1]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", MODES)
def test_kernel_operands_wide(dtype, mode):
    """The wide entries' C arguments: the entry of the dtype in every mode
    (self included), dims[5] the caller's D where its rows are 16-byte
    multiples and the operands passed as they are (no padding copy; the
    kernel zero-fills past D), the output a (B, Sq, H, D) buffer, the
    workspace each split's O, max and sum per softmax set where the outer
    modes park a set or the key stream is split (here always: 6 row blocks);
    a head dim off the 8-element grid is padded, with the scale kept."""
    q, k, v, coef, skip, eps = _inputs(640, dtype, "shared" if mode != "self" else None, seed=5)
    tq, tk, tv = (_torch(x, dtype) for x in (q, k, v))
    ops = kernel_operands(tq, tk, tv, torch.from_numpy(coef), mode, skip_endpoints=torch.from_numpy(skip),
                          **{n: _torch(e, dtype) for n, e in eps.items()})
    assert ops["entry"] == DWIDE_ENTRIES[DTYPES[dtype]]
    assert ops["dims"][5] == 640 and ops["tensors"][0] is tq and ops["tensors"][1] is tk
    assert ops["tensors"][7].transpose(1, 2).is_contiguous() and ops["out"].shape == tq.shape
    BQ = 16 if dtype == "f32" else 32
    # 40 own keys and 17 endpoint keys: one key tile a segment
    tiles = {"self": 1, "fused_outer": 3, "pure_outer": 2, "fused_inner": 2, "pure_inner": 1}[mode]
    splits = min(132 // (3 * 2 * math.ceil(24 / BQ)), tiles)
    assert ops["splits"] == splits
    if AttnMode(mode).is_outer or splits > 1:
        sets = 2 if AttnMode(mode).is_outer else 1
        assert tuple(ops["work"].shape) == (3 * 2 * math.ceil(24 / BQ) * splits, sets, BQ * 640 + 2 * BQ)
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

WG, CHUNK = 2, 64  # consumer warpgroups; the head-dim columns of a chunk (warpgroup (c // 64) % 2 takes column c)


def _strided(x, dims, i, shape):
    """Operand i as the kernel reads it: (b, h, s) element strides from the
    C arguments (a b stride of 0: one tensor shared by every row)."""
    sb, sh, ss = dims[6 + 3 * i: 9 + 3 * i]
    return x.as_strided(shape, (sb, sh, ss, 1))


def _thread_major(BQ, Dp):
    """For each word (query q, column c) of a parked O (BQ x Dp, stored
    [q][c]), its index were the block's words laid out thread by thread: the
    consumer thread that holds it (warpgroup (c // 64) % 2, warp c % 64 //
    16, lane 4 (c % 8) + q % 8 // 2) and its word there (chunk c // 128,
    accumulator 4 (q // 8) + 2 (c % 16 // 8) + q % 2). A planted fault reads
    the parked O back in this order."""
    q, c = torch.arange(BQ).reshape(-1, 1), torch.arange(Dp).reshape(1, -1)
    wg, m = (c // CHUNK) % WG, c % CHUNK
    tid = wg * 128 + (m // 16) * 32 + 4 * (m % 8) + (q % 8) // 2
    word = (c // (WG * CHUNK)) * (BQ // 2) + 4 * (q // 8) + 2 * ((m % 16) // 8) + q % 2
    return (tid * (Dp // (WG * CHUNK) * (BQ // 2)) + word).reshape(-1)


def _emulate_dwide_kernel(ops, fault=None):
    """The wide entry's output rebuilt from its C arguments in its order of
    work (csrc/flash_attention_dwide.cu), in f32: per (b, h), block of BQ
    query rows and split of the key stream (:func:`dwide_tiles`,
    :func:`dwide_split`), Q and each key tile of K and V read through the
    dims' strides, zero-filled past D and past each segment's length; each
    warpgroup's partial scores over its 64-column chunks (warpgroup w the
    chunks w, w + 2, ...), the two added; the online softmax down each query
    column (raw maxima, the rescale at 2^((m - m_new) scale log2 e)); P rounded
    to the input type (bf16, f16) and each tile's P V folded into O; the
    outer modes' own state parked in the workspace as set 1's start, set 0
    stored after the begin segment and set 1 continued from the park; each
    split's states (O, m, l) stored at its place in ``ops["work"]`` and
    merged as the combine step merges them, or, unsplit, normalised and
    blended in the block. The static-shift entry (``ops["static"]``: the
    shift and the clip in log2 units) takes P = 2^min(s sl2 - shift, clip)
    with no max (the max words of a state are never written), adds each
    tile's P V and sum with no factor, and combines the splits as O = sum
    O_s / sum l_s, each set's sum guarded at 1e-37. ``fault``: "own_chunk"
    (each warpgroup's softmax and P V over its own partial scores: no
    exchange), "q_chunk" (each chunk's scores against the next chunk of Q),
    "thread_major" (the parked O read back thread by thread), "combine" (the
    combine step adds the splits' states without rescaling them to the
    largest max); at the static shift "split_alone" (each split's state
    normalised by its own sum before the splits are added), "rescale" (the
    shift left in a per-tile rescale: O and l times 2^-shift before each key
    tile) and "clip" (the clip dropped)."""
    q, k, v, kb, vb, ke, ve, out = ops["tensors"]
    dims = ops["dims"]
    B, H, Sq, Lk, Le, D = dims[:6]
    dtype = q.dtype
    f32 = dtype == torch.float32
    Dp, BQ, BK = dwide_tiles(D, dtype)
    static = ops["static"]
    assert ops["entry"] == (DWIDE_ENTRIES if static is None else STATIC_DWIDE_ENTRIES)[dtype] and D <= DWIDE
    sl2 = float(np.float32(ops["scale"]) * np.float32(1.4426950408889634))
    if static is not None:  # the shift and the clip as the C entry takes them (f32)
        shift, clip = (float(np.float32(x)) for x in static)
    has_own, n_sets = ops["has_own"], ops["n_sets"]
    nq = -(-Sq // BQ)
    n_own, n_ep = (-(-Lk // BK) if has_own else 0), -(-Le // BK)
    n_total = n_own + n_sets * n_ep
    S = dwide_split(B * H * nq, n_total)
    assert ops["splits"] == S
    sets = 2 if n_sets == 2 else 1
    per = BQ * Dp + 2 * BQ
    if n_sets == 2 or S > 1:
        assert tuple(ops["work"].shape) == (B * H * nq * S, sets, per)
        ws = ops["work"]
        ws.fill_(math.nan)  # a word read before it is written poisons the result
    else:
        assert ops["work"] is None
    mine = [(torch.arange(Dp) // CHUNK) % WG == w for w in range(WG)]  # each warpgroup's columns

    def guard(x):  # the static instances guard each sum at 1e-37; the exact ones divide as they are
        return x if static is None else x.clamp_min(1e-37)

    def padded(x):  # the zero fill past D
        return torch.nn.functional.pad(x.float(), (0, Dp - D))

    Qall = padded(_strided(q, dims, 0, (B, H, Sq, D)))
    seg = [(padded(_strided(x, dims, i, (B, H, n, D))), padded(_strided(y, dims, i + 1, (B, H, n, D))), n)
           for i, (x, y, n) in ((1, (k, v, Lk)), (3, (kb, vb, Le)), (5, (ke, ve, Le)))]
    res = torch.zeros(B, H, nq * BQ, Dp)

    def store(blk, set_, o, m, l):
        ws[blk, set_, :BQ * Dp] = o.reshape(-1)
        if static is None:  # the static shift keeps no max: its words stay unwritten
            ws[blk, set_, BQ * Dp:BQ * Dp + BQ] = m
        ws[blk, set_, BQ * Dp + BQ:] = l

    def load(blk, set_, order=None):
        w = ws[blk, set_]
        o = w[:BQ * Dp] if order is None else w[:BQ * Dp][order]
        return o.reshape(BQ, Dp).clone(), w[BQ * Dp:BQ * Dp + BQ].clone(), w[BQ * Dp + BQ:].clone()

    for b in range(B):
        skip = bool(has_own and n_sets and ops["skip"] is not None and ops["skip"][b])
        outer = n_sets == 2 and not skip
        n_row = n_own if skip else n_total
        for h in range(H):
            for qb in range(nq):
                n = min(BQ, Sq - qb * BQ)
                Qb = torch.zeros(BQ, Dp)
                Qb[:n] = Qall[b, h, qb * BQ:qb * BQ + n]
                if fault == "q_chunk":
                    Qb = Qb.roll(-CHUNK, dims=1)
                for sp in range(S):
                    blk = ((b * H + h) * nq + qb) * S + sp
                    t0, t1 = sp * n_total // S, min((sp + 1) * n_total // S, n_row)
                    o, m, l = torch.zeros(BQ, Dp), torch.full((BQ,), -math.inf), torch.zeros(BQ)
                    if t0 >= t1:  # a skip row's split past its own segment: an empty state
                        store(blk, 0, o, m, l)
                        continue

                    def tile(it, o, m, l):
                        s_ = 0 if it < n_own else 1 + (it - n_own) // n_ep
                        K, V, length = seg[s_][0][b, h], seg[s_][1][b, h], seg[s_][2]
                        r0 = (it if it < n_own else (it - n_own) % n_ep) * BK
                        Kt, Vt = torch.zeros(BK, Dp), torch.zeros(BK, Dp)
                        valid = min(BK, length - r0)
                        Kt[:valid], Vt[:valid] = K[r0:r0 + valid], V[r0:r0 + valid]
                        parts = [Kt[:, w_] @ Qb[:, w_].T for w_ in mine]  # S^T over each warpgroup's chunks
                        scores = parts if fault == "own_chunk" else [parts[0] + parts[1]] * WG
                        o = o.clone()
                        if static is not None:
                            if fault == "rescale":
                                o, l = o * 2.0 ** -shift, l * 2.0 ** -shift
                            for w_, st in zip(mine, scores):
                                st = st.clone()
                                st[valid:] = -math.inf
                                e_ = st * sl2 - shift
                                p_ = torch.exp2(e_ if fault == "clip" else e_.clamp_max(clip))
                                l_new = l + p_.sum(0)
                                p_ = p_ if f32 else p_.to(dtype).float()
                                o[:, w_] = o[:, w_] + p_.T @ Vt[:, w_]
                            return o, m, l_new
                        for w_, st in zip(mine, scores):
                            st = st.clone()
                            st[valid:] = -math.inf
                            m_new = torch.maximum(m, st.amax(0))
                            alpha = torch.exp2((m - m_new) * sl2)
                            p_ = torch.exp2(st * sl2 - m_new * sl2)
                            l_new = l * alpha + p_.sum(0)
                            p_ = p_ if f32 else p_.to(dtype).float()
                            o[:, w_] = o[:, w_] * alpha[:, None] + p_.T @ Vt[:, w_]
                        return o, m_new, l_new  # the last warpgroup's statistics (the same unless a fault splits them)

                    runs = ([0] if has_own else []) + [1, 2] if outer else [2]
                    for r in runs:
                        a = n_own + (r - 1) * n_ep if outer and r > 0 else 0
                        z = n_own + r * n_ep if outer and r < 2 else n_total
                        for it in range(max(a, t0), min(z, t1)):
                            o, m, l = tile(it, o, m, l)
                        if r == 0:
                            store(blk, 1, o, m, l)
                        elif r == 1:
                            store(blk, 0, o, m, l)
                            if has_own:
                                o, m, l = load(blk, 1, _thread_major(BQ, Dp) if fault == "thread_major" else None)
                            else:
                                o, m, l = torch.zeros(BQ, Dp), torch.full((BQ,), -math.inf), torch.zeros(BQ)
                    if S > 1:
                        store(blk, 1 if outer else 0, o, m, l)
                    elif outer:
                        c = float(ops["coef"][b])
                        o0, _, l0 = load(blk, 0)
                        res[b, h, qb * BQ:(qb + 1) * BQ] = (o * (c / guard(l))[:, None]
                                                             + o0 * ((1 - c) / guard(l0))[:, None])
                    else:
                        res[b, h, qb * BQ:(qb + 1) * BQ] = o / guard(l)[:, None]
                if S > 1:  # the combine step
                    base = ((b * H + h) * nq + qb) * S
                    merged = torch.zeros(BQ, Dp)
                    for set_ in range(2 if outer else 1):
                        st = [load(base + sp, set_) for sp in range(S)]
                        wt = (float(ops["coef"][b]) if set_ else 1 - float(ops["coef"][b])) if outer else 1.0
                        if static is not None:  # no max pass, no weight
                            if fault == "split_alone":
                                merged += sum(x[0] / guard(x[2])[:, None] for x in st) * wt
                                continue
                            L = sum(x[2] for x in st)
                            O = sum(x[0] for x in st)
                            merged += O * (wt / guard(L))[:, None]
                            continue
                        mx = torch.stack([x[1] for x in st]).amax(0)
                        e = [torch.ones(BQ) if fault == "combine" else torch.exp2((x[1] - mx) * sl2) for x in st]
                        L = sum(x[2] * ei for x, ei in zip(st, e))
                        O = sum(x[0] * ei[:, None] for x, ei in zip(st, e))
                        merged += O * (wt / L)[:, None]
                    res[b, h, qb * BQ:(qb + 1) * BQ] = merged
    stored = _strided(out, dims, 7, (B, H, Sq, out.shape[-1]))
    stored.copy_(res[:, :, :Sq, :out.shape[-1]].to(dtype))
    return ops["out"]


def _replay_inputs(D, dtype, mode, ep, seed, unsplit=False):
    """40 queries, 140 own keys (two 128-key tiles in bf16 and f16, three
    64-key ones in f32, the last ragged) and 9 endpoint keys, three rows; two
    heads, which leave the grid under one wave and split the key stream, or
    ``unsplit``: enough heads for 132 blocks."""
    BQ = dwide_tiles(padded_head_dim(D), DTYPES[dtype])[1]
    H = -(-132 // (3 * -(-40 // BQ))) if unsplit else 2
    q, k, v, coef, skip, eps = _inputs(D, dtype, ep, seed, H=H, S=40, L=140, Le=9)
    args = [_torch(x, dtype) for x in (q, k, v)] + [torch.from_numpy(coef), mode]
    return args, dict(skip_endpoints=torch.from_numpy(skip), **{n: _torch(e, dtype) for n, e in eps.items()})


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("D", [520, 640, 1280, 2048])
def test_dwide_replay_matches_plain(D, mode, dtype):
    """The wide entry replayed from its C arguments matches the plain
    version: 40 queries (a 32-, 16- or 8-row block and a ragged one), 140
    own keys and 9 endpoint keys ragged against the key tile, skip rows,
    endpoints from the rows (pure modes) or shared (fused modes); at D = 640
    and 2048 two heads (the key stream split, the combine step), at 520 and
    1280 enough heads to fill the card (no split: the block finishes)."""
    ep = "shared" if AttnMode(mode).is_fused else None
    args, kw = _replay_inputs(D, dtype, mode, ep, seed=300 + D, unsplit=D in (520, 1280))
    if mode == "self":
        kw = {}
    ops = kernel_operands(*args, **kw)
    assert (ops["splits"] == 1) == (D in (520, 1280))
    got = _emulate_dwide_kernel(ops)
    want = flash_interpolated_attention_plain(*args, **kw)
    assert got.dtype == DTYPES[dtype] and got.shape == want.shape
    assert _err(got, want) < REPLAY_TOL[dtype]


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("fault", ["own_chunk", "q_chunk", "thread_major", "combine"])
def test_dwide_replay_planted_faults_are_seen(dtype, fault):
    """Each planted fault misses the replay's bound by orders of magnitude:
    the bound is sharp enough to see a warpgroup's softmax over its own
    partial scores, a wrong chunk of Q, the parked words read back thread by
    thread, or the combine step adding the splits' states unrescaled
    (fused_outer at D = 640 and 1280, per-row endpoints, the key stream
    split)."""
    for D in (640, 1280):
        args, kw = _replay_inputs(D, dtype, "fused_outer", "per_row", seed=400 + D)
        want = flash_interpolated_attention_plain(*args, **kw)
        sound = _err(_emulate_dwide_kernel(kernel_operands(*args, **kw)), want)
        err = _err(_emulate_dwide_kernel(kernel_operands(*args, **kw), fault=fault), want)
        # a NaN (a parked word read before it was written) misses the bound too
        assert sound < REPLAY_TOL[dtype] and not err <= 10 * REPLAY_TOL[dtype], (D, sound, err)


@pytest.mark.parametrize("split", [True, False], ids=["split", "unsplit"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("D", [520, 640, 1280, 2048])
def test_dwide_static_replay_matches_plain(D, mode, dtype, split):
    """The static wide entry (static_smax = STATIC_SHIFT_C) replayed from its
    C arguments matches the plain version's static shift, as the exact
    replay's inputs: two heads (the key stream split, the static combine
    step) or enough heads for 132 blocks (unsplit: the block normalises and
    blends); the layout is the exact entry's, workspace and split."""
    ep = "shared" if AttnMode(mode).is_fused else None
    args, kw = _replay_inputs(D, dtype, mode, ep, seed=500 + D, unsplit=not split)
    if mode == "self":
        kw = {}
    ops = kernel_operands(*args, **kw, static_smax=STATIC_SHIFT_C)
    exact = kernel_operands(*args, **kw)
    assert ops["entry"] == STATIC_DWIDE_ENTRIES[DTYPES[dtype]] and (ops["splits"] > 1) == split
    assert ops["splits"] == exact["splits"] and ops["dims"] == exact["dims"]
    assert (ops["work"] is None) == (exact["work"] is None)
    assert ops["work"] is None or ops["work"].shape == exact["work"].shape
    got = _emulate_dwide_kernel(ops)
    want = flash_interpolated_attention_plain(*args, **kw, static_smax=STATIC_SHIFT_C)
    assert got.dtype == DTYPES[dtype] and got.shape == want.shape
    assert _err(got, want) < REPLAY_TOL[dtype]


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("fault", ["split_alone", "rescale", "clip"])
def test_dwide_static_replay_planted_faults_are_seen(dtype, fault):
    """Each planted fault of the static instance misses the replay's bound:
    each split's state normalised by its own sum before the splits are added,
    the shift left in a per-tile rescale (O and l times e^-C before each key
    tile), the clip dropped (the exact softmax, on logits far past the
    window's top: scale 32 / sqrt(D) puts the row maxes near +80); fused_outer
    at D = 640 and 1280, per-row endpoints, the key stream split for the
    first fault, unsplit for the others (a split of these inputs holds one
    key tile, so a rescale before each tile would move nothing)."""
    for D in (640, 1280):
        split = fault == "split_alone"
        args, kw = _replay_inputs(D, dtype, "fused_outer", "per_row", seed=600 + D, unsplit=not split)
        kw["scale"] = 32.0 / math.sqrt(D) if fault == "clip" else None
        ops = kernel_operands(*args, **kw, static_smax=STATIC_SHIFT_C)
        assert (ops["splits"] > 1) == split
        want = flash_interpolated_attention_plain(*args, **kw, static_smax=STATIC_SHIFT_C)
        sound = _err(_emulate_dwide_kernel(ops), want)
        err = _err(_emulate_dwide_kernel(kernel_operands(*args, **kw, static_smax=STATIC_SHIFT_C), fault=fault),
                   want)
        # on the hot input the f32 exponents' arguments are near 2^7 in log2 units, where an f32 ulp (1.5e-5)
        # moves each p by 1e-5 of itself: the f32 bound there is FLASH_TOL's (measured 1.5e-5)
        tol = FLASH_TOL[dtype] if fault == "clip" and dtype == "f32" else REPLAY_TOL[dtype]
        assert sound < tol and not err <= 10 * tol, (D, sound, err)


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
