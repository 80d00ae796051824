"""The short-stream kernel's data movement, replayed on the CPU.

csrc/flash_attention_onepass.cu (bf16 and f16) has no CPU mode. The replay
below reads the operands as its tensor maps read them, from the C entry's own
arguments (``ops.flash_attention.kernel_operands``): the whole stream of a
(b, h) resident (the own segment, then each endpoint segment, each padded to
whole 16-key tiles, back to back under the 128-byte swizzle; shared (H, Le,
D) endpoints through a map of batch extent 1; a skip row's endpoint segments
loaded and masked whole; the instance's tiles past the stream zeroed once a
block; the stream reloaded where a block's run of query tiles crosses into
the next (b, h)), the query tiles of each block's
run through each warpgroup's ring of Q/O buffers, S = Q K^T over the whole
stream through K-major descriptors, each segment's exact row max with only
its ragged last tile masked, the sets combined row by row into one weight a
segment folded into P before P is rounded, P V through the MN-major V
descriptor, and the TMA store clipped at Sq and D. Its tile and route
constants are read from the source.

It is held against the plain version (f32 to 1e-5 of max |ref|; bf16 and f16
to 1e-2, P's rounding and the output's) and against the JAX wrapper in
interpret mode at shapes that wrapper sends to ``_kernel_onepass``
(aid_tpu/ops/flash_attention.py:339). Planted faults (the own segment's max
used for an endpoint segment, the 77-key tail unmasked, a shared endpoint
read at the row's batch, the second Q buffer stored to the first tile's
rows) must miss the bound.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_helpers as th
from aid_tpu.ops.flash_attention import flash_interpolated_attention as jax_flash
from aid_tpu_torch.ops import flash_attention as FA
from aid_tpu_torch.ops.attention import AttnMode
from aid_tpu_torch.ops.flash_attention import (
    ONEPASS_ENTRIES,
    ONEPASS_RING,
    ONEPASS_SMEM_LIMIT,
    ONEPASS_STREAM_TILES,
    flash_interpolated_attention_plain,
    kernel_operands,
    onepass_tiles,
    takes_onepass,
)
from test_torch_dmid import _box_reader, _flat, _maps
from test_torch_ops import _swizzle128

SOURCE = Path(FA.__file__).resolve().parents[1] / "csrc" / "flash_attention_onepass.cu"
MODES = [m.value for m in AttnMode]
DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}
# f32 operands: the replay's arithmetic is the plain version's but for exp2
# with log2(e) folded into the scale and the sets combined from per-segment
# maxima (a few f32 ulps over 77-240 keys). bf16 / f16: P rounded after its
# segment's weight is folded in, the output rounded once (2^-9 and 2^-11
# relative), as tests/test_torch_dmid.py holds them.
TOLS = {"f32": 1e-5, "bf16": 1e-2, "f16": 1e-2}


def _source_constants() -> dict:
    """kStreamTiles, kRing and kSmemLimit, and the block's shared-memory
    expression, as the source states them."""
    text = SOURCE.read_text()
    tiles = re.search(r"constexpr int kStreamTiles\[\] = \{([\d, ]+)\};", text).group(1)
    narrow = re.search(r"constexpr int kNarrowD = (\d+);", text).group(1)
    ring = re.search(r"constexpr int kRingNarrow = (\d+), kRingWide = (\d+);", text).groups()
    limit = re.search(r"constexpr int kSmemLimit = (\d+);", text).group(1)
    smem = re.search(r"static constexpr int smem_bytes\(int nwg\) \{ return ([^;]+); \}", text).group(1)
    return dict(tiles=tuple(int(x) for x in tiles.split(",")), narrow=int(narrow), ring=tuple(int(r) for r in ring),
                limit=int(limit), smem=smem)


def _ring(D: int) -> int:
    """Q/O buffers a warpgroup at head dim D (the source's Onepass<D>::kRing)."""
    return SRC["ring"][0] if D <= SRC["narrow"] else SRC["ring"][1]


SRC = _source_constants()


def _segments(ops: dict) -> tuple:
    """(nt_own, nt_ep, kt): the segments' 16-key tiles and the instance's,
    as the source's entry picks them from the C arguments."""
    Lk, Le = ops["dims"][3:5]
    nt_own = -(-Lk // 16) if ops["has_own"] else 0
    nt_ep = -(-Le // 16) if ops["n_sets"] else 0
    kt = next(c for c in SRC["tiles"] if nt_own + ops["n_sets"] * nt_ep <= c)
    return nt_own, nt_ep, kt


def _weights(ms: list, lsum: list, n_sets: int, skip: bool, c: float) -> list:
    """Each segment's per-row weight in the output (the source's
    set_weights): ms the segments' maxima in the exp2 domain (-inf where
    empty), lsum their row sums."""
    z = torch.zeros_like(lsum[0])
    if n_sets == 0 or skip:
        return [1.0 / lsum[0], z, z]
    if n_sets == 1:
        top = torch.maximum(ms[0], ms[1])
        a0, a1 = torch.exp2(ms[0] - top), torch.exp2(ms[1] - top)
        inv = 1.0 / (lsum[0] * a0 + lsum[1] * a1)
        return [a0 * inv, a1 * inv, z]
    top0, top1 = torch.maximum(ms[0], ms[1]), torch.maximum(ms[0], ms[2])
    a0, a1 = torch.exp2(ms[0] - top0), torch.exp2(ms[1] - top0)
    b0, b2 = torch.exp2(ms[0] - top1), torch.exp2(ms[2] - top1)
    i0 = (1.0 - c) / (lsum[0] * a0 + lsum[1] * a1)
    i1 = c / (lsum[0] * b0 + lsum[2] * b2)
    return [a0 * i0 + b0 * i1, a1 * i0, b2 * i1]


def _emulate_onepass(ops: dict, nwg: int = 1, blocks: int | None = None, fault: str | None = None) -> torch.Tensor:
    """csrc/flash_attention_onepass.cu's data movement, replayed in plain
    torch from the C entry's own arguments, at ``nwg`` consumer warpgroups a
    block and ``blocks`` blocks (default: one a unit of work).

    The (b, h, query tile) units are cut into one contiguous run a block;
    each block zeroes the instance's tiles past the stream once (the rest of
    its shared memory starts as garbage: NaN here) and loads the stream by
    boxes of 64 columns where its run enters a (b, h): the own K/V, then the
    endpoint segments (a skip row's too, masked whole), each at its 16-key
    tile offset.
    Each warpgroup's tile i goes through ring buffer i % kRing. ``fault``:
    "own_max" (an endpoint segment's exps taken against the own segment's
    max), "tail_unmasked" (a segment's ragged last tile not masked: the
    map's zero fill joins the softmax), "shared_batch" (a shared endpoint
    read at the row's batch: out of its batch extent of 1, zeros),
    "second_buffer" (the tile in ring buffer 1 stored to the rows of the tile
    before it)."""
    (B, H, Sq, D), strides, _ = _maps(ops)
    tensors, coef, skips = ops["tensors"], ops["coef"], ops["skip"]
    dt = tensors[0].dtype
    Lk, Le = ops["dims"][3:5]
    has_own, n_sets = ops["has_own"], ops["n_sets"]
    nt_own, nt_ep, kt = _segments(ops)
    chunks, rows = -(-D // 64), 16 * kt
    sl2 = ops["scale"] * 1.4426950408889634
    box = _box_reader(ops, 64, fault)
    first = (0, nt_own, nt_own + nt_ep)

    def kmajor(smem, start, n):  # (n, 16) through a K-major descriptor, start in bytes
        r, kc = torch.arange(n)[:, None], torch.arange(16)[None, :]
        return smem[_swizzle128(start + (r // 8) * 1024 + (r % 8) * 128 + kc * 2) // 2]

    def mnmajor(smem, start):  # (16 keys, D) through the MN-major (transposed) descriptor, LBO one box
        kr, n = torch.arange(16)[:, None], torch.arange(D)[None, :]
        return smem[_swizzle128(start + (kr // 8) * 1024 + (kr % 8) * 128 + (n // 64) * rows * 128 + (n % 64) * 2)
                    // 2]

    def segment_of(j):
        return 0 if j < nt_own else 1 if (j < nt_own + nt_ep or n_sets < 2) else 2

    tiles = -(-Sq // (64 * nwg))
    units = B * H * tiles
    blocks = units if blocks is None else blocks
    out_flat = torch.zeros_like(_flat(tensors[7]))
    sb, sh, ss = strides[7]
    for blk in range(blocks):
        u0, u1 = blk * units // blocks, (blk + 1) * units // blocks
        ks, vs = torch.full((chunks * rows * 64,), math.nan), torch.full((chunks * rows * 64,), math.nan)
        used = 16 * (nt_own + n_sets * nt_ep)
        for c in range(chunks):  # the instance's tiles past the stream, zeroed once
            ks[(c * rows + used) * 64:(c + 1) * rows * 64] = 0.0
            vs[(c * rows + used) * 64:(c + 1) * rows * 64] = 0.0
        held, stored = None, [None] * nwg
        for i, u in enumerate(range(u0, u1)):
            bh, qt = divmod(u, tiles)
            b, h = divmod(bh, H)
            skip = bool(n_sets and skips is not None and bool(skips[b]))
            if bh != held:  # the stream of (b, h), each segment at its tile offset
                for c in range(chunks):
                    at = c * rows * 64
                    if has_own:
                        ks[at:at + 16 * nt_own * 64] = box(1, c, h, 0, b, 16 * nt_own)
                        vs[at:at + 16 * nt_own * 64] = box(2, c, h, 0, b, 16 * nt_own)
                    for e in range(n_sets):
                        r0 = at + 16 * (nt_own + e * nt_ep) * 64
                        ks[r0:r0 + 16 * nt_ep * 64] = box(3 + 2 * e, c, h, 0, b, 16 * nt_ep)
                        vs[r0:r0 + 16 * nt_ep * 64] = box(4 + 2 * e, c, h, 0, b, 16 * nt_ep)
                held = bh
            lens = (Lk, 0 if skip or n_sets < 1 else Le, 0 if skip or n_sets < 2 else Le)
            for w in range(nwg):
                q0 = qt * 64 * nwg + 64 * w
                qs = torch.cat([box(0, c, h, q0, b, 64) for c in range(chunks)])
                s = sum(kmajor(qs, (kk // 4) * 8192 + (kk % 4) * 32, 64)
                        @ kmajor(ks, (kk // 4) * rows * 128 + (kk % 4) * 32, rows).T for kk in range(-(-D // 16)))
                seg = torch.tensor([segment_of(j) for j in range(kt)]).repeat_interleave(16)
                col = torch.arange(rows)
                lim = torch.tensor([lens[segment_of(j)] - 16 * (j - first[segment_of(j)]) for j in range(kt)])
                masked = col % 16 >= lim.repeat_interleave(16)
                if fault == "tail_unmasked":  # only whole tiles past a segment stay masked
                    masked &= lim.repeat_interleave(16) <= 0
                s = s.masked_fill(masked[None, :], -math.inf)
                ms = [s[:, seg == g].max(dim=1).values * sl2 if bool((seg == g).any())
                      else torch.full((64,), -math.inf) for g in range(3)]
                safe = [torch.where(m == -math.inf, torch.zeros_like(m), m) for m in ms]
                shift = [safe[0] if (fault == "own_max" and g > 0 and has_own) else safe[g] for g in range(3)]
                p = torch.zeros_like(s)
                for g in range(3):
                    p[:, seg == g] = torch.exp2(s[:, seg == g] * sl2 - shift[g][:, None])
                lsum = [p[:, seg == g].sum(dim=1) for g in range(3)]
                wts = _weights(ms, lsum, n_sets, skip, float(coef[b]) if n_sets == 2 and not skip else 0.0)
                pw = torch.zeros_like(p)
                for g in range(3):
                    pw[:, seg == g] = p[:, seg == g] * wts[g][:, None]
                pw = pw.to(dt).float()
                o = sum(pw[:, 16 * j:16 * j + 16] @ mnmajor(vs, j * 2048) for j in range(kt)).to(dt).float()
                # the TMA store from ring buffer i % kRing, clipped at Sq and D
                at_b, at_h, at_q = (b, h, q0)
                if fault == "second_buffer" and i % _ring(D) == 1:
                    at_b, at_h, at_q = stored[w]
                stored[w] = (b, h, q0)
                r, cc = torch.arange(64)[:, None], torch.arange(D)[None, :]
                keep = (at_q + r < Sq).expand(64, D)
                dst = (at_b * sb + at_h * sh + (at_q + r) * ss + cc)[keep]
                out_flat[dst] = o[keep]
    out = tensors[7]
    return torch.as_strided(out_flat, out.shape, out.stride()).to(dt)[..., :ops["head_dim"]]


def _inputs(B, H, S, L, D, dtype, seed, ep=None, Le=None):
    """(B, S, H*D) projections viewed as (B, H, S, D) (each row's columns past
    D are the next head's), coefficients with both ends skip rows, and
    shared (3) or per-row (4) endpoints, drawn with numpy in f32."""
    rng = np.random.default_rng(seed)

    def heads(n):
        x = torch.from_numpy(rng.standard_normal((B, n, H * D), dtype=np.float32)).to(dtype)
        return x.view(B, n, H, D).transpose(1, 2)

    q, k, v = heads(S), heads(L), heads(L)
    coef = torch.from_numpy(np.linspace(0, 1, B, dtype=np.float32))
    skip = torch.zeros(B, dtype=torch.bool)
    skip[0] = skip[-1] = True
    eps = {}
    if ep is not None:
        shape = (H, Le, D) if ep == 3 else (B, H, Le, D)
        eps = {n: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dtype)
               for n in ("k_begin", "v_begin", "k_end", "v_end")}
    return q, k, v, coef, skip, eps


def _err(got, want):
    return th.max_rel_err(got.float().numpy(), want.float().numpy())


def _replay_vs_plain(dtype, D, mode, case, nwg=1, blocks=None, fault=None):
    B, H, S, L, Le, ep = case
    q, k, v, coef, skip, eps = _inputs(B, H, S, L, D, DTYPES[dtype], 7, ep, Le)
    kw = dict(skip_endpoints=skip, **eps)
    ops = kernel_operands(q, k, v, coef, mode, onepass=dtype != "f32", **kw)
    got = _emulate_onepass(ops, nwg, blocks, fault)
    want = flash_interpolated_attention_plain(q.float(), k.float(), v.float(), coef, mode,
                                              **{n: x.float() for n, x in eps.items()}, skip_endpoints=skip)
    return _err(got, want)


# (B, H, Sq, Lk, Le, endpoints): the 77-key cross call with shared 77-token
# endpoints, per-row endpoints of their own length, the IP tokens (16, 4)
# shared and per row, a short self call's own 144 keys (rows 0 and B-1 as
# endpoints)
CASES = {
    "cross77_shared": (3, 2, 130, 77, 77, 3),
    "cross77_rows23": (2, 2, 64, 77, 23, 4),
    "ip16_shared": (3, 2, 200, 16, 16, 3),
    "ip4_rows": (3, 2, 100, 4, 4, 4),
    "own144": (2, 2, 144, 144, None, None),
}


def _fits(D, mode, case):
    B, H, S, L, Le, ep = case
    return onepass_tiles(D, L, L if Le is None else Le, mode) is not None


@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("D,mode,case", [(D, m, c) for D in (40, 64, 80, 160) for m in MODES for c in CASES
                                         if _fits(D, m, CASES[c])])
def test_onepass_replay_matches_plain(dtype, D, mode, case):
    """Every mode at every head dim on the cases whose stream the kernel
    holds (at D=160 the 77-key fused_outer stream is over its shared memory,
    and 144-key endpoint streams are past its largest instance), one
    warpgroup a block, one block a unit."""
    assert _replay_vs_plain(dtype, D, mode, CASES[case]) < TOLS[dtype]


@pytest.mark.parametrize("nwg,blocks", [(1, 4), (2, 3), (2, 1), (1, 7)])
@pytest.mark.parametrize("mode", ["fused_outer", "fused_inner", "self"])
def test_onepass_replay_block_runs(nwg, blocks, mode):
    """Runs of query tiles across (b, h): two warpgroups sharing a block's
    stream, blocks whose runs reload the stream mid-run (a skip row's stale
    endpoint tiles then stay masked), and one block over every unit."""
    assert _replay_vs_plain("bf16", 64, mode, (3, 2, 256, 77, 77, 3), nwg, blocks) < TOLS["bf16"]


@pytest.mark.parametrize("fault,mode,case", [
    ("own_max", "fused_outer", "cross77_shared"),
    ("own_max", "fused_inner", "cross77_shared"),
    ("tail_unmasked", "fused_outer", "cross77_shared"),
    ("tail_unmasked", "pure_inner", "cross77_rows23"),
    ("shared_batch", "pure_outer", "cross77_shared"),
    ("second_buffer", "self", "cross77_shared"),
])
def test_onepass_planted_faults_miss_the_bound(fault, mode, case):
    """Each planted fault moves the replay past the bf16 bound, where the
    sound replay of the same call stays within it."""
    assert _replay_vs_plain("bf16", 64, mode, CASES[case], blocks=2) < TOLS["bf16"]
    assert _replay_vs_plain("bf16", 64, mode, CASES[case], blocks=2, fault=fault) > TOLS["bf16"]


def _jax(q, k, v, coef, mode, skip, eps):
    return np.asarray(jax_flash(*(jnp.asarray(x.float().numpy()) for x in (q, k, v)), jnp.asarray(coef.numpy()),
                                mode, **{n: jnp.asarray(x.float().numpy()) for n, x in eps.items()},
                                skip_endpoints=jnp.asarray(skip.numpy()), interpret=True))


@pytest.mark.parametrize("D,mode,case", [
    *[(D, m, "cross77_shared") for D in (40, 64, 80) for m in MODES],
    *[(40, m, "ip16_shared") for m in MODES],
    (64, "self", "sd21_own144"),
])
def test_onepass_replay_matches_jax_interpret(D, mode, case):
    """At shapes the JAX wrapper sends to `_kernel_onepass` (streams of up to
    onepass_max keys): the replay in f32 against the JAX wrapper in interpret
    mode, beside the plain version against it."""
    B, H, S, L, Le, ep = (2, 20, 144, 144, None, None) if case == "sd21_own144" else CASES[case]
    q, k, v, coef, skip, eps = _inputs(B, H, S, L, D, torch.float32, 11, ep, Le)
    want = _jax(q, k, v, coef, mode, skip, eps)
    plain = flash_interpolated_attention_plain(q, k, v, coef, mode, skip_endpoints=skip, **eps)
    assert th.max_rel_err(plain.numpy(), want) < 1e-5
    assert onepass_tiles(D, L, L if Le is None else Le, mode) is not None  # the kernel holds the stream
    ops = kernel_operands(q, k, v, coef, mode, skip_endpoints=skip, **eps)
    assert not ops["onepass"]  # f32 keeps its own kernel; the replay follows the operands' dtype
    assert th.max_rel_err(_emulate_onepass(ops).numpy(), want) < TOLS["f32"]


def test_onepass_constants_match_the_source():
    """The Python mirror of the source's instances and buffers, and the
    block's shared memory as the source computes it."""
    assert SRC["tiles"] == ONEPASS_STREAM_TILES and SRC["ring"] == (ONEPASS_RING["narrow"], ONEPASS_RING["wide"])
    assert SRC["limit"] == ONEPASS_SMEM_LIMIT and SRC["narrow"] == 64
    for D in (40, 64, 80, 160):
        for kt in ONEPASS_STREAM_TILES:
            t = onepass_tiles(D, 16 * kt, 16, "self")
            chunks = -(-D // 64)
            env = dict(kKVBytes=chunks * 16 * kt * 128, kRing=_ring(D), kQBytes=chunks * 64 * 128)
            want = {w: eval(SRC["smem"], {}, {**env, "nwg": w}) for w in (1, 2, 3)}  # noqa: S307 (the source's own line)
            assert (t is None) == (want[1] > ONEPASS_SMEM_LIMIT), (D, kt)
            if t is not None:
                assert t["smem"] == want and t["kt"] == kt


@pytest.mark.parametrize("D,Sq,Lk,Le,mode,takes", [
    (64, 4096, 240, 240, "self", True),         # 15 tiles: the largest instance
    (64, 4096, 241, 241, "self", False),
    (64, 4096, 80, 80, "fused_outer", True),    # 5 + 5 + 5 tiles
    (64, 4096, 81, 80, "fused_outer", False),
    (80, 1024, 80, 80, "fused_inner", True),    # 10 tiles
    (80, 1024, 77, 77, "fused_outer", True),    # 15 tiles x 2 boxes beside a ring of two
    (160, 256, 77, 77, "fused_outer", False),   # 15 tiles x 3 boxes beside one ring of two: over 227 KB
    (160, 256, 77, 77, "fused_inner", True),    # 10 tiles
    (160, 256, 160, 160, "self", True),
    (160, 256, 256, 256, "self", False),        # SD 1.x's 256-token self call
    (160, 64, 64, 64, "self", False),           # SD 1.x's mid block: one 64-row query tile a (b, h)
    (160, 65, 64, 64, "self", True),
    (64, 144, 144, 144, "self", True),          # SD 2.1's 12^2 level
    (64, 576, 576, 576, "self", False),         # SD 2.1's 576 tokens
    (64, 1024, 1024, 77, "fused_outer", False),  # an SDXL self-attention stream
    (40, 4096, 16, 16, "pure_outer", True),
    (40, 4096, 4, 4, "fused_inner", True),
])
def test_onepass_route_limits(D, Sq, Lk, Le, mode, takes):
    """The route at its limits: the stream's 16-key tiles against the largest
    instance and the block's shared memory, and the measured limit
    (ONEPASS_MIN_QUERIES); f32 never takes it."""
    assert takes_onepass(D, Sq, Lk, Le, mode, torch.bfloat16) is takes
    assert takes_onepass(D, Sq, Lk, Le, mode, torch.float16) is takes
    assert not takes_onepass(D, Sq, Lk, Le, mode, torch.float32)


def test_onepass_operands_route_and_raise():
    """kernel_operands names the new entry where the route takes the call,
    keeps the streaming entry when told (the parent's route, for timing it
    beside), sends a call past the route's measured limit to the new entry
    when told, and raises where the short-stream kernel cannot take it."""
    for dtype in (torch.bfloat16, torch.float16):
        q, k, v, coef, skip, eps = _inputs(3, 2, 130, 77, 40, dtype, 3, 3, 77)
        ops = kernel_operands(q, k, v, coef, "fused_outer", skip_endpoints=skip, **eps)
        assert ops["onepass"] and ops["entry"] == ONEPASS_ENTRIES[dtype] and ops["work"] is None
        ops = kernel_operands(q, k, v, coef, "fused_outer", skip_endpoints=skip, onepass=False, **eps)
        assert not ops["onepass"] and ops["entry"] == FA.KERNEL_ENTRIES[dtype]
        # padded head dims route by the instance's: D = 48 runs at 64
        q48, k48, v48, *_ = _inputs(3, 2, 130, 77, 48, dtype, 3)
        ops = kernel_operands(q48, k48, v48, coef, "self")
        assert ops["onepass"] and ops["dims"][5] == 64
        # past a measured limit (one 64-row query tile) it stays, unless told
        qm, km, vm, *_ = _inputs(2, 2, 64, 64, 160, dtype, 5)
        assert not kernel_operands(qm, km, vm, coef[:2], "self")["onepass"]
        assert kernel_operands(qm, km, vm, coef[:2], "self", onepass=True)["entry"] == ONEPASS_ENTRIES[dtype]
        qs, ks_, vs_, *_ = _inputs(2, 2, 64, 256, 160, dtype, 4)
        assert not kernel_operands(qs, ks_, vs_, coef[:2], "self")["onepass"]
        with pytest.raises(NotImplementedError, match="short-stream"):
            kernel_operands(qs, ks_, vs_, coef[:2], "self", onepass=True)
    q, k, v, coef, *_ = _inputs(3, 2, 130, 77, 64, torch.float32, 3)
    with pytest.raises(NotImplementedError, match="short-stream"):
        kernel_operands(q, k, v, coef, "self", onepass=True)


def test_onepass_counts_reset():
    """The wrappers' short-stream counts by head dim start at 0 and are
    reset with the rest; a CPU call launches nothing."""
    FA.reset_launch_counts()
    for fn in (FA.flash_interpolated_attention, FA.flash_interpolated_attention_f16,
               FA.flash_interpolated_attention_f32):
        assert fn.launches_onepass == dict.fromkeys(FA.KERNEL_HEAD_DIMS, 0)
    q, k, v, coef, skip, eps = _inputs(3, 2, 64, 77, 64, torch.bfloat16, 5)
    FA.flash_interpolated_attention(q, k, v, coef, "fused_outer", skip_endpoints=skip)
    assert FA.flash_interpolated_attention.launches_onepass[64] == 0 and FA.flash_interpolated_attention.launches == 0
