"""The mid-length stream kernel's data movement, replayed on the CPU.

csrc/flash_attention_midstream.cu (bf16 and f16) has no CPU mode. The replay
below reads the operands as its tensor maps read them, from the C entry's own
arguments (``ops.flash_attention.kernel_operands``), and walks the kernel's
schedule: the persistent grid's blocks walking one list of work items in a
snake (block i takes position i of even rounds, grid - 1 - i of odd ones),
an item being one query tile of a (b, h), the list heaviest first (the rows
that keep their endpoints, then the skip rows; full tiles before a (b, h)'s
last; head-major within each) (64 rows a consumer warpgroup, three a block
at D = 64, two at 80; a warpgroup whose rows are all past Sq, whose output
the store clips whole, skips the math at three); each block's Q/O buffers
in a ring, the output stored from
the item's Q buffer and clipped at Sq and D; the K/V ring filled tile by
tile over the stream's segments (own, then begin and end, or the lerped
cross segment; a skip row's endpoint segments dropped; shared (H, Le, D)
endpoints through a map of batch extent 1), each stage read by every
consumer warpgroup before it is refilled; the online softmax with a
segment's ragged last tile masked, P rounded to the operands' dtype, and the
outer modes' park/swap of one accumulator set. Its tile and route constants
are read from the source.

It is held against the plain version (f32 to 1e-5 of max |ref|; bf16 and f16
to 1e-2: P's rounding and the output's) in every mode at D = 64 and 80, and
against the JAX wrapper in interpret mode at shapes that wrapper sends to
``_kernel_onepass`` (aid_tpu/ops/flash_attention.py:339, streams of up to its
onepass_max of 3072 keys) with streams over 240 keys. Planted faults (a
K/V stage refilled once one consumer warpgroup has released it, before the
others have, an item's last query tile skipped, the next item's Q written
over a buffer whose store has not drained, the own segment's state not
parked) must miss the bound.
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
    MIDSTREAM_ENTRIES,
    MIDSTREAM_MAX_STREAM,
    MIDSTREAM_MIN_QUERIES,
    MIDSTREAM_MODES,
    MIDSTREAM_SMEM_LIMIT,
    MIDSTREAM_TILES,
    flash_interpolated_attention_plain,
    kernel_operands,
    midstream_tiles,
    takes_midstream,
)
from test_torch_dmid import _box_reader, _flat, _maps, _runs
from test_torch_ops import _swizzle128

SOURCE = Path(FA.__file__).resolve().parents[1] / "csrc" / "flash_attention_midstream.cu"
MODES = [m.value for m in AttnMode]
DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}
# f32 operands: the replay's arithmetic is the plain version's but for exp2
# with log2(e) folded into the scale and the online rescale (a few f32 ulps
# over a few hundred keys). bf16 / f16: P rounded to the dtype before P V
# (unnormalised tile probabilities), the output rounded once (2^-9 and 2^-11
# relative), as tests/test_torch_onepass.py holds them.
TOLS = {"f32": 1e-5, "bf16": 1e-2, "f16": 1e-2}


def _source_constants() -> dict:
    """kSmemLimit, each Mid<D> line (keys a tile, stages, ring buffers, most
    warpgroups), a block's shared-memory expression, the warpgroups a launch
    takes and the item a block's producer takes next, as the source states
    them."""
    text = SOURCE.read_text()
    mids = {int(d): tuple(int(x) for x in v) for d, *v in re.findall(
        r"struct Mid<(\d+)> \{ static constexpr int kBK = (\d+), kStages = (\d+), kRing = (\d+), kMaxWG = (\d+); \};",
        text)}
    smem = re.search(r"static constexpr int kSmem = ([^;]+);", text).group(1)
    return dict(limit=int(re.search(r"constexpr int kSmemLimit = (\d+);", text).group(1)), mids=mids, smem=smem,
                nwg=re.search(r"constexpr int NWG = ([^;]+);", text).group(1),
                next_item=re.search(r"int u = ([^;]+);", text).group(1))


SRC = _source_constants()


def _schedule(D: int, Sq: int) -> tuple:
    """(nwg, tiles) as the source's launch_sets picks them: the instance's
    most warpgroups (kMaxWG), the query tiles a (b, h)."""
    assert SRC["nwg"] == "Mid<D>::kMaxWG"
    nwg = SRC["mids"][D][3]
    return nwg, -(-Sq // (64 * nwg))


def _work_list(B: int, H: int, tiles: int, skipped: list) -> list:
    """The source's work list: (b, h, tile) at each position, four classes
    heaviest first (the rows that keep their endpoint segments with their
    full tiles, then their last tiles, then the skip rows' full and last
    tiles), head-major within a class."""
    out = []
    for skip in (False, True):
        rows = [b for b in range(B) if skipped[b] == skip]
        for js in (range(tiles - 1), [tiles - 1]):
            out += [(b, h, j) for h in range(H) for b in rows for j in js]
    return out


def _snake(blocks: int, units: int, blk: int) -> list:
    """The positions block ``blk`` of a grid of ``blocks`` takes: blk in even
    rounds, blocks - 1 - blk in odd ones, until one is past the list."""
    out = []
    for k in range(units):
        u = k * blocks + (blocks - 1 - blk if k % 2 else blk)
        if u >= units:
            break
        out.append(u)
    return out


def _emulate_midstream(ops: dict, blocks: int = 2, fault: str | None = None) -> torch.Tensor:
    """csrc/flash_attention_midstream.cu's data movement, replayed in plain
    torch from the C entry's own arguments, on a persistent grid of
    ``blocks`` blocks walking the work list in a snake (``_work_list``,
    ``_snake``).
    ``fault``: "early_release" (a stage's empty barrier counting the first
    consumer warpgroup's warps only: the producer refills it once that one
    has released it, and the others find the tile S stages on in it),
    "last_tile" (each (b, h)'s last query tile skipped), "q_overwrite" (the
    item R items on loads its Q over a buffer whose store has not read it:
    the stored rows are that Q), "own_not_parked" (the own segment's state
    not parked: the end set starts afresh)."""
    (B, H, Sq, D), strides, _ = _maps(ops)
    tensors, coef = ops["tensors"], ops["coef"]
    dt = tensors[0].dtype
    BK, S, R, _ = SRC["mids"][D]
    nwg, tiles = _schedule(D, Sq)
    S -= nwg == 3
    units = B * H * tiles
    chunks, ksteps = -(-D // 64), -(-D // 16)
    sl2 = ops["scale"] * 1.4426950408889634
    box = _box_reader(ops, 64, None)

    def kmajor(smem, start, rows):  # (rows, 16) through a K-major descriptor
        r, kc = torch.arange(rows)[:, None], torch.arange(16)[None, :]
        return smem[_swizzle128(start + (r // 8) * 1024 + (r % 8) * 128 + kc * 2) // 2]

    def mnmajor(smem, start):  # (16 keys, D) through the MN-major (transposed) descriptor, LBO one box
        kr, n = torch.arange(16)[:, None], torch.arange(D)[None, :]
        return smem[_swizzle128(start + (kr // 8) * 1024 + (kr % 8) * 128 + (n // 64) * BK * 128 + (n % 64) * 2)
                    // 2]

    skipped = [ops["n_sets"] > 0 and ops["skip"] is not None and bool(ops["skip"][b]) for b in range(B)]
    work = _work_list(B, H, tiles, skipped)

    def item(u):  # the source's work_item: position u of the list
        b, h, j = work[u]
        return b, h, j * 64 * nwg

    def stream(b, h):  # the K/V tiles of the item's (b, h) in the order the producer issues them
        runs, _ = _runs(ops, b)
        sb = {i: 0 if strides[i][0] == 0 else b for i in range(8)}
        return [(run_i, ki, vi, r0, min(BK, length - r0), sb[ki], sb[vi]) for run_i, run in enumerate(runs)
                for ki, vi, length in run for r0 in range(0, length, BK)]

    def tile(i, h, r0, b):  # one K or V tile of the stage: the kChunks boxes of BK rows
        return torch.cat([box(i, c, h, r0, b, BK) for c in range(chunks)])

    def descriptors(kt, vt):  # a stage as the descriptors read it: K K-major (k16 steps side by side), V MN-major
        return (torch.cat([kmajor(kt, (kk // 4) * BK * 128 + (kk % 4) * 32, BK) for kk in range(ksteps)], 1),
                torch.cat([mnmajor(vt, kk * 2048) for kk in range(BK // 16)]))

    out_flat = torch.zeros_like(_flat(tensors[7]))
    sb7, sh7, ss7 = strides[7]
    for blk in range(blocks):
        mine = _snake(blocks, units, blk)
        # the block's K/V stages in issue order
        seq = [(u, t) for u in mine for t in stream(*item(u)[:2])]
        it = 0
        qs = [None] * R  # the Q/O ring: what each buffer holds
        for i, u in enumerate(mine):
            b, h, q0 = item(u)
            if fault == "last_tile" and (q0 // (64 * nwg)) == tiles - 1:
                it += len(stream(b, h))
                continue
            qs[i % R] = [torch.cat([box(0, cc, h, q0 + 64 * w, b, 64) for cc in range(chunks)])
                         for w in range(nwg)]
            runs, blended = _runs(ops, b)
            cf = float(coef[b]) if blended else 0.0
            # the item's K/V stages, read by every warpgroup; with the fault, what
            # the warpgroups after the first find there: the tile S stages on
            stages, late = [], []
            for k_it in range(it, it + len(stream(b, h))):
                _, (_, ki, vi, rr, valid, kb, vb) = seq[k_it]
                stages.append((*descriptors(tile(ki, h, rr, kb), tile(vi, h, rr, vb)), valid))
                late.append(stages[-1])
                if fault == "early_release" and k_it + S < len(seq):
                    u2, (_, ki2, vi2, r2, _, kb2, vb2) = seq[k_it + S]
                    h2 = item(u2)[1]
                    late[-1] = (*descriptors(tile(ki2, h2, r2, kb2), tile(vi2, h2, r2, vb2)), valid)
            results = []
            for w in range(nwg):
                if q0 + 64 * w >= Sq:  # every row past Sq: the warpgroup only passes the stages on
                    results.append(None)
                    continue
                seen = late if w > 0 else stages
                qt = qs[i % R][w]
                qm = torch.cat([kmajor(qt, (kk // 4) * 8192 + (kk % 4) * 32, 64) for kk in range(ksteps)], 1)
                state = (torch.zeros(64, D), torch.full((64,), -math.inf), torch.zeros(64))
                parked, j = None, 0
                for run_i, run in enumerate(runs):
                    if blended and run_i == len(runs) - 1:  # the end run: swap in the parked state
                        o, m, lsum = state
                        begin = o / lsum[:, None] * (1 - cf)
                        if len(runs) == 3 and fault != "own_not_parked":
                            state = parked
                        else:
                            state = (torch.zeros(64, D), torch.full((64,), -math.inf), torch.zeros(64))
                        parked = begin
                    for _ in range(sum(-(-length // BK) for _, _, length in run)):
                        kmat, vmat, valid = seen[j]
                        j += 1
                        s = qm @ kmat.T
                        s[:, valid:] = -math.inf
                        o, m, lsum = state
                        mn = torch.maximum(m, s.max(dim=1).values)
                        alpha = torch.exp2((m - mn) * sl2)
                        p = torch.exp2(s * sl2 - (mn * sl2)[:, None])
                        o = o * alpha[:, None] + p.to(dt).float() @ vmat
                        state = (o, mn, lsum * alpha + p.sum(dim=1))
                    if blended and run_i == 0 and len(runs) == 3:
                        parked = state
                o, _, lsum = state
                o = o / lsum[:, None] * (cf if blended else 1.0)
                if blended:
                    o = o + parked
                results.append(o.to(dt).float())
            it += len(stream(b, h))
            for w, o in enumerate(results):
                if o is None:
                    continue
                if fault == "q_overwrite" and i + R < len(mine):  # the Q R items on, read by this store
                    b2, h2, q2 = item(mine[i + R])
                    o = torch.zeros(64, D)
                    rows_q = tensors[0][b2, h2, q2 + 64 * w:q2 + 64 * w + 64].float()
                    o[:rows_q.shape[0]] = rows_q
                r, cc = torch.arange(64)[:, None], torch.arange(D)[None, :]
                rows = q0 + 64 * w + r
                keep = (rows < Sq).expand(64, D)  # the TMA store clips rows past Sq (and columns past D)
                dst = (b * sb7 + h * sh7 + rows * ss7 + cc)[keep]
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


def _replay_vs_plain(dtype, D, mode, case, blocks=2, fault=None):
    B, H, S, L, Le, ep = case
    q, k, v, coef, skip, eps = _inputs(B, H, S, L, D, DTYPES[dtype], 7, ep, Le)
    kw = dict(skip_endpoints=skip, **eps)
    ops = kernel_operands(q, k, v, coef, mode, midstream=dtype != "f32", **kw)
    got = _emulate_midstream(ops, blocks, fault)
    want = flash_interpolated_attention_plain(q.float(), k.float(), v.float(), coef, mode,
                                              **{n: x.float() for n, x in eps.items()}, skip_endpoints=skip)
    return th.max_rel_err(got.float().numpy(), want.float().numpy())


# (B, H, Sq, Lk, Le, endpoints): two query tiles a (b, h) (D = 64: 192 rows,
# the second with its last warpgroup past Sq; D = 80: 128 rows) over a ragged
# 300-key own segment and shared 131-key endpoints; 192 queries (D = 64: one
# 192-row tile; D = 80: two 128-row tiles, the last clipped at Sq) with
# per-row 70-key endpoints; 320 own keys and queries (D = 64: two tiles, the
# last with one warpgroup past Sq; D = 80: three, the last half past it) with
# rows 0 / B-1 as endpoints
CASES = {
    "own300_shared131": (3, 2, 256, 300, 131, 3),
    "q192_rows70": (3, 2, 192, 257, 70, 4),
    "own320": (2, 2, 320, 320, None, None),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("D,mode,case", [(D, m, c) for D in (64, 80) for m in MODES for c in CASES])
def test_midstream_replay_matches_plain(dtype, D, mode, case):
    """Every mode at both head dims, on two blocks of the persistent grid
    (each walking several items)."""
    assert _replay_vs_plain(dtype, D, mode, CASES[case]) < TOLS[dtype]


@pytest.mark.parametrize("blocks", [1, 3, 4, 5, 12])
@pytest.mark.parametrize("mode", ["fused_outer", "self"])
def test_midstream_replay_schedules(blocks, mode):
    """The persistent grid at other counts: one block walking every item,
    counts that cut the list across (b, h) and heads unevenly, and one block
    an item (the grid when the items are fewer than the SMs hold: 12 here)."""
    assert _replay_vs_plain("bf16", 64, mode, CASES["own300_shared131"], blocks) < TOLS["bf16"]


@pytest.mark.parametrize("B,H,tiles,skipped,blocks", [
    (7, 20, 6, (0, 6), 132),  # SDXL fused_outer (7,20,1024,64) on an H100's 132 SMs
    (7, 20, 6, (), 132),      # its self mode
    (7, 20, 3, (0, 6), 132),  # SD 2.1's 576 tokens
    (7, 8, 8, (0, 6), 132),   # SD 1.5's 1024 at D = 80
    (3, 2, 1, (1,), 5),       # one tile a (b, h): the last-tile classes only
])
def test_midstream_work_list_covers_every_item_once(B, H, tiles, skipped, blocks):
    """The work list holds every (b, h, tile) once, heaviest class first
    (rows that keep their endpoints before skip rows, a (b, h)'s full tiles
    before its last), and the grid's snake takes every position once, no
    block more than one more item than another."""
    work = _work_list(B, H, tiles, [b in skipped for b in range(B)])
    assert sorted(work) == sorted((b, h, j) for b in range(B) for h in range(H) for j in range(tiles))
    weight = [(b in skipped, j == tiles - 1) for b, _, j in work]
    assert weight == sorted(weight)
    taken = [_snake(blocks, len(work), blk) for blk in range(blocks)]
    assert sorted(u for mine in taken for u in mine) == list(range(len(work)))
    assert max(map(len, taken)) - min(map(len, taken)) <= 1


@pytest.mark.parametrize("fault,mode,case", [
    ("early_release", "self", "own300_shared131"),
    ("early_release", "fused_outer", "own300_shared131"),
    ("last_tile", "self", "own320"),
    ("last_tile", "fused_inner", "own300_shared131"),
    ("q_overwrite", "self", "own300_shared131"),
    ("own_not_parked", "fused_outer", "own300_shared131"),
    ("own_not_parked", "fused_outer", "q192_rows70"),
])
def test_midstream_planted_faults_miss_the_bound(fault, mode, case):
    """Each planted fault moves the replay past the bf16 bound, where the
    sound replay of the same call stays within it (one block: every item of
    the list in one ring)."""
    assert _replay_vs_plain("bf16", 64, mode, CASES[case], blocks=1) < TOLS["bf16"]
    assert _replay_vs_plain("bf16", 64, mode, CASES[case], blocks=1, fault=fault) > TOLS["bf16"]


def _jax(q, k, v, coef, mode, skip, eps):
    return np.asarray(jax_flash(*(jnp.asarray(x.float().numpy()) for x in (q, k, v)), jnp.asarray(coef.numpy()),
                                mode, **{n: jnp.asarray(x.float().numpy()) for n, x in eps.items()},
                                skip_endpoints=jnp.asarray(skip.numpy()), interpret=True))


@pytest.mark.parametrize("mode,case", [
    ("self", (3, 2, 256, 256, None, None)),
    ("fused_outer", (3, 2, 256, 256, None, None)),
    ("pure_outer", (3, 2, 384, 300, 300, 3)),
    ("fused_inner", (3, 2, 384, 300, 131, 4)),
    ("pure_inner", (3, 2, 320, 64, 288, 3)),
])
def test_midstream_replay_matches_jax_interpret(mode, case):
    """At shapes the JAX wrapper sends to `_kernel_onepass` (streams over 240
    keys, up to its onepass_max): the replay in f32 against the JAX wrapper
    in interpret mode, beside the plain version against it; the same call
    in bf16 lays out for the mid-length stream kernel when sent there, and
    takes it by the route where its measured limits allow (queries under
    MIDSTREAM_MIN_QUERIES stay on the streaming kernel)."""
    B, H, S, L, Le, ep = case
    q, k, v, coef, skip, eps = _inputs(B, H, S, L, 64, torch.float32, 11, ep, Le)
    le = L if Le is None else Le
    stream = (mode in ("self", "fused_outer", "fused_inner")) * L + {"self": 0, "fused_inner": 1, "pure_inner": 1}.get(
        mode, 2) * le
    assert 240 < stream <= 3072
    want = _jax(q, k, v, coef, mode, skip, eps)
    plain = flash_interpolated_attention_plain(q, k, v, coef, mode, skip_endpoints=skip, **eps)
    assert th.max_rel_err(plain.numpy(), want) < 1e-5
    ops = kernel_operands(q, k, v, coef, mode, skip_endpoints=skip, **eps)
    assert not ops["midstream"]  # f32 keeps its own kernel; the replay follows the operands' dtype
    assert th.max_rel_err(_emulate_midstream(ops).numpy(), want) < TOLS["f32"]
    bf16 = {n: x.to(torch.bfloat16) for n, x in dict(q=q, k=k, v=v, **eps).items()}
    routed = kernel_operands(coef=coef, mode=mode, skip_endpoints=skip, **bf16)
    assert S < MIDSTREAM_MIN_QUERIES and not routed["midstream"]
    sent = kernel_operands(coef=coef, mode=mode, skip_endpoints=skip, midstream=True, **bf16)
    assert sent["entry"] == MIDSTREAM_ENTRIES[torch.bfloat16] and sent["dims"] == routed["dims"]


def test_midstream_constants_match_the_source():
    """The Python mirror of the source's instances and schedule (block i of
    the persistent grid taking position i of even rounds, grid - 1 - i of
    odd ones), and a block's shared memory as the source computes it, under
    its limit."""
    assert SRC["limit"] == MIDSTREAM_SMEM_LIMIT
    assert SRC["next_item"] == "i * gridDim.x + (i & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x)"
    assert SRC["mids"] == MIDSTREAM_TILES
    for D, (bk, stages, ring, most) in MIDSTREAM_TILES.items():
        for Sq in (192, 256, 576, 1024, 2304):
            t = midstream_tiles(D, Sq, 7, 20)
            assert (t["nwg"], t["tiles"]) == _schedule(D, Sq)
            assert t["stages"] == stages - (t["nwg"] == 3)
            env = dict(kRing=ring, kQBytes=t["nwg"] * 64 * 128 * t["chunks"], kStages=t["stages"],
                       kStageBytes=2 * bk * 128 * t["chunks"], kParkBytes=t["nwg"] * 128 * (D // 2 + 4) * 4)
            want = eval(SRC["smem"], {}, env)  # noqa: S307 (the source's own line)
            assert t["smem"] == want <= MIDSTREAM_SMEM_LIMIT
            assert t["units"] == 7 * 20 * t["tiles"]
    # the paths' shapes: 192-row items at D = 64 (1024 queries: six, the last with two warpgroups idle; 576:
    # three), 128-row items at D = 80
    assert [midstream_tiles(64, 1024)[k] for k in ("BQ", "tiles", "idle")] == [192, 6, True]
    assert [midstream_tiles(64, 576)[k] for k in ("BQ", "tiles", "idle")] == [192, 3, False]
    assert [midstream_tiles(80, 1024)[k] for k in ("BQ", "tiles", "idle")] == [128, 8, False]
    assert midstream_tiles(64, 1100)["idle"] is False and midstream_tiles(64, 1088)["idle"] is True


@pytest.mark.parametrize("D,Sq,Lk,Le,mode,takes", [
    (64, 1024, 1024, 1024, "self", True),         # SDXL's 1024-token self call
    (64, 1024, 1024, 1024, "fused_outer", True),  # its warmup call: 3072 keys
    (64, 1024, 1025, 1024, "fused_outer", False),  # past onepass_max: the streaming kernel
    (64, 4096, 4096, 4096, "self", False),        # the 4096-token calls stay
    (64, 576, 576, 576, "self", True),            # SD 2.1's 24^2 level
    (64, 2304, 2304, 2304, "self", True),         # SD 2.1's 48^2 level, self mode
    (64, 2304, 2304, 2304, "pure_inner", True),
    (80, 1024, 1024, 1024, "self", True),         # SD 1.5's 32^2 level
    (80, 1024, 1024, 1024, "fused_outer", False),  # the outer modes at D = 80: measured slower
    (80, 1024, 1024, 1024, "fused_inner", False),
    (80, 1024, 1024, 1024, "pure_inner", False),
    (64, 4096, 77, 77, "fused_outer", False),     # the short-stream kernel's
    (64, 1024, 240, 240, "self", False),          # 15 16-key tiles: the short-stream kernel's
    (64, 1024, 241, 241, "self", True),
    (64, MIDSTREAM_MIN_QUERIES - 1, 1024, 1024, "self", False),  # the measured limit
    (160, 256, 256, 256, "self", False),          # no instance at D = 160 (nor 40)
    (40, 1024, 1024, 1024, "self", False),
])
def test_midstream_route_limits(D, Sq, Lk, Le, mode, takes):
    """The route at its limits: the stream against the short-stream kernel's
    largest instance and onepass_max, the measured query limit and modes at
    each head dim, the instance head dims; f32 never takes it."""
    assert MIDSTREAM_MAX_STREAM == 3072
    assert MIDSTREAM_MODES == {64: {"self", "fused_outer", "pure_outer", "fused_inner", "pure_inner"}, 80: {"self"}}
    assert takes_midstream(D, Sq, Lk, Le, mode, torch.bfloat16) is takes
    assert takes_midstream(D, Sq, Lk, Le, mode, torch.float16) is takes
    assert not takes_midstream(D, Sq, Lk, Le, mode, torch.float32)


def test_midstream_operands_route_and_raise():
    """kernel_operands names the new entry where the route takes the call,
    keeps the streaming entry when told (the route before, for timing it
    beside), sends any bf16 / f16 call at D = 64 or 80 there when told, and
    raises where the kernel has no instance."""
    for dtype in (torch.bfloat16, torch.float16):
        q, k, v, coef, skip, eps = _inputs(3, 2, 576, 300, 64, dtype, 3, 3, 131)
        ops = kernel_operands(q, k, v, coef, "fused_outer", skip_endpoints=skip, **eps)
        assert ops["midstream"] and not ops["onepass"] and ops["entry"] == MIDSTREAM_ENTRIES[dtype]
        assert ops["work"] is None
        ops = kernel_operands(q, k, v, coef, "fused_outer", skip_endpoints=skip, midstream=False, **eps)
        assert not ops["midstream"] and ops["entry"] == FA.KERNEL_ENTRIES[dtype]
        # padded head dims route by the instance's: D = 72 runs at 80
        q72, k72, v72, *_ = _inputs(3, 2, 576, 300, 72, dtype, 3)
        ops = kernel_operands(q72, k72, v72, coef, "self")
        assert ops["midstream"] and ops["dims"][5] == 80
        # a short stream goes to the short-stream kernel unless told
        qs, ks_, vs_, *_ = _inputs(3, 2, 576, 77, 64, dtype, 4)
        assert kernel_operands(qs, ks_, vs_, coef, "self")["onepass"]
        assert kernel_operands(qs, ks_, vs_, coef, "self", midstream=True)["entry"] == MIDSTREAM_ENTRIES[dtype]
        q160, k160, v160, *_ = _inputs(3, 2, 576, 256, 160, dtype, 5)
        assert not kernel_operands(q160, k160, v160, coef, "self")["midstream"]
        with pytest.raises(NotImplementedError, match="mid-length"):
            kernel_operands(q160, k160, v160, coef, "self", midstream=True)
    q, k, v, coef, *_ = _inputs(3, 2, 256, 300, 64, torch.float32, 3)
    with pytest.raises(NotImplementedError, match="mid-length"):
        kernel_operands(q, k, v, coef, "self", midstream=True)


def test_midstream_counts_reset():
    """The wrappers' mid-length stream counts by head dim start at 0 and are
    reset with the rest; a CPU call launches nothing."""
    FA.reset_launch_counts()
    for fn in (FA.flash_interpolated_attention, FA.flash_interpolated_attention_f16,
               FA.flash_interpolated_attention_f32):
        assert fn.launches_midstream == dict.fromkeys(FA.KERNEL_HEAD_DIMS, 0)
    q, k, v, coef, skip, eps = _inputs(3, 2, 256, 300, 64, torch.bfloat16, 5)
    FA.flash_interpolated_attention(q, k, v, coef, "fused_outer", skip_endpoints=skip)
    assert FA.flash_interpolated_attention.launches_midstream[64] == 0
    assert FA.flash_interpolated_attention.launches == 0
