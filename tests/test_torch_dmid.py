"""The D=161-512 kernels' data movement, replayed on the CPU: the four
endpoint modes and self mode (the instance with no endpoint set).

csrc/flash_attention_dmid.cu (bf16 and f16: the rows layout, each consumer
warpgroup over its own 64 query rows and all of D, one or two warpgroups a
block; the split layout, two warpgroups splitting D and exchanging partial
scores) and csrc/flash_attention_dmid_f32.cu (3xTF32, two warpgroups sharing
a tile's Q K^T chunks and O^T's M blocks) have no CPU mode. Each replay
below reads the operands as the kernel's tensor maps read them, from the C
entry's own arguments (``ops.flash_attention.kernel_operands``): boxes over
the caller's tensors (columns past D and rows past a segment zero-filled),
the 128-byte swizzle, the wgmma descriptors and register fragments, the key
stream's segments with their masked last tiles and skip rows, the outer
modes' own state parked in the workspace and swapped word for word, self
mode's own segment alone, and the output stored clipped at Sq and D. Their
tile constants are read from the sources. Against the plain version in f32:
bf16 and f16 to 1e-2 of max |ref| (P's rounding and the output's), f32 to
1e-5 (the three-pass split); self mode also against the JAX wrapper in
interpret mode. Planted faults (a chunk too few, the own state not restored
for the end set, a shared endpoint read at the row's batch, the last ragged
own tile unmasked) must miss those bounds.
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
    dmid_tiles,
    flash_interpolated_attention_plain,
    kernel_operands,
    takes_d512_self,
)
from test_torch_ops import _softmax_tile, _swizzle64, _swizzle128, _tf32_read, _tf32_rest, _wgmma_acc_index

CSRC = Path(FA.__file__).resolve().parents[1] / "csrc"
DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}
ENDPOINT_MODES = ("fused_outer", "pure_outer", "fused_inner", "pure_inner")
# the modes the entries take: the four endpoint modes and self mode (n_sets 0)
REPLAY_MODES = (*ENDPOINT_MODES, "self")
# the two query rows of each of a warpgroup's 128 threads in a wgmma accumulator: 16 warp + g and + 8
_THREAD_ROWS = (16 * (torch.arange(128) // 32) + torch.arange(128) % 32 // 4,
                16 * (torch.arange(128) // 32) + torch.arange(128) % 32 // 4 + 8)


def _maps(ops: dict) -> tuple:
    """The maps the entry reads, from its 30 dims: ((B, H, Sq, D), each
    map's (b, h, s) strides, each map's row extent) for q, k, v, k_begin,
    v_begin, k_end, v_end, out."""
    dims = ops["dims"]
    B, H, Sq, Lk, Le, D = dims[:6]
    return (B, H, Sq, D), [dims[6 + 3 * i:9 + 3 * i] for i in range(8)], [Sq, Lk, Lk, Le, Le, Le, Le, Sq]


def _runs(ops: dict, b: int) -> tuple:
    """Batch row b's key stream as the kernels walk it: a list of runs (a
    softmax set's stretch between the outer modes' park and swap points),
    each a list of (K map, V map, length) segments, and whether the row
    blends two sets."""
    Lk, Le = ops["dims"][3:5]
    own = [(1, 2, Lk)] if ops["has_own"] else []
    if own and (ops["n_sets"] == 0 or ops["skip"] is not None and bool(ops["skip"][b])):
        return [own], False  # self mode, or a skip row: the own segment alone
    if ops["n_sets"] == 1:
        return [own + [(3, 4, Le)]], False
    return ([own] if own else []) + [[(3, 4, Le)], [(5, 6, Le)]], True


def _flat(x: torch.Tensor) -> torch.Tensor:
    """x's storage from its offset on, as f32 elements."""
    n = x.untyped_storage().nbytes() // x.element_size() - x.storage_offset()
    return torch.as_strided(x, (n,), (1,), x.storage_offset()).float()


def _box_reader(ops: dict, width: int, fault: str | None):
    """box(i, c, h, s0, b, rows): the box of map i at column width * c,
    rows s0 .., into a tile of ``rows`` 128-byte rows under the 128-byte
    swizzle (flat, by element): zeros past D, past the map's row extent,
    and, for a shared endpoint (batch stride 0, batch extent 1), at any
    batch but 0 where ``fault`` is "shared_batch" (it reads the row's
    batch)."""
    (_, _, _, D), strides, extents = _maps(ops)
    flat = [_flat(x) for x in ops["tensors"]]
    esize = 128 // width

    def box(i, c, h, s0, b, rows):
        sb, sh, ss = strides[i]
        r, x = torch.arange(rows)[:, None], torch.arange(width)[None, :]
        ok = (s0 + r < extents[i]) & (width * c + x < D)
        if sb == 0 and b > 0 and fault == "shared_batch":
            ok = ok & False
        idx = torch.where(ok, (0 if sb == 0 else b) * sb + h * sh + (s0 + r) * ss + width * c + x, 0)
        tile = torch.zeros(rows * width)
        tile[_swizzle128(r * 128 + x * esize).reshape(-1) // esize] = torch.where(ok, flat[i][idx], 0.0).reshape(-1)
        return tile

    return box


def _sets(runs: list, blended: bool, coef: float, state: tuple, run_tiles, put, get, zero, scale_rows,
          fault: str | None, guard=lambda lsum: lsum) -> object:
    """One query tile's runs as the endpoint kernels chain them: a blended
    row's own state (O, m, l) parked after its run (``put``), the begin run
    continuing it to (1 - c) O / l, swapped with the parked own state
    (``get``), the end run continuing that to c O / l, plus the parked
    words; the pure outer mode parks (1 - c) O / l and starts the end set
    afresh (``zero``). ``fault`` "own_not_restored": the end set continues
    the begin set's state. ``guard`` maps the row sums before they divide
    (the static instances' max(l, 1e-37)). Returns the normalised O."""
    if not blended:
        for run in runs:
            state = run_tiles(state, run)
        o, _, lsum = state
        return scale_rows(o, 1.0 / guard(lsum))
    own = len(runs) == 3
    state = run_tiles(state, runs[0])
    if own:
        put(*state)
        state = run_tiles(state, runs[1])
    o, m, lsum = state
    o = scale_rows(o, (1 - coef) / guard(lsum))
    if own:
        words = get()
        put(o, m, lsum)
        state = (o, m, lsum) if fault == "own_not_restored" else words
    else:
        put(o, m, lsum)
        state = zero()
    o, _, lsum = run_tiles(state, runs[-1])
    return scale_rows(o, coef / guard(lsum)) + get()[0]


class _PerWG(list):
    """A per-warpgroup list (O, max or row sums of each warpgroup's rows)
    that adds elementwise and divides a number by each row sum."""

    def __add__(self, other):
        return _PerWG(x + y for x, y in zip(self, other))

    def __rtruediv__(self, c):
        return _PerWG(c / x for x in self)


def _scale_rows(o, f):
    """Each warpgroup's O scaled by its rows' factors."""
    return _PerWG(x * fw[:, None] for x, fw in zip(o, f))


def _emulate_dmid16(ops: dict, fault: str | None = None) -> torch.Tensor:
    """csrc/flash_attention_dmid.cu's data movement (bf16 or f16), replayed
    in plain torch from the C entry's own arguments.

    Every operand arrives in boxes of 64 columns (128 bytes, the 128-byte
    swizzle) over the caller's tensors: zeros past D (the last chunk of D =
    200), past Sq and past a segment's length; a shared endpoint through a
    batch extent of 1. The rows layout (up to 5 chunks): each consumer
    warpgroup of a block (one, or two where the 64-row grid is over one
    wave) takes 64 query rows, S = Q K^T over every chunk through K-major
    descriptors (the tile's keys from the source: 64, or 48 at 5 chunks),
    P in the element type as the A registers of P V, V through the MN-major
    descriptor (LBO one box); its O registers park in its own row tile of
    the workspace. The split layout (6..8 chunks, 7 as 8): two warpgroups
    over 3 or 4 chunks each compute partial scores, write them to the
    exchange in accumulator order and add the other's (both must hold the
    same scores), 32-key tiles, each parking its own columns' registers.
    The output leaves through each warpgroup's part of the swizzled Q tile
    and a TMA store clipped at Sq and D. f32 arithmetic. ``fault``: "chunks"
    (a chunk too few: the kernel instance of one chunk less), "own_not_restored"
    (:func:`_sets`), "shared_batch" (:func:`_box_reader`), "own_unmasked"
    (the own segment's last ragged tile not masked: its keys past Lk, zeros
    from the maps' fill, take part in the softmax). With ``ops["static"]``
    (the static-shift instance) P is the static shift's, with no max or
    rescale, and the park keeps O and l alone."""
    (B, H, Sq, D), strides, _ = _maps(ops)
    tensors = ops["tensors"]
    dt = tensors[0].dtype
    static = ops.get("static")
    t = dmid_tiles(D, dt, B, H, Sq)
    rows_layout = t["layout"] == "rows"
    BK, nwg = t["BK"], t["nwg"]
    nc = t["chunks"] - (fault == "chunks")
    cols = 64 * nc if rows_layout else 64 * (t["ncw"] - (fault == "chunks"))  # a warpgroup's output columns
    boxes_wg = cols // 64
    sl2 = ops["scale"] * 1.4426950408889634
    box = _box_reader(ops, 64, fault)

    def kmajor(smem, start, rows):  # (rows, 16) through a K-major descriptor
        r, kc = torch.arange(rows)[:, None], torch.arange(16)[None, :]
        return smem[_swizzle128(start + (r // 8) * 1024 + (r % 8) * 128 + kc * 2) // 2]

    def mnmajor(smem, start, lbo):  # (16 keys, cols) through the MN-major (transposed) descriptor
        kr, n = torch.arange(16)[:, None], torch.arange(cols)[None, :]
        return smem[_swizzle128(start + (kr // 8) * 1024 + (kr % 8) * 128 + (n // 64) * lbo + (n % 64) * 2) // 2]

    orow, ocol = _wgmma_acc_index(cols)  # a thread's output accumulators (rows, columns)
    arow, acol = _wgmma_acc_index(BK)
    nw = nwg if rows_layout else 2  # consumer warpgroups a block
    threads = t["park_threads"]
    out_flat = torch.zeros_like(_flat(tensors[7]))
    work = ops["work"]
    coef = ops["coef"]
    for b in range(B):
        runs, blended = _runs(ops, b)
        for h in range(H):
            for blk in range(-(-Sq // t["BQ"])):
                q0 = blk * t["BQ"]
                # each query tile of 64 rows: (row start, Q tile, first column box) of each warpgroup
                if rows_layout:
                    qts = [(q0 + 64 * w, torch.cat([box(0, c, h, q0 + 64 * w, b, 64) for c in range(nc)]), 0)
                           for w in range(nw)]
                else:
                    qt = torch.cat([box(0, c, h, q0, b, 64) for c in range(2 * t["ncw"])])
                    qts = [(q0, qt, t["ncw"] * w) for w in range(2)]

                def update(state, ki, vi, r0, length):
                    o, m, lsum = state
                    nbox = nc if rows_layout else 2 * t["ncw"]
                    kt = torch.cat([box(ki, c, h, r0, b, BK) for c in range(nbox)])
                    vt = torch.cat([box(vi, c, h, r0, b, BK) for c in range(nbox)])
                    if rows_layout:  # each warpgroup its own rows over every chunk
                        s = [sum(kmajor(qt, (kk // 4) * 64 * 128 + (kk % 4) * 32, 64)
                                 @ kmajor(kt, (kk // 4) * BK * 128 + (kk % 4) * 32, BK).T for kk in range(4 * nc))
                             for _, qt, _ in qts]
                    else:  # partial scores over each warpgroup's chunks, exchanged in accumulator order
                        xbuf = [sum(kmajor(qt, (c0 + kk // 4) * 64 * 128 + (kk % 4) * 32, 64)
                                    @ kmajor(kt, (c0 + kk // 4) * BK * 128 + (kk % 4) * 32, BK).T
                                    for kk in range(4 * boxes_wg))[arow, acol] for _, qt, c0 in qts]
                        s = []
                        for w in range(2):
                            sw = torch.zeros(64, BK)
                            sw[arow, acol] = xbuf[w] + xbuf[1 - w]
                            s.append(sw)
                        assert torch.equal(s[0], s[1])
                    new = ([], [], [])
                    for w, (_, _, c0) in enumerate(qts):
                        sw = s[w].clone()
                        if not (fault == "own_unmasked" and ki == 1):
                            sw[:, min(BK, length - r0):] = -math.inf
                        p, mn, lw, alpha = _softmax_tile(sw, m[w], lsum[w], sl2, static)
                        pb = p.to(dt).float()
                        ow = o[w] * alpha[:, None] + sum(
                            pb[:, 16 * kk:16 * kk + 16] @ mnmajor(vt, c0 * BK * 128 + kk * 2048, BK * 128)
                            for kk in range(BK // 16))
                        for lst, x in zip(new, (ow, mn, lw)):
                            lst.append(x)
                    return new

                def run_tiles(state, run):
                    for ki, vi, length in run:
                        for r0 in range(0, length, BK):
                            state = update(state, ki, vi, r0, length)
                    return state

                # the workspace words of each warpgroup's threads (in its row tile: [word, thread])
                def slot(w):
                    if rows_layout:
                        return work[((b * H + h) * -(-Sq // t["BQ"]) + blk) * nwg + w][:, :128]
                    return work[(b * H + h) * -(-Sq // 64) + blk][:, 128 * w:128 * (w + 1)]

                def put(o, m, lsum):
                    for w in range(nw):
                        words = slot(w)
                        words[:cols // 2] = o[w][orow, ocol].T
                        for j, r in enumerate(_THREAD_ROWS):
                            if static is None:  # the static shift parks no max
                                words[cols // 2 + j] = m[w][r]
                            words[cols // 2 + 2 + j] = lsum[w][r]

                def get():
                    o, m, lsum = [], [], []
                    for w in range(nw):
                        words = slot(w)
                        ow, mw, lw = torch.zeros(64, cols), torch.empty(64), torch.empty(64)
                        ow[orow, ocol] = words[:cols // 2].T
                        for j, r in enumerate(_THREAD_ROWS):
                            mw[r], lw[r] = words[cols // 2 + j], words[cols // 2 + 2 + j]
                        o.append(ow)
                        m.append(mw)
                        lsum.append(lw)
                    return o, m, lsum

                def zero():
                    return ([torch.zeros(64, cols) for _ in range(nw)], [torch.full((64,), -math.inf)] * nw,
                            [torch.zeros(64)] * nw)

                def zero_sets():
                    return tuple(_PerWG(x) for x in zero())

                def get_sets():
                    return tuple(_PerWG(x) for x in get())

                def run_sets(state, run):
                    return tuple(_PerWG(x) for x in run_tiles(state, run))

                o = _sets(runs, blended, float(coef[b]) if blended else 1.0, zero_sets(), run_sets, put, get_sets,
                          zero_sets, _scale_rows, fault,
                          (lambda lw: lw) if static is None else (lambda lw: _PerWG(x.clamp_min(1e-37) for x in lw)))
                for w, (r0, _, c0) in enumerate(qts):
                    ob = o[w].to(dt).float()
                    r, col = torch.arange(64)[:, None], torch.arange(cols)[None, :]
                    tile = torch.zeros(64 * cols)
                    addr = (col // 64) * (64 * 128) + _swizzle128(r * 128 + (col % 64) * 2)
                    tile[(addr // 2).reshape(-1)] = ob.reshape(-1)
                    gcol = 64 * c0 + col
                    sb, sh, ss = strides[7]
                    keep = (r0 + r < Sq) & (gcol < D)
                    dst = (b * sb + h * sh + (r0 + r) * ss + gcol)[keep]
                    out_flat[dst] = tile[(addr // 2)[keep]]
    out = tensors[7]
    return torch.as_strided(out_flat, out.shape, out.stride()).to(dt)


def _emulate_dmid_f32(ops: dict, fault: str | None = None) -> torch.Tensor:
    """csrc/flash_attention_dmid_f32.cu's data movement, replayed in plain
    torch from the C entry's own arguments.

    Every operand arrives in boxes of 32 f32 columns (128 bytes, the
    128-byte swizzle) over the caller's tensors, zeros past D and past a
    segment; V in 2 MB boxes (the last past D zero-filled where D has an odd
    count of chunks). Warpgroup 0 computes the partial scores over chunks 0
    .. cq0 - 1 and O^T's M blocks 0 .. MBW - 1, warpgroup 1 the other chunks
    and the last MBW M blocks, the middle one of an odd count computed by
    both (:func:`~aid_tpu_torch.ops.flash_attention.dmid_tiles`). Q K^T reads Q's
    hi, lo and bf16 fragments as ``load_q`` fills the A registers, K
    through its K-major descriptor and K's lo in bf16 as each warpgroup's
    ``make_klo`` writes its chunks (boxes of 64 columns); the partial scores
    go to the exchange in accumulator order and come back added to the
    other's (both must hold the same scores). The softmax writes P^T's hi
    (keys permuted within each 8-key step) and its packed bf16 row under the
    swizzle of its width (64 bytes at 16-key tiles, 128 at 32) and the rows'
    factors, each warpgroup the rows of its half; O^T = V^T P^T takes V^T's
    hi and packed bf16 registers as ``load_v`` reads them, an M block at a
    time from zero, folded by the factor of each query column. The outer
    modes' own state parks in the block's workspace (32 MBW + 4 words a
    consumer thread, side by side). Operands are truncated to tf32 (rounded
    to bf16 in the bf16 passes) where the tensor cores read them, products
    summed in f64; the output is stored from O^T at the output's strides,
    head-dim rows past D and query rows past Sq dropped. ``fault``:
    "chunks" (a chunk too few in Q K^T), "own_not_restored", "shared_batch",
    "own_unmasked" (as :func:`_emulate_dmid16`). With ``ops["static"]``
    (the static-shift instance) P is the static shift's, with no max and
    factors of 1, and the park keeps O and l alone."""
    (B, H, Sq, D), strides, _ = _maps(ops)
    tensors = ops["tensors"]
    static = ops.get("static")
    t = dmid_tiles(D, torch.float32, B, H, Sq)
    C, BK, mb, mbw, cq0 = t["chunks"], t["BK"], t["mb"], t["mbw"], t["cq0"]
    chunks = [range(0, cq0), range(cq0, C - (fault == "chunks"))]  # each warpgroup's Q K^T chunks
    mblocks = [range(0, mbw), range(mb - mbw, mb)]  # and its M blocks of O^T
    sl2 = ops["scale"] * 1.4426950408889634
    box = _box_reader(ops, 32, fault)
    swz = _swizzle64 if BK == 16 else _swizzle128  # P^T's rows: BK f32, 64 or 128 bytes

    def bf16(x):
        return x.float().to(torch.bfloat16).double()

    lane = torch.arange(32)
    g, tq = lane // 4, lane % 4
    warp, e = torch.arange(4)[:, None, None], torch.arange(4)[None, None, :]
    gg, tt = g[None, :, None], tq[None, :, None]
    # (64, 32 C): the element of the Q tile that load_q(c) puts in the A registers at (row, column)
    q_reg = torch.zeros(64, 32 * C, dtype=torch.long)
    for c in range(C):
        for kk in range(4):
            idx = c * 64 * 32 + (16 * warp + gg) * 32 + tt + (e & 1) * 256 + (((2 * kk + (e >> 1)) ^ gg) << 2)
            rows = (16 * warp + gg + 8 * (e & 1)).expand(4, 32, 4)
            q_reg[rows, (32 * c + 8 * kk + tt + 4 * (e >> 1)).expand(4, 32, 4)] = idx
    # the bf16 pass's A registers: k16 step i of a chunk from k8 steps 2i, 2i + 1; k positions 2t, 2t + 1
    # hold columns t, t + 4 and 2t + 8, 2t + 9 columns t + 8, t + 12 (of the 16)
    bf_col = torch.zeros(16, dtype=torch.long)
    for t4 in range(4):
        bf_col[[2 * t4, 2 * t4 + 1, 2 * t4 + 8, 2 * t4 + 9]] = torch.tensor([t4, t4 + 4, t4 + 8, t4 + 12])
    q_bf = q_reg.view(64, 2 * C, 16)[..., bf_col].reshape(64, 32 * C)
    # (BK, 32 C): K through its K-major descriptor; K's lo through the bf16 one (64-column boxes)
    rk, j = torch.arange(BK)[:, None], torch.arange(32 * C)[None, :]
    k_desc = _swizzle128((j // 32) * BK * 128 + (j % 32 // 8) * 32 + (rk // 8) * 1024 + (rk % 8) * 128
                         + (j % 8) * 4) // 4
    kl_desc = _swizzle128((j // 64) * BK * 128 + (j % 64 // 16) * 32 + (rk // 8) * 1024 + (rk % 8) * 128
                          + (j % 16) * 2) // 2
    # make_klo of warpgroup w over its chunks: items (key r, 8-column half) of 128 threads, two source
    # chunks, one destination chunk of four bf16 pairs
    klo_src, klo_dst = [], []
    for w in range(2):
        cs, n = chunks[w].start, len(chunks[w])
        item = torch.arange(BK * 4 * n)
        r, half = item % BK, 4 * cs + item // BK
        cg, hf = half // 2, half % 2
        src = (cg // 2) * (BK * 32) + r * 32
        a = src[:, None] + ((((cg % 2) * 4 + 2 * hf) ^ (r % 8)) * 4)[:, None] + torch.arange(4)
        c_ = src[:, None] + ((((cg % 2) * 4 + 2 * hf + 1) ^ (r % 8)) * 4)[:, None] + torch.arange(4)
        dst = ((cg // 4) * (BK * 64) + r * 64 + ((((cg % 4) * 2 + hf) ^ (r % 8)) * 8))[:, None]
        klo_src.append(torch.stack([a, c_], -1).reshape(-1))  # word i: (a_i, c_i)
        klo_dst.append((dst + torch.arange(8)).reshape(-1))
    klo_src, klo_dst = torch.cat(klo_src), torch.cat(klo_dst)
    # load_v(gm): (mb, 64, BK) V^T's row (of the M block) and k position of the tile's k8 steps,
    # and the packed bf16 registers (mb, 64, 2 BK) with whether each position holds lo(V)
    v_reg = torch.zeros(mb, 64, BK, dtype=torch.long)
    v_pk = torch.zeros(mb, 64, 2 * BK, dtype=torch.long)
    v_pk_lo = torch.zeros(2 * BK, dtype=torch.bool)
    for kk in range(BK // 8):
        v_pk_lo[16 * kk:16 * kk + 8] = True
    for gm in range(mb):
        bx = 2 * gm + (warp >> 1)
        for kk in range(BK // 8):
            key = 8 * kk + 2 * tt + (e >> 1)
            chunk = 4 * (warp & 1) + (gg >> 2) + 2 * (e & 1)
            idx = bx * (BK * 32) + (gg & 3) + key * 32 + ((chunk ^ (key & 7)) << 2)
            rows = (16 * warp + gg + 8 * (e & 1)).expand(4, 32, 4)
            v_reg[gm, rows, (8 * kk + tt + 4 * (e >> 1)).expand(4, 32, 4)] = idx
            for reg in range(4):
                for hb in range(2):  # low and high bf16 of the register: x0 / x2 (or x1 / x3)
                    e_ = (reg % 2) + 2 * hb
                    key = 8 * kk + 2 * tt + (e_ >> 1)
                    chunk = 4 * (warp & 1) + (gg >> 2) + 2 * (e_ & 1)
                    idx = bx * (BK * 32) + (gg & 3) + key * 32 + ((chunk ^ (key & 7)) << 2)
                    rows = (16 * warp + gg + 8 * (e_ & 1)).expand(4, 32, 1)
                    kpos = (16 * kk + 2 * tt + hb + 8 * (reg // 2)).expand(4, 32, 1)
                    v_pk[gm, rows, kpos] = idx.expand(4, 32, 1)
    # P^T through its K-major descriptors: (64 queries, BK tf32 k positions), (64, 2 BK bf16 ones)
    n64, kp = torch.arange(64)[:, None], torch.arange(BK)[None, :]
    p_desc = swz((kp // 8) * 32 + (n64 // 8) * 8 * BK * 4 + (n64 % 8) * BK * 4 + (kp % 8) * 4) // 4
    k2 = torch.arange(2 * BK)[None, :]
    pb_desc = swz((k2 // 16) * 32 + (n64 // 8) * 8 * BK * 4 + (n64 % 8) * BK * 4 + (k2 % 16) * 2) // 2
    # the softmax's P^T stores: accumulator register i of thread (warp, lane) -> (row, key) and its word
    arow, acol = _wgmma_acc_index(BK)
    ireg = torch.arange(BK // 2)[None, :]
    tcol = (torch.arange(128) % 4)[:, None]
    p_word = swz(arow * BK * 4 + (ireg // 4) * 32 + (tcol + 4 * (ireg & 1)) * 4) // 4
    pb_half = swz(arow * BK * 4 + (ireg // 4) * 32 + (2 * tcol + (ireg & 1)) * 2) // 2  # bf16 P
    pb_lo_half = swz(arow * BK * 4 + (ireg // 4) * 32 + 16 + (2 * tcol + (ireg & 1)) * 2) // 2  # lo(P)
    writer = (torch.arange(128) // 32) >> 1  # the warpgroup that writes a thread's rows
    a_rows = _THREAD_ROWS[0]  # rows g (t = 0 writes the factors)

    orow, ocol = _wgmma_acc_index(64)  # a thread's accumulators of an m64n64 block of O^T: (d, query)
    out_flat = torch.zeros(_flat(tensors[7]).shape, dtype=torch.float64)
    work, coef = ops["work"], ops["coef"]
    for b in range(B):
        runs, blended = _runs(ops, b)
        for h in range(H):
            for q0 in range(0, Sq, 64):
                qt = torch.cat([box(0, c, h, q0, b, 64) for c in range(C)])
                qhi, qlo, qbf = _tf32_read(qt[q_reg]), _tf32_read(_tf32_rest(qt[q_reg])), bf16(qt[q_bf])

                def update(state, ki, vi, r0, length):
                    ot, m, lsum = state
                    ot = ot.clone()
                    kt = torch.cat([box(ki, c, h, r0, b, BK) for c in range(C)])
                    vt = torch.cat([box(vi, c, h, r0, b, BK) for c in range(2 * mb)])
                    kl = torch.zeros(BK * 32 * 2 * ((C + 1) // 2), dtype=torch.float64)
                    kl[klo_dst] = bf16(_tf32_rest(kt[klo_src]))
                    kh = _tf32_read(kt[k_desc])
                    klv = kl[kl_desc]
                    xbuf = []
                    for w in range(2):
                        cols = torch.cat([torch.arange(32 * c, 32 * c + 32) for c in chunks[w]])
                        part = (qhi[:, cols] @ kh[:, cols].T).float() + (
                            qlo[:, cols] @ kh[:, cols].T + qbf[:, cols] @ klv[:, cols].T).float()
                        xbuf.append(part[arow, acol])  # (128 threads, BK / 2 registers)
                    scores = []
                    for w in range(2):
                        sw = torch.zeros(64, BK)
                        sw[arow, acol] = xbuf[w] + xbuf[1 - w]
                        scores.append(sw)
                    assert torch.equal(scores[0], scores[1])
                    s = scores[0]
                    if not (fault == "own_unmasked" and ki == 1):
                        s[:, min(BK, length - r0):] = -math.inf
                    p, m, lsum, alpha = _softmax_tile(s, m, lsum, sl2, static)
                    ph, pb, factors = torch.zeros(64 * BK), torch.zeros(64 * 2 * BK), torch.zeros(64)
                    for w in range(2):  # each warpgroup the rows of its half, from its own registers
                        mine = writer == w
                        preg = p[arow, acol][mine]
                        ph[p_word[mine]] = preg
                        pb[pb_half[mine]] = bf16(preg).float()
                        pb[pb_lo_half[mine]] = bf16(_tf32_rest(preg)).float()
                        factors[a_rows[mine]] = alpha[a_rows[mine]]
                        factors[a_rows[mine] + 8] = alpha[a_rows[mine] + 8]
                    bh, bp = _tf32_read(ph[p_desc]), pb[pb_desc].double()  # (query, k position)
                    for gm in range(mb):
                        vh = _tf32_read(vt[v_reg[gm]])
                        vv = vt[v_pk[gm]]
                        vp = bf16(torch.where(v_pk_lo, _tf32_rest(vv), vv))
                        acc = ((vh @ bh.T) + (vp @ bp.T)).float()
                        ot[gm] = torch.addcmul(acc, ot[gm], factors[None, :])
                    return ot, m, lsum

                def run_tiles(state, run):
                    for ki, vi, length in run:
                        for r0 in range(0, length, BK):
                            state = update(state, ki, vi, r0, length)
                    return state

                slot = work[(b * H + h) * -(-Sq // 64) + q0 // 64] if work is not None else None

                def put(ot, m, lsum):  # word 32 mi + i of warpgroup w's thread ct: its M block ms + mi
                    for w in range(2):
                        for mi, gm in enumerate(mblocks[w]):
                            slot[32 * mi:32 * mi + 32, 128 * w:128 * w + 128] = ot[gm][orow, ocol].T
                        for jr, r in enumerate(_THREAD_ROWS):
                            if static is None:  # the static shift parks no max
                                slot[32 * mbw + jr, 128 * w:128 * w + 128] = m[r]
                            slot[32 * mbw + 2 + jr, 128 * w:128 * w + 128] = lsum[r]

                def get():
                    ot, m, lsum = torch.zeros(mb, 64, 64), torch.empty(64), torch.empty(64)
                    for w in range(2):
                        for mi, gm in enumerate(mblocks[w]):
                            ot[gm][orow, ocol] = slot[32 * mi:32 * mi + 32, 128 * w:128 * w + 128].T
                        for jr, r in enumerate(_THREAD_ROWS):
                            m[r], lsum[r] = slot[32 * mbw + jr, 128 * w:128 * w + 128], \
                                slot[32 * mbw + 2 + jr, 128 * w:128 * w + 128]
                    return ot, m, lsum

                def zero():
                    return torch.zeros(mb, 64, 64), torch.full((64,), -math.inf), torch.zeros(64)

                ot = _sets(runs, blended, float(coef[b]) if blended else 1.0, zero(), run_tiles, put, get, zero,
                           lambda x, f: x * f, fault,
                           (lambda lw: lw) if static is None else (lambda lw: lw.clamp_min(1e-37)))
                o = ot.reshape(64 * mb, 64).T  # (query, d): d = 64 gm + row
                sb, sh, ss = strides[7]
                rows = q0 + torch.arange(64)
                d = torch.arange(64 * mb)
                keep = (rows < Sq)[:, None] & (d < D)[None, :]
                dst = b * sb + h * sh + rows[:, None] * ss + d[None, :]
                out_flat[dst[keep]] = o[keep].double()
    out = tensors[7]
    return torch.as_strided(out_flat, out.shape, out.stride()).float()


def _operands(dt: str, mode: str, D: int, endpoints: str, Le, B: int = 3, H: int = 2, S: int = 64, L: int = 37,
              seed: int = 0, static_smax=None, scale=None) -> tuple:
    """(ops, plain result) of a D=161-512 call from ``kernel_operands`` on
    (B, S, H*D) projections viewed as (B, H, S, D): coefficients 0 .. 1,
    the first row a skip row; ``endpoints`` "rows" (rows 0 and B-1 of K/V),
    "shared" (H, Le, D) or "per_row" (B, H, Le, D). ``static_smax`` lays out
    the static-shift instance, the plain result at its shift."""
    dtype = DTYPES[dt]
    g = torch.Generator().manual_seed(seed + D + (Le or 0) + len(mode))

    def heads(n):
        return torch.randn(B, n, H * D, generator=g).to(dtype).view(B, n, H, D).transpose(1, 2)

    q, k, v = heads(S), heads(L), heads(L)
    coef = torch.linspace(0.0, 1.0, B)
    skip = torch.zeros(B, dtype=torch.bool)
    skip[0] = True
    eps = {}
    if endpoints != "rows":
        shape = (H, Le, D) if endpoints == "shared" else (B, H, Le, D)
        eps = {n: torch.randn(shape, generator=g).to(dtype) for n in ("k_begin", "v_begin", "k_end", "v_end")}
    ops = kernel_operands(q, k, v, coef, mode, scale=scale, skip_endpoints=skip, static_smax=static_smax, **eps)
    entries = FA.DMID_ENTRIES if static_smax is None else FA.STATIC_DMID_ENTRIES
    assert ops["entry"] == entries[dtype] and ops["dims"][5] == D
    assert (ops["work"] is not None) == AttnMode(mode).is_outer
    assert ops["n_sets"] == {"self": 0, "fused_inner": 1, "pure_inner": 1}.get(mode, 2)
    # at the static shift, the inner modes' K_cross as the wrapper rounds it: logits in the hundreds (a hot
    # scale) move by tenths of a nat with its rounding
    ops_eps = {}
    if static_smax is not None and AttnMode(mode).is_inner:
        kc, vc = ops["tensors"][3], ops["tensors"][4]
        ops_eps = {"k_begin": kc, "v_begin": vc, "k_end": kc, "v_end": vc}
    want = flash_interpolated_attention_plain(q.float(), k.float(), v.float(), coef, mode, scale=scale,
                                              skip_endpoints=skip, static_smax=static_smax,
                                              **{n: e.float() for n, e in {**eps, **ops_eps}.items()})
    return ops, want


def _replay_err(dt: str, mode: str, D: int, endpoints: str, Le, fault: str | None = None, **kw) -> float:
    """max |replay - plain| / max |plain| of the D=161-512 entry's replay."""
    ops, want = _operands(dt, mode, D, endpoints, Le, **kw)
    got = (_emulate_dmid_f32 if dt == "f32" else _emulate_dmid16)(ops, fault)
    assert got.shape == want.shape and got.dtype == DTYPES[dt]
    return th.max_rel_err(got.float().numpy(), want.numpy())


def _static_replay_errs(dt: str, mode: str, D: int, endpoints: str, Le, hot: bool) -> tuple:
    """(against the plain static shift, against the exact softmax) of the
    static-shift instance's replay at C = 40: in the window, or at a scale
    that puts the row maxes far past +70 (hot)."""
    scale = 100.0 / D ** 0.5 if hot else None
    ops, want = _operands(dt, mode, D, endpoints, Le, static_smax=40.0, scale=scale)
    assert ops["static"] == pytest.approx((40.0 * math.log2(math.e), 30.0 * math.log2(math.e)), rel=1e-12)
    got = (_emulate_dmid_f32 if dt == "f32" else _emulate_dmid16)(ops).float().numpy()
    exact = _operands(dt, mode, D, endpoints, Le, scale=scale)[1]
    return th.max_rel_err(got, want.numpy()), th.max_rel_err(got, exact.numpy())


# the static-shift instances (bf16 and f32) at the replay's head dims; every mode in the window, and far past
# its top at the rows layout's and split layout's widths (bf16) and the 32- and 16-key tiles (f32)
STATIC_REPLAY_DIMS = (200, 320, 448, 512)
STATIC_HOT = [("bf16", 320, "fused_outer"), ("bf16", 448, "pure_outer"), ("bf16", 504, "self"),
              ("f32", 320, "fused_outer"), ("f32", 448, "pure_inner"), ("f32", 512, "fused_inner")]


@pytest.mark.parametrize("dt,D,mode", [(dt, D, mode) for dt in ("bf16", "f32") for D in STATIC_REPLAY_DIMS
                                        for mode in REPLAY_MODES if not takes_d512_self(D, mode, DTYPES[dt])])
def test_dmid_static_instances_replayed(dt, D, mode):
    """aid_flash_attn_{bf16,f32}_dmid_static (csrc/flash_attention_dmid_static.cu,
    csrc/flash_attention_dmid_f32_static.cu: the same data movement, P at the
    static shift with no running max or rescale, the outer modes' park
    keeping O and l alone) replayed from the wrapper's own C arguments, the
    shift and the clip among them, against the plain version's static shift
    (C = 40), every mode and self mode (self mode where the D=512 self
    kernels do not take it: test_torch_ops.py replays those): to 1e-2 (bf16)
    and 1e-5 (f32) of max |ref|, as the exact instances' replays, and in the
    window as close to the exact softmax."""
    ep, Le = (REPLAY_ENDPOINTS if D % 128 else REPLAY_ENDPOINTS_ALT).get(mode, ("rows", None))
    err, exact_err = _static_replay_errs(dt, mode, D, ep, Le, hot=False)
    assert err < TOL[dt] and exact_err < TOL[dt]


@pytest.mark.parametrize("dt,D,mode", STATIC_HOT)
def test_dmid_static_instances_at_the_clip(dt, D, mode):
    """Far past the window's top (row maxes in the hundreds) the static
    instances' replay gives the plain static shift's clipped result, tens
    of percent off the exact softmax: the clip is applied where the JAX
    kernel applies it. f32 to 1e-4 there: the three-pass split's ~2^-20
    relative error of logits in the hundreds moves the weights of keys at
    the clip's edge (test_flash_static_branch_replayed)."""
    ep, Le = (REPLAY_ENDPOINTS if D % 128 else REPLAY_ENDPOINTS_ALT).get(mode, ("rows", None))
    err, exact_err = _static_replay_errs(dt, mode, D, ep, Le, hot=True)
    assert err < (1e-2 if dt == "bf16" else 1e-4) and exact_err > 0.1


TOL = {"bf16": 1e-2, "f16": 1e-2, "f32": 1e-5}
# head dims: bf16 / f16 3, 4 (200: ragged, its last chunk zero-filled) and 5
# chunks in the rows layout, 6 and 7 (run as 8) in the split one, and 8; f32
# 6..16 chunks, 32-key tiles up to 10, 2 to 4 M blocks a warpgroup. The
# endpoint forms rotate over the modes; Le of 4 (an IP segment), 16, 77 (the
# text tokens) and 33, each ragged against the 16-, 32-, 48- and 64-key tiles
REPLAY_DIMS = (192, 200, 320, 384, 448, 512)
REPLAY_ENDPOINTS = {"fused_outer": ("shared", 77), "pure_outer": ("per_row", 16), "fused_inner": ("rows", None),
                    "pure_inner": ("shared", 4), "self": ("rows", None)}
REPLAY_ENDPOINTS_ALT = {"fused_outer": ("rows", None), "pure_outer": ("shared", 33), "fused_inner": ("per_row", 4),
                        "pure_inner": ("per_row", 77)}


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("D", REPLAY_DIMS)
@pytest.mark.parametrize("mode", ENDPOINT_MODES)
def test_dmid_kernels_data_movement_replayed(dt, D, mode):
    """aid_flash_attn_{bf16,f16,f32}_dmid replayed from the wrapper's own C
    arguments at the caller's head dim (no padded copy): its boxes, swizzle,
    descriptors and register fragments, the exchange where D is split, the
    segments of the key stream (own, begin, end), each its own map and
    length with its last tile masked, a shared endpoint through a batch
    extent of 1, the lerped inner endpoint in the begin slot, a skip row
    streaming its own segment alone, and the outer modes' own state parked
    in the workspace and swapped word for word. Against the plain version
    in f32: bf16 and f16 to 1e-2 of max |ref|, f32 to 1e-5."""
    ep, Le = (REPLAY_ENDPOINTS if D % 128 else REPLAY_ENDPOINTS_ALT)[mode]
    assert _replay_err(dt, mode, D, ep, Le) < TOL[dt]


@pytest.mark.parametrize("dt", ["bf16", "f16"])
@pytest.mark.parametrize("D", [192, 320])
@pytest.mark.parametrize("mode", REPLAY_MODES)
def test_dmid_rows_layout_two_warpgroups_replayed(dt, D, mode, monkeypatch):
    """The rows layout with two consumer warpgroups a block (128 query rows
    over each K/V tile), which the kernel takes where the grid of 64-row
    blocks is over one wave: the threshold lowered to 2 blocks so a small
    grid takes it (the kernel and kernel_operands read it through
    dmid_tiles), 130 queries, so the last block's second warpgroup lies
    wholly past Sq; each warpgroup parks in its own row tile of the
    workspace (self mode parks nothing)."""
    monkeypatch.setattr(FA, "DMID_ONE_WAVE", 2)
    assert dmid_tiles(D, DTYPES[dt], 3, 2, 130)["nwg"] == 2
    ep, Le = REPLAY_ENDPOINTS[mode]
    assert _replay_err(dt, mode, D, ep, Le, S=130) < TOL[dt]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("fault,D", [("chunks", 320), ("chunks", 448), ("own_not_restored", 320),
                                     ("shared_batch", 200)])
def test_dmid_replay_catches_planted_faults(fault, D, dt):
    """The replays can fail: with a chunk too few (the instance of one
    chunk less: the last 64 or 32 columns of Q K^T and of O missing), the
    own state not restored for the end set (the end set continues the begin
    set) or a shared endpoint read at the row's batch index (zeros past its
    batch extent of 1), the fused_outer replay misses its bound by orders
    of magnitude."""
    assert _replay_err(dt, "fused_outer", D, "shared", 77, fault=fault) > 0.1


# self mode's head dims on the D=161-512 entries: 3, 4 (200 ragged) and 5
# chunks in the rows layout, 6 and 7 (run as 8) and 8 (504, the last multiple
# of 8 under the D=512 self kernels' 512) in the split one; f32 6..16 chunks
# (the wrapper sends f32 self mode past 448 to the D=512 self kernels, but
# the entry takes it: its 15- and 16-chunk instances are replayed too)
SELF_DIMS = (192, 200, 320, 384, 448, 504)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("D", SELF_DIMS)
@pytest.mark.parametrize("S,L", [(64, 37), (70, 77)])
def test_dmid_self_instance_replayed(dt, D, S, L, monkeypatch):
    """Self mode at 161-511: kernel_operands lays the call out for the
    D=161-512 entry at the caller's D with has_own 1 and n_sets 0 (no
    coefficient, skip row, workspace or endpoint tensor made; its endpoint
    slots repeat k and v), and the entry's replay, which streams the own
    segment alone with its last tile masked (37 and 77 keys ragged against
    the 16-, 32-, 48- and 64-key tiles; 70 queries against the 64-row tile),
    matches the plain version: bf16 and f16 to 1e-2 of max |ref|, f32 to
    1e-5. f32 past 448, which the wrapper sends to the D=512 self kernels,
    is laid out with the boundary lifted."""
    assert takes_d512_self(D, "self", DTYPES[dt]) == (dt == "f32" and D > 448)
    monkeypatch.setitem(FA.DMID_SELF_MAX, DTYPES[dt], 511)
    ops, want = _operands(dt, "self", D, "rows", None, S=S, L=L)
    assert ops["has_own"] == 1 and ops["n_sets"] == 0 and ops["coef"] is None and ops["skip"] is None
    assert all(x is y for x, y in zip(ops["tensors"][3:7], ops["tensors"][1:3] * 2))
    got = (_emulate_dmid_f32 if dt == "f32" else _emulate_dmid16)(ops)
    assert th.max_rel_err(got.float().numpy(), want.numpy()) < TOL[dt]


@pytest.mark.parametrize("dt", list(DTYPES))
def test_dmid_self_replay_catches_planted_fault(dt):
    """The self replay can fail: with the own segment's last ragged tile
    unmasked (37 keys: the 27 past them in a 64-key tile, 11 in a 48-key
    one, 27 in the f32 32-key tile's second, read as the maps' zeros, take
    part in the softmax) it misses its bound more than tenfold (0.14-0.30 of
    max |ref| against 1e-2 and 1e-5)."""
    assert _replay_err(dt, "self", 200, "rows", None, fault="own_unmasked") > 0.1
    assert _replay_err(dt, "self", 320, "rows", None, fault="own_unmasked") > 0.1


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("D", [200, 320])
def test_dmid_self_matches_jax_interpret(dt, D):
    """Self mode at D = 200 and 320 through the JAX wrapper's Pallas kernel
    in interpret mode (which pads them to 256 and 384) on the same inputs,
    rounded to the dtype: the port's plain version agrees to 1e-5 of max
    |ref| (f32 on both sides; the online softmax's rounding, ~1e-6), and the
    self entry's replay from the wrapper's C arguments to 1e-2 in bf16 and
    f16 (P's rounding and the output's) and to 1e-5 in f32 (the three-pass
    split)."""
    B, H, S, L = 2, 2, 70, 77
    rng = np.random.default_rng(D)
    dtype = DTYPES[dt]
    q, k, v = (torch.from_numpy(rng.standard_normal((B, n, H, D), dtype=np.float32)).to(dtype).transpose(1, 2)
               for n in (S, L, L))
    want = np.asarray(jax_flash(*(jnp.asarray(x.float().numpy()) for x in (q, k, v)), jnp.zeros((B,), jnp.float32),
                                "self", block_q=64, block_k=64, interpret=True))
    plain = flash_interpolated_attention_plain(q.float(), k.float(), v.float())
    assert th.max_rel_err(plain.numpy(), want) < 1e-5
    ops = kernel_operands(q, k, v)
    assert ops["entry"] == FA.DMID_ENTRIES[dtype] and ops["dims"][5] == D and ops["n_sets"] == 0
    got = (_emulate_dmid_f32 if dt == "f32" else _emulate_dmid16)(ops)
    assert th.max_rel_err(got.float().numpy(), want) < TOL[dt]


def test_dmid_tile_constants_follow_the_kernel_sources():
    """ops/flash_attention.py's mirror of the kernels' tiling (dmid_tiles,
    which the replays and the workspace use) holds the constants the two
    sources compile with: the rows layout's keys a tile by chunk count and
    its one-wave threshold, the split layout's 32-key tiles, the f32
    kernel's 32-key tiles up to 10 chunks; the workspace is 32 NC + 4 words
    a thread in bf16 and f16 (the source's kParkWords), 32 MBW + 4 in f32."""
    src = (CSRC / "flash_attention_dmid.cu").read_text()
    assert "static constexpr int kBK = NC == 5 ? 48 : 64;" in src
    assert {nc: (48 if nc == 5 else 64) for nc in (3, 4, 5)} == FA.DMID_ROWS_BK
    assert re.search(r"struct Split \{\s+static constexpr int kBK = (\d+);", src).group(1) == str(FA.DMID_SPLIT_BK)
    assert re.search(r"constexpr int kOneWave = (\d+);", src).group(1) == str(FA.DMID_ONE_WAVE)
    assert "static constexpr int kParkWords = 32 * NC + 4;" in src and "kParkWords = kCols / 2 + 4;" in src
    f32 = (CSRC / "flash_attention_dmid_f32.cu").read_text()
    assert re.search(r"constexpr int kWideTileChunks = (\d+);", f32).group(1) == str(FA.DMID_F32_WIDE_TILE_CHUNKS)
    assert "constexpr int kParkWords = 32 * MBW + 4;" in f32
    assert "p.cq0 = p.C / 2;" in f32 and "const int ms = wg == 0 ? 0 : mb - MBW;" in f32
    for D in range(168, 513, 8):
        t = dmid_tiles(D, torch.float32)
        assert t["cq0"] == t["chunks"] // 2 and t["mbw"] == -(-t["mb"] // 2) and t["park_words"] == 32 * t["mbw"] + 4


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("mode", REPLAY_MODES)
def test_dmid_operands_pass_the_callers_tensors(dt, mode):
    """kernel_operands at D = 320 hands the D=161-512 entry the caller's q,
    k, v and endpoint tensors as they are (the same storage, no padded
    copy; the inner modes' lerped endpoint is the one tensor made; self mode
    repeats k and v in the endpoint slots), dims[5] the caller's 320 (the
    kernels' rounding of it: five 64-column chunks, ten 32-column ones), and
    a workspace only where the outer modes park a set, sized by dmid_tiles
    at the caller's chunk count."""
    dtype = DTYPES[dt]
    B, H, S, L, D = 3, 2, 64, 37, 320
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(B, n, H * D, generator=g).to(dtype).view(B, n, H, D).transpose(1, 2) for n in (S, L, L))
    eps = {n: torch.randn(H, 77, D, generator=g).to(dtype) for n in ("k_begin", "v_begin", "k_end", "v_end")}
    ops = kernel_operands(q, k, v, torch.linspace(0, 1, B), mode, **eps)
    assert ops["entry"] == FA.DMID_ENTRIES[dtype] and ops["dims"][5] == D == ops["head_dim"]
    assert [x.data_ptr() for x in ops["tensors"][:3]] == [q.data_ptr(), k.data_ptr(), v.data_ptr()]
    if AttnMode(mode).is_outer:
        assert [x.data_ptr() for x in ops["tensors"][3:7]] == [e.data_ptr() for e in eps.values()]
        t = dmid_tiles(D, dtype, B, H, S)
        assert ops["work"].shape == (t["work_tiles"], t["park_words"], t["park_threads"])
        assert t["park_words"] == (100 if dt == "f32" else 164)
    elif mode == "self":
        assert ops["work"] is None and ops["n_sets"] == 0 and ops["dims"][4] == L
        assert [x.data_ptr() for x in ops["tensors"][3:7]] == [k.data_ptr(), v.data_ptr()] * 2
    else:
        assert ops["work"] is None and ops["tensors"][3].shape == (B, H, 77, D)
    assert ops["out"].data_ptr() == ops["tensors"][7].data_ptr() and ops["out"].shape == (B, H, S, D)
