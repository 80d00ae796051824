"""Flash interpolated attention: the hand-written Hopper kernels and their plain version.

``flash_interpolated_attention`` computes the contract of
``aid_tpu.ops.flash_attention.flash_interpolated_attention``
(aid_tpu/ops/flash_attention.py:683-1061) at every head dim that contract
takes, up to 2048. On a CUDA tensor it launches one of the kernels below,
which together replace both Pallas TPU kernels behind that function
(``_kernel``, flash_attention.py:101, and ``_kernel_onepass``,
flash_attention.py:339); each source's header says what bounds it on the card
and how the design answers. On a CPU tensor it runs
:func:`flash_interpolated_attention_plain`.

The kernels by head dim, each in bf16, f16 and f32:
  * D = 40, 64, 80 or 160, every mode (every published UNet's attention: 64
    for SDXL and SD2.x, 40/80/160 for SD1.x's 8 heads at widths
    320/640/1280): ``csrc/flash_interpolated_attention.cu`` (bf16 and its
    f16 instance, ``aid_flash_attn_bf16`` / ``aid_flash_attn_f16``) and
    ``csrc/flash_interpolated_attention_f32.cu`` (3xTF32 on wgmma; at D =
    160 two consumer warpgroups split D), counted by the wrapper of the
    dtype (:func:`flash_interpolated_attention`,
    :func:`flash_interpolated_attention_f16`,
    :func:`flash_interpolated_attention_f32`) in ``launches`` and, per
    instance head dim, ``launches_by_head_dim``; in bf16 and f16 a short key
    stream (the 77-key text cross-attention, the IP tokens, short self
    calls: :func:`takes_onepass`) takes
    ``csrc/flash_attention_onepass.cu`` instead (``aid_flash_attn_bf16_onepass``
    / ``aid_flash_attn_f16_onepass``, `_kernel_onepass`'s design: the whole
    stream of a (b, h) resident, query tiles looped over it, each segment's
    softmax in one pass), counted also in the wrapper's
    ``launches_onepass`` by head dim; and a stream past what that kernel
    holds, up to the JAX wrapper's onepass_max of 3072 keys, at D = 64 or 80
    (SDXL's and SD 2.x's 1024- and 576-token calls, SD 1.5's 1024-token
    level: :func:`takes_midstream`) takes ``csrc/flash_attention_midstream.cu``
    (``aid_flash_attn_bf16_midstream`` / ``aid_flash_attn_f16_midstream``:
    a persistent grid walking one list of 192-row work items, heaviest
    first, the streaming tile step per warpgroup), counted also in ``launches_midstream`` by head dim;
  * D = 512, self mode (the VAE mid-block attention, one head over 4096
    tokens at 512px, 16384 at 1024px; past the dtype's
    :data:`DMID_SELF_MAX` also the head dims below 512, padded to 512):
    ``csrc/flash_attention_f32_d512.cu``
    (wgmma, both products in three passes, D split across two consumer
    warpgroups) and ``csrc/flash_attention_bf16_d512.cu`` (bf16 and f16),
    reached through :func:`flash_self_attention_f32`,
    :func:`flash_self_attention_bf16` and :func:`flash_self_attention_f16`
    and counted by their ``launches``;
  * D = 161-512 in the four endpoint modes and D = 161 up to the dtype's
    :data:`DMID_SELF_MAX` in self mode (a UNet whose heads are 161-512
    wide; self mode is the kernels' instance with no endpoint set,
    ``n_sets`` 0, streaming the own K/V alone):
    ``aid_flash_attn_{bf16,f16}_dmid`` in
    ``csrc/flash_attention_dmid.cu`` and ``aid_flash_attn_f32_dmid`` in
    ``csrc/flash_attention_dmid_f32.cu``, at the caller's head dim (the
    kernels round it up to their column chunk, 64 or 32, by the tensor maps'
    zero fill): in bf16 and f16 each consumer warpgroup owns 64 query rows
    over all of D up to D = 320 (two warpgroups a block past one wave of
    blocks), two warpgroups split D past it; in f32 two warpgroups split the
    work of a tile evenly (3xTF32, 32-key tiles up to D = 320). The outer
    modes' first softmax set is parked in a global f32 workspace the wrapper
    allocates per call (:func:`dmid_tiles`); counted under
    ``launches_by_head_dim[512]``;
  * D = 513-2048, every mode (an SD 1.x UNet with one head a level: 640 and
    1280): ``aid_flash_attn_{bf16,f16,f32}_dwide`` in
    ``csrc/flash_attention_dwide.cu`` (bf16 and f16: wgmma on the transposed
    products S^T = K Q^T and O^T = V^T P^T with 64 keys in M, K and V
    streamed by TMA in 64-column chunks, D split across two consumer
    warpgroups that exchange partial scores, the key stream split across
    blocks where the grid is under one wave and merged by a combine step;
    in f32 3xTF32 with K's and V^T's fragments from registers), counted
    under ``launches_by_head_dim[DWIDE]``.
A head dim that no instance takes is zero-padded to the next that does,
as the JAX package pads (aid_tpu/ops/flash_attention.py:784, 800-801):
below 160 to the next of 40, 64, 80, 160, from 161 to 512 to a multiple of 8
(in self mode past :data:`DMID_SELF_MAX` to 512, the D=512 self kernels),
past 512 to a multiple of 8 in every mode (16-byte rows; the D=161-512 and
wide kernels take the rest of their padding from zero-filling copies); the
scale stays the
unpadded D's and the output is sliced back. Zero columns add nothing to
Q K^T, and V's are cut off, so the padding is exact; it costs one copy of
each operand, and the launch counts book such calls under the instance's
head dim. Any other dtype (float64) or a head dim over 2048 raises
``NotImplementedError`` on a CUDA tensor, as the JAX wrapper raises past its
block budget. :func:`kernel_operands` checks the operands of the
interpolating kernels (every instance but the D=512 self kernels; bf16, f16
or f32, one C signature, the entries past 160 with one workspace pointer
more), pads them and lays out their C entry's arguments (the CPU tests
replay the kernels' data movement from them), :func:`d512_operands` those
of the D=512 self kernels; :func:`kernel_launch` and :func:`d512_launch`
return the launch itself, which ``chip_smoke.py`` times apart from the
wrapper's host work.

The static-shift softmax (``static_smax``, aid_tpu/ops/flash_attention.py:
44-65): with a shift C, p = exp(min(s * scale - C, STATIC_SHIFT_CLIP)) with
no running row max, the same softmax while every row max lies in [C - 72,
C + 30]. Its instances, the exact sources built with ``AID_STATIC_SHIFT`` in
translation units of their own: the bf16 and f32 kernels at D <= 160 in
every mode (``csrc/flash_interpolated_attention_static.cu``,
``csrc/flash_interpolated_attention_f32_static.cu``), the bf16
mid-length stream kernel at D = 64 in the endpoint modes
(``csrc/flash_attention_midstream_static.cu``), counted in
``launches_static`` / ``launches_static_midstream``; the bf16 and f32
D=161-512 kernels in every mode and self mode
(``csrc/flash_attention_dmid_static.cu``,
``csrc/flash_attention_dmid_f32_static.cu``), counted in
``launches_static_dmid`` by head dim; the D=512 self kernels in f32 and
bf16 (``csrc/flash_attention_f32_d512_static.cu``,
``csrc/flash_attention_bf16_d512_static.cu``: the VAE mid block), counted
in the D=512 wrappers' ``launches_static``; and the bf16 and f32 wide
kernels at D = 513-2048 in every mode, their key split's combine step
static too (``csrc/flash_attention_dwide_static.cu``), counted in
``launches_static_dwide`` by the instance's head dim (640, 1024, 1280 or
2048). In f16 there is none.
:func:`resolve_static_smax` turns the model path's ``"auto"`` into the
shift or None as the JAX wrapper does, less the calls the port keeps exact
(f16; f32 past a padded head dim of 1024, where the JAX wrapper raises).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from aid_tpu_torch.ops.attention import AttnMode, _softmax_attn, interpolated_attention
from aid_tpu_torch.ops.routing import use_kernel

KERNEL_HEAD_DIMS = (40, 64, 80, 160)
D512 = 512  # the VAE mid block's head dim: the self-mode kernels in f32, bf16 and f16
#: the bf16 and f16 kernel's tiles by head dim: (query rows per block, keys
#: per K/V tile, K/V stages in its ring), csrc/flash_interpolated_attention.cu's
#: Tiles<D> (one design, two element types): one consumer warpgroup per 64
#: query rows.
KERNEL_TILES = {40: (192, 128, 3), 64: (192, 128, 3), 80: (128, 128, 2), 160: (64, 64, 3)}
#: the f32 kernel's instances by head dim: (query rows per block, keys per
#: K/V tile, stages in its ring), csrc/flash_interpolated_attention_f32.cu's
#: Tiles<D>: one consumer warpgroup per 64 query rows and
#: KERNEL_F32_D_SPLIT[D] of them, each over D / KERNEL_F32_D_SPLIT[D]
#: columns (its Cfg<D>::kSplit).
KERNEL_F32_TILES = {40: (192, 32, 4), 64: (128, 64, 2), 80: (128, 32, 3), 160: (64, 16, 3)}
KERNEL_F32_D_SPLIT = {40: 1, 64: 1, 80: 1, 160: 2}
#: the C entry of the D <= 160 kernels by operand dtype (one C signature)
KERNEL_ENTRIES = {torch.bfloat16: "aid_flash_attn_bf16", torch.float16: "aid_flash_attn_f16",
                  torch.float32: "aid_flash_attn_f32"}
#: the C entry of the D=512 self-attention kernels by operand dtype
D512_ENTRIES = {torch.bfloat16: "aid_flash_attn_bf16_d512", torch.float16: "aid_flash_attn_f16_d512",
                torch.float32: "aid_flash_attn_f32_d512"}
#: the C entry of the D=161-512 kernels (the endpoint modes, and self mode up
#: to DMID_SELF_MAX of the dtype) by operand dtype (the D <= 160 kernels' C
#: signature and a workspace pointer)
DMID_ENTRIES = {torch.bfloat16: "aid_flash_attn_bf16_dmid", torch.float16: "aid_flash_attn_f16_dmid",
                torch.float32: "aid_flash_attn_f32_dmid"}
#: the bf16 and f16 D=161-512 kernel (csrc/flash_attention_dmid.cu): keys a
#: tile of the rows layout by 64-column chunks (Rows<NC>::kBK; 3..5 chunks),
#: of the split layout (Split<NCW>::kBK), and the blocks of 64 rows past
#: which the rows layout puts two warpgroups' rows in a block (kOneWave)
DMID_ROWS_BK, DMID_SPLIT_BK, DMID_ONE_WAVE = {3: 64, 4: 64, 5: 48}, 32, 132
#: the f32 one (csrc/flash_attention_dmid_f32.cu): 32-key tiles up to this
#: many 32-column chunks (kWideTileChunks), 16-key tiles past it
DMID_F32_WIDE_TILE_CHUNKS = 10
#: self mode's last head dim on the D=161-512 kernels' self instance (at the
#: caller's D, a multiple of 8), by dtype; past it, up to 512, the D=512 self
#: kernels take self mode (the VAE's exact 512, and below it on copies padded
#: to 512). Measured in turns on an H100 (700 W; tools/attention_bench.py
#: --dmid, PERF.md section 6): through the wrapper the bf16 and f16 self
#: instance beats the padded route at every D measured up to 504 (at 504,
#: (7,1,4096): 0.790-0.796 ms against 0.826-0.838, though launched alone it
#: loses, 0.784-0.786 against 0.669-0.673); the f32 one ties it at 448
#: ((7,1,4096): 4.28-4.30 against 4.23-4.33; (7,2,1024): 0.561-0.568 against
#: 0.632-0.647) and loses at 504 (4.59-4.61 against 4.25-4.27): its 16-key
#: tiles at 15-16 chunks of 32 columns are slower than the D=512 design's
DMID_SELF_MAX = {torch.bfloat16: 511, torch.float16: 511, torch.float32: 448}


def dmid_tiles(D: int, dtype=torch.bfloat16, B: int = 1, H: int = 1, Sq: int = 1) -> dict:
    """The D=161-512 endpoint kernel's tiling at an operand head dim D in
    ``dtype`` for a (B, H, Sq) grid, as the sources' host code picks it.
    ``layout``: "rows" (bf16 and f16 up to 5 chunks of 64 columns: each
    consumer warpgroup owns 64 query rows over all of D; ``nwg`` of them a
    block, 2 where B * H * ceil(Sq / 64) is over :data:`DMID_ONE_WAVE`),
    "split" (6..8 chunks, 7 run as 8: two warpgroups split D, ``ncw`` chunks
    each) or "f32" (32-column chunks; two warpgroups split a tile's work:
    each takes ``mbw`` of the ``mb`` 64-row M blocks of O^T, warpgroup 1 the
    last ``mbw``, and warpgroup 0 the first ``cq0`` chunks of Q K^T, 1 the
    rest). ``chunks``, ``BQ`` (query rows a block),
    ``BK`` (keys a tile), and the outer modes' workspace: ``park_words``
    words for each of ``park_threads`` consumer threads of every 64-row
    query tile (``work_tiles`` of them, in block order)."""
    if dtype == torch.float32:
        C = -(-D // 32)
        mb = -(-C // 2)
        mbw = -(-mb // 2)
        return dict(layout="f32", chunks=C, BQ=64, BK=32 if C <= DMID_F32_WIDE_TILE_CHUNKS else 16, nwg=2, mb=mb,
                    mbw=mbw, cq0=C // 2, park_words=32 * mbw + 4, park_threads=256, work_tiles=B * H * -(-Sq // 64))
    nc = -(-D // 64)
    if nc <= 5:
        nwg = 2 if B * H * -(-Sq // 64) > DMID_ONE_WAVE else 1
        return dict(layout="rows", chunks=nc, BQ=64 * nwg, BK=DMID_ROWS_BK[nc], nwg=nwg, park_words=32 * nc + 4,
                    park_threads=128, work_tiles=B * H * -(-Sq // (64 * nwg)) * nwg)
    ncw = 3 if nc == 6 else 4
    return dict(layout="split", chunks=2 * ncw, BQ=64, BK=DMID_SPLIT_BK, nwg=2, ncw=ncw, park_words=32 * ncw + 4,
                park_threads=256, work_tiles=B * H * -(-Sq // 64))


#: the C entry of the short-stream kernel by operand dtype
#: (csrc/flash_attention_onepass.cu; the D <= 160 kernels' C signature)
ONEPASS_ENTRIES = {torch.bfloat16: "aid_flash_attn_bf16_onepass", torch.float16: "aid_flash_attn_f16_onepass"}
#: its instances' resident stream in 16-key tiles (a stream takes the first
#: at or above its own count), the shared memory a block can use, and the Q/O
#: buffers of each warpgroup at head dims up to 64 and above (the source's
#: kStreamTiles, kSmemLimit, kRingNarrow and kRingWide)
ONEPASS_STREAM_TILES, ONEPASS_SMEM_LIMIT, ONEPASS_RING = (1, 3, 5, 10, 15), 232448, {"narrow": 3, "wide": 2}


@functools.lru_cache(maxsize=1024)
def onepass_tiles(D: int, Lk: int, Le: int, mode: AttnMode | str = AttnMode.SELF) -> Optional[dict]:
    """The short-stream kernel's instance for a call at an instance head dim
    D (40, 64, 80 or 160) over Lk own keys and Le keys an endpoint segment in
    ``mode``, as the source's host code picks it: the segments' 16-key tiles
    (``nt_own``, ``nt_ep``; the stream is the own segment then ``n_sets``
    endpoint segments, each padded to whole tiles), the instance's tiles
    ``kt`` (the first of :data:`ONEPASS_STREAM_TILES` at or above the
    stream's), ``chunks`` (64-column boxes of a row) and ``smem`` (a block's
    bytes at one, two and three consumer warpgroups: the resident K and V,
    each warpgroup's ring of 64-row Q/O buffers (:data:`ONEPASS_RING`: three
    up to D = 64, two above), the barriers, the 1024-byte alignment slack).
    None where the stream is longer than the largest instance or one
    warpgroup's block is over :data:`ONEPASS_SMEM_LIMIT`. Cached: the wrapper
    asks on every call, and a model calls it at a few shapes; the dict
    returned is shared, not to be changed."""
    mode = AttnMode(mode)
    has_own = mode in (AttnMode.SELF, AttnMode.FUSED_OUTER, AttnMode.FUSED_INNER)
    n_sets = 2 if mode.is_outer else (1 if mode.is_inner else 0)
    nt_own, nt_ep = -(-Lk // 16) if has_own else 0, -(-Le // 16) if n_sets else 0
    kt = next((c for c in ONEPASS_STREAM_TILES if nt_own + n_sets * nt_ep <= c), None)
    if kt is None or D not in KERNEL_HEAD_DIMS:
        return None
    chunks, ring = -(-D // 64), ONEPASS_RING["narrow" if D <= 64 else "wide"]
    smem = {w: 1024 + 2 * chunks * 16 * kt * 128 + w * ring * chunks * 64 * 128 + 8 * (1 + ring * w)
            for w in (1, 2, 3)}
    if smem[1] > ONEPASS_SMEM_LIMIT:
        return None
    return dict(nt_own=nt_own, nt_ep=nt_ep, n_sets=n_sets, kt=kt, chunks=chunks, smem=smem)


#: the route's measured limit (in turns on an H100, 700 W;
#: tools/attention_bench.py --onepass, PERF.md section 6): a call that fits
#: the short-stream kernel stays on the streaming one unless its (b, h) has
#: more than ONEPASS_MIN_QUERIES query rows. One 64-row query tile gives the
#: resident stream nothing to amortise: SD 1.5's mid-block self call,
#: (7,8,64,160), ran at 0.0052 ms of device time against 0.0037
ONEPASS_MIN_QUERIES = 64


@functools.lru_cache(maxsize=4096)
def takes_onepass(D: int, Sq: int, Lk: int, Le: int, mode: AttnMode | str = AttnMode.SELF,
                  dtype=torch.bfloat16) -> bool:
    """Whether a call at instance head dim D (the padded one, 40, 64, 80 or
    160) of Sq queries over Lk own keys and Le endpoint keys in ``mode`` on
    ``dtype`` operands takes the short-stream kernel
    (csrc/flash_attention_onepass.cu, bf16 and f16): its whole stream fits an
    instance (:func:`onepass_tiles`), and its (b, h) has more than
    :data:`ONEPASS_MIN_QUERIES` query rows (the measured limit). Every other
    call keeps the D <= 160 streaming kernel."""
    return dtype in ONEPASS_ENTRIES and Sq > ONEPASS_MIN_QUERIES and onepass_tiles(D, Lk, Le, mode) is not None


#: the C entry of the mid-length stream kernel by operand dtype
#: (csrc/flash_attention_midstream.cu; the D <= 160 kernels' C signature)
MIDSTREAM_ENTRIES = {torch.bfloat16: "aid_flash_attn_bf16_midstream", torch.float16: "aid_flash_attn_f16_midstream"}
#: its instances by head dim: (keys a K/V tile, K/V stages at two consumer
#: warpgroups (one fewer at three), Q/O buffers in the ring, the most consumer
#: warpgroups a block), the source's Mid<D>
MIDSTREAM_TILES = {64: (128, 3, 3, 3), 80: (64, 3, 2, 2)}
#: the longest stream (own keys plus each endpoint segment's) the route sends
#: it: the JAX wrapper's onepass_max (aid_tpu/ops/flash_attention.py:709)
MIDSTREAM_MAX_STREAM = 3072
#: the shared memory a block can use (the source's kSmemLimit)
MIDSTREAM_SMEM_LIMIT = 232448


def midstream_tiles(D: int, Sq: int, B: int = 1, H: int = 1) -> dict:
    """The mid-length stream kernel's schedule for a call at instance head
    dim D (64 or 80) of Sq queries a (b, h) over B rows and H heads, as the
    source's host code picks it: ``nwg`` consumer warpgroups of 64 query rows
    a block (the instance's most: 3 at D = 64, 2 at 80), ``BQ`` = 64 nwg rows
    a work item, ``tiles`` query tiles a (b, h), ``units`` the work items (B
    H tiles; the persistent grid walks them heaviest first in a snake),
    ``BK`` keys a K/V tile, ``stages``, ``ring`` (Q/O buffers),
    ``idle`` (the instance whose warpgroups with every row past Sq skip the
    math: three warpgroups and a last item with such a warpgroup) and
    ``smem`` (a block's bytes: the Q/O ring, the K/V stages, the outer modes'
    parked state of each consumer thread, the barriers and each buffer's
    unit, the 1024-byte alignment slack)."""
    bk, stages, ring, nwg = MIDSTREAM_TILES[D]
    stages -= nwg == 3
    tiles = -(-Sq // (64 * nwg))
    chunks = -(-D // 64)
    smem = (1024 + ring * nwg * 64 * 128 * chunks + stages * 2 * bk * 128 * chunks + nwg * 128 * (D // 2 + 4) * 4
            + 8 * (2 * stages + 3 * ring))
    return dict(nwg=nwg, BQ=64 * nwg, tiles=tiles, units=B * H * tiles, BK=bk, stages=stages, ring=ring,
                chunks=chunks, smem=smem, idle=nwg == 3 and tiles * 192 - Sq >= 64)


#: the route's measured limits (in turns on an H100, 700 W;
#: tools/attention_bench.py --midstream, PERF.md section 6): a call in the
#: kernel's contract takes it with at least MIDSTREAM_MIN_QUERIES query rows a
#: (b, h), the fewest it measured faster at (SD 2.1's 576: self 0.044 ms
#: against 0.048), and only in the modes MIDSTREAM_MODES lists at its head
#: dim: every mode at D = 64, self mode at D = 80 (0.060 against 0.061; its
#: 64-key tiles lose the outer modes and fused_inner (7,8,1024,80) by 3-6%,
#: and pure_inner ties within 1%)
MIDSTREAM_MIN_QUERIES = 576
MIDSTREAM_MODES = {64: frozenset(m.value for m in AttnMode), 80: frozenset({"self"})}


@functools.lru_cache(maxsize=4096)
def takes_midstream(D: int, Sq: int, Lk: int, Le: int, mode: AttnMode | str = AttnMode.SELF,
                    dtype=torch.bfloat16) -> bool:
    """Whether a call at instance head dim D (the padded one) of Sq queries
    over Lk own keys and Le endpoint keys in ``mode`` on ``dtype`` operands
    takes the mid-length stream kernel (csrc/flash_attention_midstream.cu,
    bf16 and f16 at D = 64 and 80): the short-stream kernel does not take it
    (:func:`takes_onepass`), its stream (the own keys and each endpoint
    segment's) is at most :data:`MIDSTREAM_MAX_STREAM` keys, `_kernel_onepass`'s
    contract in the JAX wrapper, its (b, h) has at least
    :data:`MIDSTREAM_MIN_QUERIES` query rows and its mode is one of
    :data:`MIDSTREAM_MODES` at D (the measured limits). Every other call
    keeps the D <= 160 streaming kernel."""
    mode = AttnMode(mode)
    has_own = mode in (AttnMode.SELF, AttnMode.FUSED_OUTER, AttnMode.FUSED_INNER)
    n_sets = 2 if mode.is_outer else (1 if mode.is_inner else 0)
    stream = has_own * Lk + n_sets * Le
    return (dtype in MIDSTREAM_ENTRIES and mode.value in MIDSTREAM_MODES.get(D, ()) and stream <= MIDSTREAM_MAX_STREAM
            and Sq >= MIDSTREAM_MIN_QUERIES and not takes_onepass(D, Sq, Lk, Le, mode, dtype))


#: the widest head dim (the JAX wrapper's block budget in bf16): the wide
#: entries take 513..DWIDE and are counted under it
DWIDE = 2048
#: the C entry of the wide kernels by operand dtype (csrc/flash_attention_dwide.cu;
#: the D = 512 endpoint entries' C signature), every mode
DWIDE_ENTRIES = {torch.bfloat16: "aid_flash_attn_bf16_dwide", torch.float16: "aid_flash_attn_f16_dwide",
                 torch.float32: "aid_flash_attn_f32_dwide"}
#: the padded head dims of the wide kernel's instances (the source's wide_dp)
DWIDE_PADDED = (640, 1024, 1280, 2048)
#: its key split: a grid of fewer than DWIDE_SPLIT_BLOCKS blocks (the H100's
#: SMs) splits each row block's key stream across up to DWIDE_MAX_SPLIT
#: blocks (kSplitBlocks, kMaxSplit)
DWIDE_SPLIT_BLOCKS, DWIDE_MAX_SPLIT = 132, 32


def dwide_tiles(D: int, dtype=torch.bfloat16) -> tuple:
    """The wide kernel's tiling at an operand head dim D in ``dtype``: (Dp,
    query rows a block, keys a tile), as csrc/flash_attention_dwide.cu's host
    code picks them (wide_dp, wide_rows): Dp the first of
    :data:`DWIDE_PADDED` at or above D (two consumer warpgroups take its
    64-column chunks in turn); 32 rows where Dp <= 1024, else 16, and 128
    keys (two 64-key M blocks of wgmma, one a warpgroup's softmax) in bf16
    and f16; 16 rows where Dp = 640, else 8, and 64 keys in f32 (whose Q
    and lo(Q) both stay in shared memory)."""
    Dp = next(d for d in DWIDE_PADDED if D <= d)
    if dtype == torch.float32:
        return Dp, 16 if Dp <= 640 else 8, 64
    return Dp, 32 if Dp <= 1024 else 16, 128


def dwide_split(blocks: int, tiles: int) -> int:
    """The blocks across which the wide kernel splits each row block's key
    stream of ``tiles`` key tiles, in a grid of ``blocks`` row blocks (the
    source's wide_splits): 1 from :data:`DWIDE_SPLIT_BLOCKS` blocks on,
    else min(DWIDE_SPLIT_BLOCKS // blocks, tiles, DWIDE_MAX_SPLIT), so
    that every split holds a tile."""
    if blocks >= DWIDE_SPLIT_BLOCKS:
        return 1
    return max(1, min(DWIDE_SPLIT_BLOCKS // blocks, tiles, DWIDE_MAX_SPLIT))


def dmid_columns(D: int, dtype=torch.bfloat16) -> int:
    """The head-dim columns the D=161-512 endpoint kernel computes at an
    operand head dim D in ``dtype``: D rounded up to its chunks
    (:func:`dmid_tiles`: 64 columns in bf16 and f16, 7 chunks run as 8; 32
    in f32)."""
    return dmid_tiles(D, dtype)["chunks"] * (32 if dtype == torch.float32 else 64)


def takes_d512_self(D: int, mode: AttnMode | str = AttnMode.SELF, dtype=torch.bfloat16) -> bool:
    """Whether a call at head dim D in ``mode`` on ``dtype`` operands takes
    the D=512 self kernels (:func:`d512_operands`): self mode past the
    dtype's :data:`DMID_SELF_MAX` up to :data:`D512`. Every other call at
    161-512 takes the D=161-512 entries."""
    return AttnMode(mode) == AttnMode.SELF and DMID_SELF_MAX.get(dtype, D512) < D <= D512


def instance_head_dim(Dp: int) -> int:
    """The head dim a launch at operand head dim Dp is counted under: Dp up
    to 160, :data:`D512` for the D=161-512 entries, :data:`DWIDE` for the
    wide entries."""
    return Dp if Dp <= KERNEL_HEAD_DIMS[-1] else D512 if Dp <= D512 else DWIDE


#: the static-shift softmax (aid_tpu/ops/flash_attention.py:44-65): with a
#: shift C, each accumulator set's probabilities are exp(min(s * scale - C,
#: STATIC_SHIFT_CLIP)) over their own sum, with no row max, no rescale of the
#: accumulators; the same softmax while every set's row max lies in [C - 72,
#: C + 30] ([-32, +70] at the model path's C = STATIC_SHIFT_C)
STATIC_SHIFT_C = 40.0
STATIC_SHIFT_CLIP = 30.0
_LOG2E = 1.4426950408889634
#: the C entries of the static-shift instances by operand dtype (the D <= 160
#: C signature with the shift and the clip, in log2 units, after the scale):
#: the D <= 160 streaming kernels (csrc/flash_interpolated_attention_static.cu,
#: csrc/flash_interpolated_attention_f32_static.cu, every mode) and the bf16
#: mid-length stream kernel (csrc/flash_attention_midstream_static.cu, the
#: endpoint modes at STATIC_MIDSTREAM_DIMS); f16 has none: exp(-40) is below
#: f16's smallest subnormal, so P would flush to 0
STATIC_ENTRIES = {torch.bfloat16: "aid_flash_attn_bf16_static", torch.float32: "aid_flash_attn_f32_static"}
STATIC_MIDSTREAM_ENTRIES = {torch.bfloat16: "aid_flash_attn_bf16_midstream_static"}
STATIC_MIDSTREAM_DIMS = (64,)
#: the static-shift instances of the D=512 self kernels (csrc/flash_attention_f32_d512_static.cu,
#: csrc/flash_attention_bf16_d512_static.cu: the D=512 entries' C signature with the shift and the
#: clip after the scale) and of the D=161-512 kernels (csrc/flash_attention_dmid_static.cu,
#: csrc/flash_attention_dmid_f32_static.cu: every mode and self mode, the dmid entries' signature
#: with the shift and the clip after the scale), by operand dtype; none in f16
STATIC_D512_ENTRIES = {torch.bfloat16: "aid_flash_attn_bf16_d512_static",
                       torch.float32: "aid_flash_attn_f32_d512_static"}
STATIC_DMID_ENTRIES = {torch.bfloat16: "aid_flash_attn_bf16_dmid_static",
                       torch.float32: "aid_flash_attn_f32_dmid_static"}
#: the static-shift instances of the wide kernels (csrc/flash_attention_dwide_static.cu: the wide
#: entries' signature with the shift and the clip after the scale, every mode, the key split's
#: combine step O = sum O_s / sum l_s), by operand dtype; none in f16
STATIC_DWIDE_ENTRIES = {torch.bfloat16: "aid_flash_attn_bf16_dwide_static",
                        torch.float32: "aid_flash_attn_f32_dwide_static"}
#: the JAX wrapper's constants that decide its "auto" (aid_tpu/ops/flash_attention.py:
#: 80, 88, 703, 708 and its 128-lane block rounding), copied
JAX_ONEPASS_MAX, JAX_SPLIT_ONEPASS_MAX, JAX_ONEPASS_MAX_RESIDENT_COLS = 3072, 16384, 20 * 1024
JAX_BLOCK_K, JAX_LANES = 1024, 128
#: the widest head dim the JAX wrapper runs its Pallas kernels at, by the
#: operands' byte width (its 512 KB block budget over 128 rows,
#: aid_tpu/ops/flash_attention.py:806-816; past it the wrapper raises): "auto"
#: keeps a wider call exact, the JAX package making no choice to mirror
JAX_BLOCK_BUDGET_D = {2: 2048, 4: 1024}
#: the call classes (the static_route kernel: "streaming", "midstream",
#: "dmid", "d512" or "dwide"; dtype, instance head dim, mode; "dwide" keyed by
#: the wide instance's 640, 1024, 1280 or 2048) where the card measured
#: the static instance slower than the exact one: "auto" keeps them exact. In turns on an H100 (700 W;
#: tools/attention_bench.py --static, ten pairs, two calls; PERF.md section
#: 6): f32 self mode at D = 64, (7,10,4096,64) 2.867 / 2.826 ms against
#: 2.855 / 2.815 (no slower in 4 and 2 of 10 pairs; the 3xTF32 products
#: bind, and the clip costs what the max saved), while every bf16 class and
#: the other f32 ones measured 1-12% faster. A call the short-stream kernel
#: takes stays exact under "auto" too: its static instance would be the
#: streaming kernel's, 14% slower at (7,10,4096,77) fused_outer (0.0963
#: against 0.0847 ms). Past 512 (the wide kernels, ten pairs alone, medians):
#: every bf16 class 2-9% faster and every f32 one through 1024 2-5%, but f32
#: self at 2048, (2,1,512,2048) 0.2566 against 0.2527 ms (no slower in 0 of
#: 10 pairs; "auto" keeps f32 past 1024 exact in any case, where the JAX
#: wrapper raises)
STATIC_SHIFT_SLOWER = frozenset({("streaming", "f32", 64, "self"), ("dwide", "f32", 2048, "self")})

_STATIC_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32"}


def jax_static_smax(q_shape, dtype, Lk: int, mode: AttnMode | str = AttnMode.SELF, Le: Optional[int] = None,
                    split_capable: bool = False, *, onepass_max: int = JAX_ONEPASS_MAX, block_k: int = JAX_BLOCK_K,
                    split_onepass_max: int = JAX_SPLIT_ONEPASS_MAX,
                    resident_cols: int = JAX_ONEPASS_MAX_RESIDENT_COLS) -> Optional[float]:
    """What the JAX wrapper resolves ``static_smax="auto"`` to for a call of
    ``q_shape`` (B, H, Sq, D) on ``dtype`` operands over Lk own keys and Le
    keys an endpoint segment (aid_tpu/ops/flash_attention.py:764-891, its
    defaults pad_d=False, exp_impl "f32"): None (exact) where `_kernel_onepass`
    takes a self call, else STATIC_SHIFT_C. ``split_capable``: outer modes
    with shared (H, Le, D) endpoints (or none passed), which the JAX wrapper
    routes to the one-pass kernel up to ``split_onepass_max``. Needs no
    device."""
    mode = AttnMode(mode)
    H, D = q_shape[1], q_shape[3]
    Le = Lk if Le is None else Le

    def ceil_to(x, m):
        return -(-x // m) * m

    Dp = D if D <= JAX_LANES or D % JAX_LANES == 0 else ceil_to(D, JAX_LANES)
    itemsize = {torch.float32: 4, torch.float64: 8}.get(dtype, 2)
    max_rows = max(JAX_LANES, (512 * 1024) // (Dp * itemsize) // JAX_LANES * JAX_LANES)
    bk = min(block_k, max_rows, ceil_to(max(Lk, Le), JAX_LANES))
    include_self = mode in (AttnMode.SELF, AttnMode.FUSED_OUTER, AttnMode.FUSED_INNER)
    n_self = ceil_to(Lk, bk) // bk if include_self else 0
    n_ep = (2 if mode.is_outer else 1 if mode.is_inner else 0) * (ceil_to(Le, bk) // bk)
    Ltot = (n_self + n_ep) * bk
    limit = onepass_max
    if split_capable and mode.is_outer and onepass_max:
        limit = max(onepass_max, split_onepass_max)
    hgroup = None
    if Ltot <= limit:
        hgroup = next((g for g in range(H, 0, -1) if H % g == 0 and g * Ltot <= resident_cols), None)
    return None if (hgroup is not None and mode == AttnMode.SELF) else STATIC_SHIFT_C


def static_route(D: int, Sq: int, Lk: int, Le: int, mode: AttnMode | str = AttnMode.SELF, dtype=torch.bfloat16) -> str:
    """The kernel a static-shift call at instance head dim D takes: "dwide"
    (the wide kernels' static instance: every call past 512), "d512" (the
    D=512 self kernels' static instance, where :func:`takes_d512_self`),
    "dmid" (the D=161-512 kernels' static instance: every other call from
    161 to 512), "midstream" (the bf16 mid-length stream kernel's static
    instance, where :func:`takes_midstream` holds in an endpoint mode at
    :data:`STATIC_MIDSTREAM_DIMS`) or "streaming" (the D <= 160 kernel's:
    every other call, the short-stream kernel's calls among them)."""
    mode = AttnMode(mode)
    if D > D512:
        return "dwide"
    if takes_d512_self(D, mode, dtype):
        return "d512"
    if KERNEL_HEAD_DIMS[-1] < D <= D512:
        return "dmid"
    if (dtype in STATIC_MIDSTREAM_ENTRIES and D in STATIC_MIDSTREAM_DIMS and mode != AttnMode.SELF
            and takes_midstream(D, Sq, Lk, Le, mode, dtype)):
        return "midstream"
    return "streaming"


def resolve_static_smax(q: torch.Tensor, k: torch.Tensor, mode: AttnMode | str = AttnMode.SELF, k_begin=None,
                        k_end=None, v_begin=None, v_end=None, static_smax="auto") -> Optional[float]:
    """The shift a call computes with (a float C) or None (exact). A float
    stays (raising ``ValueError`` on f16 operands: exp(-40) ~ 4e-18 is under
    f16's smallest subnormal, so P would flush to 0; the JAX package has no
    f16); None stays. ``"auto"`` takes the JAX wrapper's choice
    (:func:`jax_static_smax`) and keeps a call
    exact where the port has no instance measured no slower: in f16, on the
    plain route (CPU tensors, ``reference_ops``: the JAX model path is exact
    on the CPU), on the short-stream kernel's calls, and in
    :data:`STATIC_SHIFT_SLOWER`; and exact past the JAX wrapper's block
    budget (:data:`JAX_BLOCK_BUDGET_D`: f32 past a padded head dim of 1024),
    where that wrapper raises and makes no choice. Up to 2048 in bf16 and to
    1024 in f32 the wide kernels' static instances take the shift. Strings other than "auto" raise, as
    aid_tpu/ops/flash_attention.py:764-766."""
    if isinstance(static_smax, str) and static_smax != "auto":
        raise ValueError(f"static_smax must be None, a float, or 'auto'; got {static_smax!r}")
    if static_smax is None:
        return None
    if static_smax != "auto":
        if q.dtype == torch.float16:
            raise ValueError("static_smax is not supported in f16: exp(-C) at C = 40 (~4e-18) is below f16's "
                             "smallest subnormal (6e-8), so the probabilities would flush to 0; pass "
                             "static_smax=None or 'auto' (exact in f16)")
        return float(static_smax)
    if q.dtype not in STATIC_ENTRIES or not use_kernel(q, k):
        return None
    Le = k.shape[-2] if k_begin is None else k_begin.shape[-2]
    split = all(e.dim() == 3 for e in (k_begin, v_begin, k_end, v_end) if e is not None)
    return _auto_shift(tuple(q.shape), q.dtype, k.shape[-2], AttnMode(mode), Le, split)


@functools.lru_cache(maxsize=4096)
def _auto_shift(q_shape, dtype, Lk: int, mode: AttnMode, Le: int, split_capable: bool):
    """"auto" on the kernel route for a call's shapes (cached: the model
    path asks on every call, at a few shapes): the JAX wrapper's choice,
    then exact past its block budget (:data:`JAX_BLOCK_BUDGET_D`), on the
    short-stream kernel's calls and in :data:`STATIC_SHIFT_SLOWER` (a wide
    call keyed by its instance's padded head dim, :func:`dwide_tiles`)."""
    if jax_static_smax(q_shape, dtype, Lk, mode, Le, split_capable) is None:
        return None
    D, Sq = q_shape[3], q_shape[2]
    if -(-D // JAX_LANES) * JAX_LANES > JAX_BLOCK_BUDGET_D[4 if dtype == torch.float32 else 2]:
        return None
    Dp = padded_head_dim(D, mode, dtype)
    if takes_onepass(Dp, Sq, Lk, Le, mode, dtype):
        return None
    route = static_route(Dp, Sq, Lk, Le, mode, dtype)
    Dk = dwide_tiles(Dp, dtype)[0] if route == "dwide" else Dp
    if (route, _STATIC_DTYPE_NAMES[dtype], Dk, mode.value) in STATIC_SHIFT_SLOWER:
        return None
    return STATIC_SHIFT_C


def flash_interpolated_attention_plain(
    q, k, v, coef=None, mode: AttnMode | str = AttnMode.SELF,
    k_begin=None, v_begin=None, k_end=None, v_end=None,
    scale: Optional[float] = None, skip_endpoints=None, static_smax: Optional[float] = None,
) -> torch.Tensor:
    """The kernel's plain PyTorch version: ``interpolated_attention``, with
    fused-mode skip rows replaced by vanilla attention over their own K/V
    (what the kernel computes when it drops their endpoint segments). A
    float ``static_smax`` C makes each accumulator set's softmax the static
    shift's, exp(min(s * scale - C, STATIC_SHIFT_CLIP)) over its own sum in
    f32, the probabilities rounded to the input dtype for P V as in the
    exact one."""
    mode = AttnMode(mode)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if coef is None and mode != AttnMode.SELF:
        coef = torch.zeros(q.shape[0], dtype=torch.float32, device=q.device)
    static = None if static_smax is None else (float(static_smax), STATIC_SHIFT_CLIP)
    out = interpolated_attention(q, k, v, coef, mode, k_begin=k_begin, v_begin=v_begin,
                                 k_end=k_end, v_end=v_end, scale=scale, static=static)
    if skip_endpoints is not None and mode.is_fused:
        rows = torch.as_tensor(skip_endpoints, device=q.device).reshape(-1).bool()
        if bool(rows.any()):
            idx = rows.nonzero().reshape(-1)
            out = out.clone()
            out[idx] = _softmax_attn(q[idx], k[idx], v[idx], scale, static)
    return out


def padded_head_dim(D: int, mode: AttnMode | str = AttnMode.SELF, dtype=torch.bfloat16) -> int:
    """The head dim the operands of a call at head dim D in ``mode`` on
    ``dtype`` operands are padded to: the next of :data:`KERNEL_HEAD_DIMS`
    at or above D up to 160; from 161 to 512 D rounded up to a multiple of
    8 (the D=161-512 entries, in every mode, take any head dim with 16-byte
    rows and round it up to their column chunk themselves), but
    :data:`D512` where :func:`takes_d512_self` (self mode past the dtype's
    :data:`DMID_SELF_MAX`: the D=512 self kernels); from 513 to
    :data:`DWIDE` D rounded up to a multiple of 8 in every mode (the wide
    entries). Raises
    ``NotImplementedError`` past :data:`DWIDE`, as the JAX wrapper raises
    past its block budget."""
    mode = AttnMode(mode)
    for Dp in KERNEL_HEAD_DIMS:
        if D <= Dp:
            return Dp
    if takes_d512_self(D, mode, dtype):
        return D512
    if D <= DWIDE:
        return -(-D // 8) * 8
    raise NotImplementedError(f"no flash kernel takes head dim {D} in {mode.value} mode: none is wider "
                              f"than {DWIDE}")


def _pad_head_dim(x: torch.Tensor, Dp: int) -> torch.Tensor:
    """x zero-padded along its last dim to Dp (a new contiguous tensor), or x."""
    return x if x.shape[-1] == Dp else torch.nn.functional.pad(x, (0, Dp - x.shape[-1]))


def _check_dtype(name: str, x: torch.Tensor, dtype=torch.bfloat16) -> None:
    if x.dtype != dtype:
        raise NotImplementedError(f"flash kernel takes {dtype} here; {name} is {x.dtype} (the flash kernels "
                                  "take bf16, f16 or f32)")


def _check_operand(name: str, x: torch.Tensor, dtype=torch.bfloat16) -> None:
    """x as a kernel reads it: its dtype, a contiguous head dim and 16-byte rows."""
    _check_dtype(name, x, dtype)
    strides = x.stride()
    if strides[-1] != 1:
        raise ValueError(f"{name}: the head dim must be contiguous, strides {strides}")
    per_16_bytes = 16 // x.element_size()
    if any(s % per_16_bytes for s in strides[:-1]) or x.data_ptr() % 16:
        raise ValueError(f"{name}: 16-byte row alignment needed, strides {strides}")


#: the bf16 and f16 D=512 kernel's tiles: (query rows per block, keys per
#: K/V tile, slots in each of the K and V rings, consumer warpgroups
#: splitting D), csrc/flash_attention_bf16_d512.cu's kBQ, kBK, kStages and kWG
D512_BF16_TILES = (64, 32, 2, 2)
#: the f32 D=512 kernel's tiles: (query rows per block, keys per K/V tile,
#: consumer warpgroups splitting D), csrc/flash_attention_f32_d512.cu's kBQ,
#: kBK and kWG; one slot each for K and V beside the resident Q tile
F32_D512_TILES = (64, 16, 2)


def _static_log2(static_smax, dtype) -> Optional[tuple]:
    """A resolved shift C (or None) as the static instances take it: (C
    log2(e), STATIC_SHIFT_CLIP log2(e)), the shift and the clip in the
    kernels' exp2 units; a shift on f16 operands raises ``ValueError``."""
    if static_smax is None:
        return None
    if dtype not in STATIC_ENTRIES:
        raise ValueError(f"no static-shift instance takes {dtype} (f16: exp(-C) flushes to 0); pass "
                         "static_smax=None")
    return float(static_smax) * _LOG2E, STATIC_SHIFT_CLIP * _LOG2E


def d512_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None,
                  static_smax: Optional[float] = None) -> dict:
    """Check the operands of the D=512 self-attention kernel of q's dtype
    (f32: ``csrc/flash_attention_f32_d512.cu``, bf16 and f16: the two
    instances of ``csrc/flash_attention_bf16_d512.cu``) and lay out one call
    of its C entry (:data:`D512_ENTRIES`): ``entry``, ``tensors`` (q, k, v
    and the output: f32 (B, H, Sq, 512); bf16 and f16 a (B, H, Sq, 512) view
    of a new (B, Sq, H, 512) buffer, as the D <= 160 kernel writes), ``dims`` (B, H, Sq, Lk, then the (b, h, s)
    element strides of the four), ``scale``, ``head_dim`` (the caller's D)
    and ``out`` (the output at that D). A head dim between 160 and 512 is
    zero-padded to 512, the scale kept at the unpadded D. ``static_smax``,
    a resolved shift C or None, lays out the static-shift instance
    (:data:`STATIC_D512_ENTRIES`) with ``static`` = (C log2(e),
    STATIC_SHIFT_CLIP log2(e)), passed after the scale; None (exact) where
    none; on f16 a shift raises ``ValueError``. Nothing here needs a
    device."""
    B, H, Sq, D = q.shape
    if q.dtype not in D512_ENTRIES:
        raise NotImplementedError(f"the D={D512} self-attention kernels take f32, bf16 or f16; q is {q.dtype}")
    if k.dim() != 4 or k.shape[:2] != (B, H) or k.shape[-1] != D or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if not KERNEL_HEAD_DIMS[-1] < D <= D512:
        raise NotImplementedError(f"the D={D512} self-attention kernels take head dims {KERNEL_HEAD_DIMS[-1] + 1}.."
                                  f"{D512} (padded to {D512}); q has {D} (past {D512} the wide entries take it: "
                                  "kernel_operands)")
    if Sq == 0 or k.shape[2] == 0:
        raise ValueError("empty query or key sequence")
    static = _static_log2(static_smax, q.dtype)
    q, k, v = (_pad_head_dim(x, D512) for x in (q, k, v))
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, q.dtype)
    if q.dtype == torch.float32:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    else:
        out = torch.empty((B, Sq, H, D512), dtype=q.dtype, device=q.device).transpose(1, 2)
    dims = [B, H, Sq, k.shape[2]]
    for x in (q, k, v, out):
        dims += _bhs_strides(x)
    entry = (D512_ENTRIES if static is None else STATIC_D512_ENTRIES)[q.dtype]
    return dict(entry=entry, static=static, tensors=(q, k, v, out), dims=dims,
                scale=float(D ** -0.5 if scale is None else scale), head_dim=D, out=out[..., :D])


def d512_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None,
                static_smax: Optional[float] = None) -> tuple:
    """:func:`d512_operands` on CUDA tensors, prepared for launching:
    returns ``(out, launch)``, where ``launch()`` runs the kernel into
    ``out`` on the current stream, as often as it is called. Counts
    nothing: the wrappers count their launches."""
    ops = d512_operands(q, k, v, scale, static_smax)
    entry, out, dims = ops["entry"], ops["out"], ops["dims"]

    from aid_tpu_torch.ops import _build

    fn = getattr(_build.library(), entry)
    # the static-shift entries take the shift and the clip (log2 units) after the scale
    c_args = (*(x.data_ptr() for x in ops["tensors"]), (ctypes.c_longlong * len(dims))(*dims), ops["scale"],
              *(ops["static"] or ()), torch.cuda.current_stream(q.device).cuda_stream)

    def launch() -> None:
        _build.check(fn(*c_args), f"{entry} launch")

    launch.operands = ops  # the pointers in c_args stay valid while launch lives
    return out, launch


def _self_attention_d512(wrapper, small, q, k, v, scale, static_smax):
    """The D=512 self-attention wrappers' shared body: ``static_smax``
    resolved (:func:`resolve_static_smax`: None, a float C, or "auto"; a
    float raises ``ValueError`` on f16), then the plain ``_softmax_attn`` (at
    the static shift where one) on CPU tensors; on CUDA tensors of
    ``wrapper``'s dtype (:data:`_WRAPPER_DTYPES`) ``small`` (the
    interpolating wrapper of that dtype: the D <= 160 kernels, the
    D=161-512 entries' self instance, or the wide entries past 512) unless
    :func:`takes_d512_self`, else the D=512 kernel (its static-shift
    instance where shifted, counted in ``wrapper.launches_static`` too),
    counted on ``wrapper``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    shift = resolve_static_smax(q, k, AttnMode.SELF, static_smax=static_smax)
    if not use_kernel(q, k, v):
        return _softmax_attn(q, k, v, scale, None if shift is None else (shift, STATIC_SHIFT_CLIP))
    _check_dtype("q", q, _WRAPPER_DTYPES[wrapper.__name__])
    if not takes_d512_self(q.shape[-1], dtype=q.dtype):  # the D <= 160, D=161-512 or wide entries
        return small(q, k, v, scale=scale, static_smax=shift)
    out, launch = d512_launch(q, k, v, scale, shift)
    launch()
    wrapper.launches += 1
    if shift is not None:
        wrapper.launches_static += 1
    return out


def flash_self_attention_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             scale: Optional[float] = None, static_smax=None) -> torch.Tensor:
    """softmax(q k^T * scale) v in f32 with head dim 512 (the VAE mid-block
    contract): ``csrc/flash_attention_f32_d512.cu`` on CUDA tensors, the
    plain ``_softmax_attn`` on CPU tensors. On CUDA a head dim from 161 to
    f32's :data:`DMID_SELF_MAX` (448) takes the f32 D=161-512 entry's self
    instance (one from 449 to 511 pads to 512), one of 160 or less (a tiny
    VAE's) the D <= 160 kernel in self mode, padded where needed, and one
    past 512 the f32 wide entry. ``static_smax`` (None, the default: exact;
    a float C; or "auto", as :func:`resolve_static_smax` resolves it): the
    static-shift softmax, on CUDA at D=512 the static instance
    ``aid_flash_attn_f32_d512_static``.

    q: (B, H, Sq, D), k/v: (B, H, Lk, D), all f32. Returns (B, H, Sq, D) f32.
    """
    return _self_attention_d512(flash_self_attention_f32, flash_interpolated_attention_f32, q, k, v, scale, static_smax)


#: kernel launches since the last reset (chip_smoke.py reads it around each path); of those, the
#: static-shift instance's in ``launches_static``
flash_self_attention_f32.launches = 0
flash_self_attention_f32.launches_static = 0


def flash_self_attention_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              scale: Optional[float] = None, static_smax=None) -> torch.Tensor:
    """softmax(q k^T * scale) v in bf16 with head dim 512 (the mid-block
    attention of a bf16 VAE): ``csrc/flash_attention_bf16_d512.cu`` on CUDA
    tensors, the plain ``_softmax_attn`` (f32 logits and softmax, the
    probabilities rounded to bf16 before P V) on CPU tensors. On CUDA a head
    dim from 161 to 511 (:data:`DMID_SELF_MAX`) takes the bf16 D=161-512
    entry's self instance, one of 160 or less the bf16 D <= 160 kernel in
    self mode, padded where needed, and one past 512 the bf16 wide entry.
    ``static_smax`` as in :func:`flash_self_attention_f32` (the static
    instance ``aid_flash_attn_bf16_d512_static``).

    q: (B, H, Sq, D), k/v: (B, H, Lk, D), all bf16. Returns (B, H, Sq, D)
    bf16; on CUDA a view of a (B, Sq, H, D) buffer, as the other bf16 kernel
    writes (sliced from a padded one where D was padded).
    """
    return _self_attention_d512(flash_self_attention_bf16, flash_interpolated_attention, q, k, v, scale, static_smax)


#: kernel launches since the last reset (chip_smoke.py reads it around each path); of those, the
#: static-shift instance's in ``launches_static``
flash_self_attention_bf16.launches = 0
flash_self_attention_bf16.launches_static = 0


def flash_self_attention_f16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             scale: Optional[float] = None, static_smax=None) -> torch.Tensor:
    """:func:`flash_self_attention_bf16` in f16 (the mid-block attention of
    an f16 VAE): the f16 instance of ``csrc/flash_attention_bf16_d512.cu``
    on CUDA tensors, the plain ``_softmax_attn`` (f32 logits and softmax,
    the probabilities rounded to f16 before P V) on CPU tensors. On CUDA a
    head dim of 160 or less takes the f16 D <= 160 kernel in self mode, one
    from 161 to 511 (:data:`DMID_SELF_MAX`) the f16 D=161-512 entry's self
    instance, one past 512 the f16 wide entry. No static-shift instance: a
    float ``static_smax`` raises ``ValueError``, "auto" is exact.

    q: (B, H, Sq, D), k/v: (B, H, Lk, D), all f16. Returns (B, H, Sq, D)
    f16; on CUDA a view of a (B, Sq, H, D) buffer.
    """
    return _self_attention_d512(flash_self_attention_f16, flash_interpolated_attention_f16, q, k, v, scale, static_smax)


#: kernel launches since the last reset (chip_smoke.py reads it around each path); of those, the
#: static-shift instance's in ``launches_static``
flash_self_attention_f16.launches = 0
flash_self_attention_f16.launches_static = 0


def _bhs_strides(x: torch.Tensor) -> list:
    """(b, h, s) element strides of a (B, H, L, D) or shared (H, L, D) tensor."""
    st = x.stride()
    return [0, st[0], st[1]] if len(st) == 3 else list(st[:3])


def kernel_operands(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, H, Lk, D)
    v: torch.Tensor,
    coef: Optional[torch.Tensor] = None,  # (B,)
    mode: AttnMode | str = AttnMode.SELF,
    k_begin: Optional[torch.Tensor] = None,  # (H, Le, D) shared or (B, H, Le, D) per row; default k[0]
    v_begin: Optional[torch.Tensor] = None,
    k_end: Optional[torch.Tensor] = None,  # default k[-1]
    v_end: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    skip_endpoints: Optional[torch.Tensor] = None,  # (B,) bool: rows whose endpoint segments are dropped
    onepass: Optional[bool] = None,
    midstream: Optional[bool] = None,
    static_smax: Optional[float] = None,
) -> dict:
    """Check the operands of the interpolating kernel of q's dtype (bf16,
    f16 or f32) and head dim (the D <= 160 kernels, the D = 161-512 ones,
    the wide ones past 512, every mode) and lay out one call of its C entry (``entry``, :data:`KERNEL_ENTRIES`,
    :data:`DMID_ENTRIES` or :data:`DWIDE_ENTRIES`; in bf16 and f16
    :data:`ONEPASS_ENTRIES` where :func:`takes_onepass`, or as ``onepass``
    says: False keeps a routed call on the D <= 160 streaming kernel, True
    sends a call that fits it there past the route's measured limit and
    raises where its stream does not fit; else :data:`MIDSTREAM_ENTRIES`
    where :func:`takes_midstream`, or as ``midstream`` says: False keeps a
    routed call on the streaming kernel, True sends a bf16 or f16 call at an
    instance head dim of :data:`MIDSTREAM_TILES` there, of any stream length,
    and raises otherwise), ``onepass`` and ``midstream`` (whether it is that
    entry): ``tensors`` (q,
    k, v, k_begin, v_begin, k_end, v_end and the output, a (B, H, Sq, Dp)
    view of a new (B, Sq, H, Dp) buffer), ``dims`` (the entry's 30 shape and
    stride values), ``coef`` and ``skip`` (None where the mode reads
    neither), ``work`` (the f32 workspace: from 161 to 512 the outer modes'
    (work_tiles, park_words, park_threads) of :func:`dmid_tiles`; past it
    (blocks * splits, sets, BQ * Dp + 2 BQ): each split's O, max and sum per
    softmax set (2 in the outer modes, else 1), where the outer modes park a
    set or the key stream is split, with BQ and Dp from :func:`dwide_tiles`
    and the split from :func:`dwide_split`, also returned as ``splits``;
    else None), ``scale``, ``has_own``, ``n_sets``,
    ``head_dim`` (the caller's D) and ``out`` (the output at that D). A head dim that no
    instance takes is zero-padded to the next one, Dp
    (:func:`padded_head_dim`), after the endpoints are made and before the
    layout is checked; the scale stays D's. Self mode reads no endpoint: its
    slots repeat k and v (from 161 to 512 ``n_sets`` 0, the D=161-512
    entries' self instance, with no coefficient, skip row or workspace; past
    the dtype's :data:`DMID_SELF_MAX` it is the D=512 self kernels',
    :func:`d512_operands`). ``static_smax``, a resolved shift C
    (:func:`resolve_static_smax`) or None, lays out the static-shift
    instance (:data:`STATIC_ENTRIES`; :data:`STATIC_MIDSTREAM_ENTRIES` where
    :func:`static_route` says "midstream", or as ``midstream`` says; from 161
    to 512 :data:`STATIC_DMID_ENTRIES`, past 512 :data:`STATIC_DWIDE_ENTRIES`,
    each with the exact entry's workspace and, past 512, its ``splits``) with
    ``static`` = (C log2(e), STATIC_SHIFT_CLIP log2(e)), the shift and clip in
    the kernels' exp2 units, passed after the scale; None where exact. A
    shift in f16 raises ``ValueError``, on the short-stream kernel
    ``NotImplementedError``: no instance, no fallback (a head dim past 2048
    raises ``NotImplementedError`` whatever the shift, :func:`padded_head_dim`).
    Nothing here needs a device."""
    mode = AttnMode(mode)
    B, H, Sq, D = q.shape
    if q.dtype not in KERNEL_ENTRIES:
        raise NotImplementedError(f"the flash kernels take bf16, f16 or f32; q is {q.dtype}")
    Dp = padded_head_dim(D, mode, q.dtype)
    if takes_d512_self(D, mode, q.dtype):
        raise NotImplementedError(f"head dim {D} pads to {Dp} in self mode: the D={D512} self-attention kernels take "
                                  "it (d512_operands), not this one")
    if k.dim() != 4 or k.shape[:2] != (B, H) or k.shape[-1] != D or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if Sq == 0 or k.shape[2] == 0:
        raise ValueError("empty query or key sequence")
    dev = q.device
    coef_t = skip = None
    if mode == AttnMode.SELF:  # no coefficient, skip row or endpoint tensor is made
        eps = [k, v, k, v]
    else:
        eps = [k[0] if k_begin is None else k_begin, v[0] if k_begin is None else v_begin,
               k[-1] if k_end is None else k_end, v[-1] if k_end is None else v_end]
        if any(e is None for e in eps):
            raise ValueError("pass endpoint K and V together")
        Le = eps[0].shape[-2]
        for i, (name, e) in enumerate(zip(("k_begin", "v_begin", "k_end", "v_end"), eps)):
            if e.dim() not in (3, 4) or e.shape[-3:] != (H, Le, D) or (e.dim() == 4 and e.shape[0] != B):
                raise ValueError(f"{name} shape {tuple(e.shape)}: want (H, Le, D) or (B, H, Le, D) with Le={Le}")
            if e.dim() == 4 and e.stride(0) == 0:  # one endpoint broadcast over the rows: pass it shared
                eps[i] = e[0]
        coef_t = (torch.zeros(B, dtype=torch.float32, device=dev) if coef is None
                  else coef.to(device=dev, dtype=torch.float32).reshape(B).contiguous())
        if mode.is_inner:
            # the lerped cross endpoint is made in f32 and stored in the input
            # dtype, as pack_stream does on the TPU; it rides the begin slot
            c = coef_t.reshape(B, 1, 1, 1)

            def lerped(e0, e1):
                return ((1.0 - c) * e0.float() + c * e1.float()).to(q.dtype).contiguous()

            eps[0], eps[1] = lerped(eps[0], eps[2]), lerped(eps[1], eps[3])
            eps[2], eps[3] = eps[0], eps[1]
        if skip_endpoints is not None and mode.is_fused:
            skip = torch.as_tensor(skip_endpoints, device=dev).reshape(B).to(torch.bool).contiguous()

    tensors = [q, k, v, *eps]
    if Dp != D:  # one padded copy per distinct tensor (self mode's slots repeat k and v)
        padded = {}
        for x in tensors:
            if id(x) not in padded:
                padded[id(x)] = _pad_head_dim(x, Dp)
        tensors = [padded[id(x)] for x in tensors]
    names = ("q", "k", "v", "k_begin", "v_begin", "k_end", "v_end")
    checked = set()
    for name, x in zip(names, tensors):
        if id(x) in checked:
            continue
        checked.add(id(x))
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
        _check_operand(name, x, q.dtype)
    out = torch.empty((B, Sq, H, Dp), dtype=q.dtype, device=dev).transpose(1, 2)
    tensors.append(out)
    dims = [B, H, Sq, k.shape[2], tensors[3].shape[-2], Dp]
    for x in tensors:
        dims += _bhs_strides(x)
    work, splits = None, 1
    has_own = int(mode in (AttnMode.SELF, AttnMode.FUSED_OUTER, AttnMode.FUSED_INNER))
    n_sets = 2 if mode.is_outer else (1 if mode.is_inner else 0)
    if KERNEL_HEAD_DIMS[-1] < Dp <= D512 and mode.is_outer:  # the parked first softmax set of each 64-row tile
        t = dmid_tiles(Dp, q.dtype, B, H, Sq)
        work = torch.empty((t["work_tiles"], t["park_words"], t["park_threads"]), dtype=torch.float32, device=dev)
    elif Dp > D512:  # each split's state (O, m, l) per softmax set, the outer modes' parked sets among them
        Dk, BQ, BK = dwide_tiles(Dp, q.dtype)
        blocks = B * H * -(-Sq // BQ)
        splits = dwide_split(blocks, has_own * -(-k.shape[2] // BK) + n_sets * -(-dims[4] // BK))
        if mode.is_outer or splits > 1:
            work = torch.empty((blocks * splits, 2 if mode.is_outer else 1, BQ * Dk + 2 * BQ), dtype=torch.float32,
                               device=dev)
    entry = (DWIDE_ENTRIES if Dp > D512 else DMID_ENTRIES if Dp > KERNEL_HEAD_DIMS[-1] else KERNEL_ENTRIES)[q.dtype]
    if onepass and (q.dtype not in ONEPASS_ENTRIES or onepass_tiles(Dp, k.shape[2], dims[4], mode) is None):
        raise NotImplementedError(f"the short-stream kernel does not take a {q.dtype} call at D={Dp} over "
                                  f"{k.shape[2]} own and {dims[4]} endpoint keys in {mode.value} mode")
    if midstream and (onepass or q.dtype not in MIDSTREAM_ENTRIES or Dp not in MIDSTREAM_TILES):
        raise NotImplementedError(f"the mid-length stream kernel does not take a {q.dtype} call at D={Dp} in "
                                  f"{mode.value} mode{' sent to the short-stream kernel' if onepass else ''}")
    if midstream:  # forced there, whatever the stream's length
        onepass = False
    static = None
    if static_smax is not None:  # the static-shift instances: the streaming, bf16 mid-length, D=161-512 and wide ones
        static = _static_log2(static_smax, q.dtype)
        if onepass:
            raise NotImplementedError("the short-stream kernel has no static-shift instance (its calls take the "
                                      "streaming kernel's)")
        if midstream and (q.dtype not in STATIC_MIDSTREAM_ENTRIES or Dp not in STATIC_MIDSTREAM_DIMS
                          or mode == AttnMode.SELF):
            raise NotImplementedError(f"the mid-length stream kernel has no static-shift instance for a {q.dtype} "
                                      f"call at D={Dp} in {mode.value} mode")
        onepass = False
        if Dp > D512:
            midstream, entry = False, STATIC_DWIDE_ENTRIES[q.dtype]
        elif Dp > KERNEL_HEAD_DIMS[-1]:
            midstream, entry = False, STATIC_DMID_ENTRIES[q.dtype]
        else:
            if midstream is None:
                midstream = static_route(Dp, Sq, k.shape[2], dims[4], mode, q.dtype) == "midstream"
            entry = (STATIC_MIDSTREAM_ENTRIES if midstream else STATIC_ENTRIES)[q.dtype]
    onepass = takes_onepass(Dp, Sq, k.shape[2], dims[4], mode, q.dtype) if onepass is None else onepass
    midstream = (not onepass and takes_midstream(Dp, Sq, k.shape[2], dims[4], mode, q.dtype) if midstream is None
                 else midstream)
    if static is None and onepass:
        entry = ONEPASS_ENTRIES[q.dtype]
    elif static is None and midstream:
        entry = MIDSTREAM_ENTRIES[q.dtype]
    return dict(entry=entry, onepass=onepass, midstream=midstream, static=static, tensors=tensors, dims=dims,
                coef=coef_t, skip=skip, work=work, splits=splits, scale=D ** -0.5 if scale is None else scale,
                has_own=has_own, n_sets=n_sets, head_dim=D, out=out[..., :D])


_DIMS_ARRAYS: dict = {}


def _dims_array(dims: list):
    """The C entry's dims as a ctypes array, one per distinct dims: a model
    calls the kernel at a few shapes, and building the array took an eighth
    of the wrapper's host work. The C side only reads it."""
    key = tuple(dims)
    arr = _DIMS_ARRAYS.get(key)
    if arr is None:
        if len(_DIMS_ARRAYS) >= 1024:
            _DIMS_ARRAYS.clear()
        arr = _DIMS_ARRAYS[key] = (ctypes.c_longlong * len(key))(*key)
    return arr


def kernel_launch(*args, **kwargs) -> tuple:
    """:func:`kernel_operands` on CUDA tensors, prepared for launching:
    returns ``(out, launch)``, where ``launch()`` runs the kernel into
    ``out`` on the current stream, as often as it is called. Counts
    nothing: the wrapper counts its launches."""
    ops = kernel_operands(*args, **kwargs)
    tensors, out = ops["tensors"], ops["out"]

    from aid_tpu_torch.ops import _build

    lib = _build.library()
    # the entries past 160 take the workspace pointer (null where nothing is parked or split) after skip
    work = ((None if ops["work"] is None else ops["work"].data_ptr(),) if ops["dims"][5] > KERNEL_HEAD_DIMS[-1]
            else ())
    # the static-shift entries take the shift and the clip (log2 units) after the scale
    c_args = (*(x.data_ptr() for x in tensors),
              *(None if x is None else x.data_ptr() for x in (ops["coef"], ops["skip"])), *work,
              _dims_array(ops["dims"]), float(ops["scale"]), *(ops["static"] or ()), ops["has_own"],
              ops["n_sets"], torch.cuda.current_stream(out.device).cuda_stream)

    fn = getattr(lib, ops["entry"])

    def launch() -> None:
        _build.check(fn(*c_args), f"{ops['entry']} launch")

    launch.operands = ops  # the pointers in c_args stay valid while launch lives
    return out, launch


def _launch_counted(wrapper, q, *args, **kwargs) -> torch.Tensor:
    """One launch of the interpolating kernel of ``wrapper``'s dtype
    (:data:`_WRAPPER_DTYPES`; q checked here, the rest by kernel_operands)
    and of the call's padded head dim, counted on ``wrapper`` in all, under
    the instance's head dim (40, 64, 80, 160, 512 or :data:`DWIDE`) and,
    where the short-stream kernel took it, in ``launches_onepass`` under
    that head dim too, where the mid-length stream kernel took it, in
    ``launches_midstream``; a static-shift instance's launches count apart
    from those in ``launches_static`` (the streaming kernel's),
    ``launches_static_midstream``, ``launches_static_dmid`` (the D=161-512
    kernels', by the operands' head dim) and ``launches_static_dwide`` (the
    wide kernels', by the instance's padded head dim, :func:`dwide_tiles`)."""
    _check_dtype("q", q, _WRAPPER_DTYPES[wrapper.__name__])
    out, launch = kernel_launch(q, *args, **kwargs)
    launch()
    ops = launch.operands
    Dp = ops["dims"][5]
    wrapper.launches += 1
    wrapper.launches_by_head_dim[instance_head_dim(Dp)] += 1
    if ops["static"] is not None and Dp > D512:
        Dk = dwide_tiles(Dp, q.dtype)[0]
        wrapper.launches_static_dwide[Dk] += 1
    elif ops["static"] is not None and Dp > KERNEL_HEAD_DIMS[-1]:
        wrapper.launches_static_dmid[Dp] = wrapper.launches_static_dmid.get(Dp, 0) + 1
    elif ops["static"] is not None:
        (wrapper.launches_static_midstream if ops["midstream"] else wrapper.launches_static)[Dp] += 1
    elif ops["onepass"]:
        wrapper.launches_onepass[Dp] += 1
    elif ops["midstream"]:
        wrapper.launches_midstream[Dp] += 1
    return out


#: the dtype each counting wrapper launches its kernel for
_WRAPPER_DTYPES = {
    "flash_interpolated_attention": torch.bfloat16, "flash_interpolated_attention_f16": torch.float16,
    "flash_interpolated_attention_f32": torch.float32, "flash_self_attention_bf16": torch.bfloat16,
    "flash_self_attention_f16": torch.float16, "flash_self_attention_f32": torch.float32,
}


def flash_interpolated_attention(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, H, Lk, D)
    v: torch.Tensor,
    coef: Optional[torch.Tensor] = None,  # (B,); not read in self mode
    mode: AttnMode | str = AttnMode.SELF,
    k_begin: Optional[torch.Tensor] = None,  # (H, Le, D) shared or (B, H, Le, D) per row; default k[0]
    v_begin: Optional[torch.Tensor] = None,
    k_end: Optional[torch.Tensor] = None,  # default k[-1]
    v_end: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    skip_endpoints: Optional[torch.Tensor] = None,  # (B,) bool: rows whose endpoint segments are dropped
    static_smax=None,  # None (exact), a float C, or "auto": see resolve_static_smax
) -> torch.Tensor:
    """Flash interpolated attention (see module docstring).

    ``skip_endpoints`` is honoured in fused modes only: those rows attend
    their own K/V alone, which is vanilla attention. Pure modes ignore it.
    ``static_smax`` (aid_tpu/ops/flash_attention.py:44-65, 728-746): None,
    the default, is the exact softmax; a float C the static shift, computed
    by the plain version on any device and on CUDA by the static-shift
    instance (bf16 and f32: at head dims up to 160 a bf16 call the
    mid-length stream kernel takes in an endpoint mode at D = 64 on its
    instance, every other on the streaming kernel's; from 161 to 512 the
    D=161-512 kernels' instance, self mode past the dtype's
    :data:`DMID_SELF_MAX` the D=512 self kernels'; from 513 to 2048 the wide
    kernels' instance; in f16 ``ValueError``); ``"auto"`` as
    :func:`resolve_static_smax` resolves it.
    Returns (B, H, Sq, D) in q's dtype; on CUDA the result is a view of a
    (B, Sq, H, D) buffer, so merging heads afterwards needs no copy.
    """
    mode = AttnMode(mode)
    shift = resolve_static_smax(q, k, mode, k_begin, k_end, v_begin, v_end, static_smax)
    if not use_kernel(q, k, v):
        return flash_interpolated_attention_plain(
            q, k, v, coef, mode, k_begin=k_begin, v_begin=v_begin, k_end=k_end, v_end=v_end,
            scale=scale, skip_endpoints=skip_endpoints, static_smax=shift)

    if takes_d512_self(q.shape[-1], mode, q.dtype):  # the D=512 kernels (the VAE's), padded to 512 past DMID_SELF_MAX
        d512 = {torch.float32: flash_self_attention_f32, torch.bfloat16: flash_self_attention_bf16,
                torch.float16: flash_self_attention_f16}[q.dtype]
        return d512(q, k, v, scale, static_smax=shift)
    other = {torch.float32: flash_interpolated_attention_f32, torch.float16: flash_interpolated_attention_f16}
    if q.dtype in other:
        return other[q.dtype](q, k, v, coef, mode, k_begin=k_begin, v_begin=v_begin, k_end=k_end, v_end=v_end,
                              scale=scale, skip_endpoints=skip_endpoints, static_smax=shift)

    return _launch_counted(flash_interpolated_attention, q, k, v, coef, mode, k_begin=k_begin, v_begin=v_begin,
                           k_end=k_end, v_end=v_end, scale=scale, skip_endpoints=skip_endpoints, static_smax=shift)


def flash_interpolated_attention_f32(
    q: torch.Tensor,  # (B, H, Sq, D) f32, D in KERNEL_HEAD_DIMS
    k: torch.Tensor,  # (B, H, Lk, D)
    v: torch.Tensor,
    coef: Optional[torch.Tensor] = None,  # (B,); not read in self mode
    mode: AttnMode | str = AttnMode.SELF,
    k_begin: Optional[torch.Tensor] = None,  # (H, Le, D) shared or (B, H, Le, D) per row; default k[0]
    v_begin: Optional[torch.Tensor] = None,
    k_end: Optional[torch.Tensor] = None,  # default k[-1]
    v_end: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    skip_endpoints: Optional[torch.Tensor] = None,  # (B,) bool: rows whose endpoint segments are dropped
    static_smax=None,  # None (exact), a float C, or "auto": see resolve_static_smax
) -> torch.Tensor:
    """:func:`flash_interpolated_attention`'s contract in f32 at head dim
    40, 64, 80 or 160, every mode (an f32 UNet's attentions), and at any
    other head dim up to 160 padded to the next of those:
    ``csrc/flash_interpolated_attention_f32.cu`` (both products in 3xTF32
    on wgmma; at D = 160 two warpgroups split D) on CUDA tensors, the plain
    version on CPU tensors. A head dim from 161 to 512 in an endpoint mode
    (in self mode to 448, :data:`DMID_SELF_MAX`) takes
    ``aid_flash_attn_f32_dmid`` (``csrc/flash_attention_dmid_f32.cu``, at
    the caller's D); one from 513 to 2048, in every mode,
    ``aid_flash_attn_f32_dwide`` (``csrc/flash_attention_dwide.cu``). A
    shift (``static_smax``, as in :func:`flash_interpolated_attention`) takes
    ``aid_flash_attn_f32_static`` at head dims up to 160,
    ``aid_flash_attn_f32_dmid_static`` from 161 to 512,
    ``aid_flash_attn_f32_dwide_static`` from 513 to 2048 (under ``"auto"``
    to 1024 only, as the JAX wrapper takes f32). Returns (B, H, Sq,
    D) f32; on CUDA a view of a (B, Sq, H, Dp) buffer, as the bf16 kernel
    writes.
    """
    mode = AttnMode(mode)
    shift = resolve_static_smax(q, k, mode, k_begin, k_end, v_begin, v_end, static_smax)
    if not use_kernel(q, k, v):
        return flash_interpolated_attention_plain(
            q, k, v, coef, mode, k_begin=k_begin, v_begin=v_begin, k_end=k_end, v_end=v_end,
            scale=scale, skip_endpoints=skip_endpoints, static_smax=shift)
    return _launch_counted(flash_interpolated_attention_f32, q, k, v, coef, mode, k_begin=k_begin, v_begin=v_begin,
                           k_end=k_end, v_end=v_end, scale=scale, skip_endpoints=skip_endpoints,
                           static_smax=shift)


def flash_interpolated_attention_f16(
    q: torch.Tensor,  # (B, H, Sq, D) f16
    k: torch.Tensor,  # (B, H, Lk, D)
    v: torch.Tensor,
    coef: Optional[torch.Tensor] = None,  # (B,); not read in self mode
    mode: AttnMode | str = AttnMode.SELF,
    k_begin: Optional[torch.Tensor] = None,  # (H, Le, D) shared or (B, H, Le, D) per row; default k[0]
    v_begin: Optional[torch.Tensor] = None,
    k_end: Optional[torch.Tensor] = None,  # default k[-1]
    v_end: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    skip_endpoints: Optional[torch.Tensor] = None,  # (B,) bool: rows whose endpoint segments are dropped
    static_smax=None,  # None (exact), a float C, or "auto": see resolve_static_smax
) -> torch.Tensor:
    """:func:`flash_interpolated_attention`'s contract in f16 at head dim
    40, 64, 80 or 160, every mode (an f16 UNet's attentions), and at any
    other head dim up to 160 padded to the next of those: the f16 instance
    of ``csrc/flash_interpolated_attention.cu`` (``aid_flash_attn_f16``:
    the bf16 design with f16 wgmma, f32 scores, softmax and accumulation,
    P rounded to f16) on CUDA tensors, the plain version on CPU tensors. A
    head dim from 161 to 512 in an endpoint mode (in self mode to 511,
    :data:`DMID_SELF_MAX`) takes ``aid_flash_attn_f16_dmid`` (at the
    caller's D); one from 513 to 2048, in every mode,
    ``aid_flash_attn_f16_dwide``. No static-shift instance: a float
    ``static_smax`` raises ``ValueError`` (exp(-40) flushes to 0 in f16),
    ``"auto"`` is exact. Returns (B, H, Sq, D) f16; on CUDA a view of a (B,
    Sq, H, Dp) buffer.
    """
    mode = AttnMode(mode)
    shift = resolve_static_smax(q, k, mode, k_begin, k_end, v_begin, v_end, static_smax)
    if not use_kernel(q, k, v):
        return flash_interpolated_attention_plain(
            q, k, v, coef, mode, k_begin=k_begin, v_begin=v_begin, k_end=k_end, v_end=v_end,
            scale=scale, skip_endpoints=skip_endpoints, static_smax=shift)
    return _launch_counted(flash_interpolated_attention_f16, q, k, v, coef, mode, k_begin=k_begin, v_begin=v_begin,
                           k_end=k_end, v_end=v_end, scale=scale, skip_endpoints=skip_endpoints,
                           static_smax=shift)


def reset_launch_counts() -> None:
    """Set the interpolating kernels' launch counts (bf16, f16 and f32, total
    and per instance head dim, 512 the D=161-512 entries,
    :data:`DWIDE` the wide entries: a padded call counts under the instance
    that takes it; and the short-stream and the mid-length stream kernels'
    launches and the static-shift instances' (the streaming kernel's and the
    mid-length stream kernel's), parts of those at D <= 160, by head dim,
    the D=161-512 kernels', by the operands' head dim, and the wide
    kernels', by the instance's padded head dim) to 0, and the D=512 self
    wrappers' static-shift launches."""
    for fn in (flash_interpolated_attention, flash_interpolated_attention_f16, flash_interpolated_attention_f32):
        fn.launches = 0
        fn.launches_by_head_dim = dict.fromkeys((*KERNEL_HEAD_DIMS, D512, DWIDE), 0)
        fn.launches_onepass = dict.fromkeys(KERNEL_HEAD_DIMS, 0)
        fn.launches_midstream = dict.fromkeys(KERNEL_HEAD_DIMS, 0)
        fn.launches_static = dict.fromkeys(KERNEL_HEAD_DIMS, 0)
        fn.launches_static_midstream = dict.fromkeys(KERNEL_HEAD_DIMS, 0)
        fn.launches_static_dmid = {}
        fn.launches_static_dwide = dict.fromkeys(DWIDE_PADDED, 0)
    for fn in (flash_self_attention_f32, flash_self_attention_bf16, flash_self_attention_f16):
        fn.launches_static = 0


#: kernel launches since the last reset, in all, by head dim and on the
#: short-stream and mid-length stream kernels, of the bf16, the f16 and the
#: f32 interpolating kernels (chip_smoke.py reads them around each path)
reset_launch_counts()
