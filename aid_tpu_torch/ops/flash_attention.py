"""Flash interpolated attention: the hand-written Hopper kernel and its plain version.

``flash_interpolated_attention`` computes the contract of
``aid_tpu.ops.flash_attention.flash_interpolated_attention``
(aid_tpu/ops/flash_attention.py:683-1061). On a CUDA tensor it launches
``csrc/flash_interpolated_attention.cu``, which replaces both Pallas TPU
kernels behind that function (``_kernel``, flash_attention.py:101, and
``_kernel_onepass``, flash_attention.py:339); the source's header says what
bounds it on the card and how the design answers. On a CPU tensor it runs
:func:`flash_interpolated_attention_plain`.

Four kernels take CUDA calls:
  * bf16 with head dim 40, 64, 80 or 160, every mode (every UNet attention:
    64 for SDXL and SD2.x, 40/80/160 for SD1.x's 8 heads at widths
    320/640/1280): ``csrc/flash_interpolated_attention.cu``, counted by
    ``flash_interpolated_attention.launches`` and, per head dim, by
    ``flash_interpolated_attention.launches_by_head_dim``;
  * f32 with head dim 40, 64, 80 or 160, every mode (the same attentions in
    an f32 UNet, the reference's default dtype): the same C signature in
    ``csrc/flash_interpolated_attention_f32.cu`` (3xTF32; wgmma on TMA tiles
    that a producer warpgroup splits and transposes; at D = 160 two
    consumer warpgroups split D and exchange partial scores), reached
    through :func:`flash_interpolated_attention_f32` and counted by its
    ``launches`` and ``launches_by_head_dim``;
  * f32 with head dim 512, self mode (the VAE mid-block attention, one head
    over 4096 tokens at 512px, 16384 at 1024px):
    ``csrc/flash_attention_f32_d512.cu``, reached through
    :func:`flash_self_attention_f32` and counted by its ``launches``;
  * bf16 with head dim 512, self mode (the same attention in a bf16 VAE):
    ``csrc/flash_attention_bf16_d512.cu`` (wgmma on TMA tiles, D split
    across two consumer warpgroups), reached through
    :func:`flash_self_attention_bf16` and counted by its ``launches``.
A head dim that no instance takes is zero-padded to the next that does,
as the JAX package pads (aid_tpu/ops/flash_attention.py:784, 800-801):
below 160 to the next of 40, 64, 80, 160 in every mode, between 160 and
512 to 512 in self mode; the scale stays the unpadded D's and the output
is sliced back. Zero columns add nothing to Q K^T, and V's are cut off, so
the padding is exact; it costs one copy of each operand, on calls that no
full-size model makes, and the launch counts book such calls under the
padded head dim. Any other dtype (f16), a head dim over 160 outside self
mode or over 512 raises ``NotImplementedError`` on a CUDA tensor (ROADMAP
Queue 2 lists the instances still to port). :func:`kernel_operands` checks
the operands of the D <= 160 kernels (bf16 or f32, one C signature), pads
them and lays out their C entry's arguments (the CPU tests replay the
kernels' data movement from them), :func:`d512_operands` those of the
D=512 kernels; :func:`kernel_launch` and :func:`d512_launch` return the
launch itself, which ``chip_smoke.py`` times apart from the wrapper's host
work.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from aid_tpu_torch.ops.attention import AttnMode, _softmax_attn, interpolated_attention
from aid_tpu_torch.ops.routing import use_kernel

KERNEL_HEAD_DIMS = (40, 64, 80, 160)
D512 = 512  # the VAE mid block's head dim: the self-mode kernels in f32 and bf16
#: the bf16 kernel's tiles by head dim: (query rows per block, keys per K/V
#: tile, K/V stages in its ring), csrc/flash_interpolated_attention.cu's
#: Tiles<D>: one consumer warpgroup per 64 query rows.
KERNEL_TILES = {40: (192, 128, 3), 64: (192, 128, 3), 80: (128, 128, 2), 160: (64, 64, 3)}
#: the f32 kernel's instances by head dim: (query rows per block, keys per
#: K/V tile, stages in its ring), csrc/flash_interpolated_attention_f32.cu's
#: Tiles<D>: one consumer warpgroup per 64 query rows and
#: KERNEL_F32_D_SPLIT[D] of them, each over D / KERNEL_F32_D_SPLIT[D]
#: columns (its Cfg<D>::kSplit).
KERNEL_F32_TILES = {40: (192, 32, 4), 64: (128, 64, 2), 80: (128, 32, 3), 160: (64, 16, 3)}
KERNEL_F32_D_SPLIT = {40: 1, 64: 1, 80: 1, 160: 2}
#: the C entry of the D <= 160 kernels by operand dtype (one C signature)
KERNEL_ENTRIES = {torch.bfloat16: "aid_flash_attn_bf16", torch.float32: "aid_flash_attn_f32"}


def flash_interpolated_attention_plain(
    q, k, v, coef=None, mode: AttnMode | str = AttnMode.SELF,
    k_begin=None, v_begin=None, k_end=None, v_end=None,
    scale: Optional[float] = None, skip_endpoints=None,
) -> torch.Tensor:
    """The kernel's plain PyTorch version: ``interpolated_attention``, with
    fused-mode skip rows replaced by vanilla attention over their own K/V
    (what the kernel computes when it drops their endpoint segments)."""
    mode = AttnMode(mode)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if coef is None and mode != AttnMode.SELF:
        coef = torch.zeros(q.shape[0], dtype=torch.float32, device=q.device)
    out = interpolated_attention(q, k, v, coef, mode, k_begin=k_begin, v_begin=v_begin,
                                 k_end=k_end, v_end=v_end, scale=scale)
    if skip_endpoints is not None and mode.is_fused:
        rows = torch.as_tensor(skip_endpoints, device=q.device).reshape(-1).bool()
        if bool(rows.any()):
            idx = rows.nonzero().reshape(-1)
            out = out.clone()
            out[idx] = _softmax_attn(q[idx], k[idx], v[idx], scale)
    return out


def padded_head_dim(D: int, mode: AttnMode | str = AttnMode.SELF) -> int:
    """The head dim of the instance that takes a call at head dim D: the
    next of :data:`KERNEL_HEAD_DIMS` at or above D up to 160 (every mode),
    :data:`D512` above 160 in self mode. Raises ``NotImplementedError``
    where no instance is wide enough (over 160 outside self mode, over
    512)."""
    for Dp in KERNEL_HEAD_DIMS:
        if D <= Dp:
            return Dp
    if AttnMode(mode) == AttnMode.SELF and D <= D512:
        return D512
    raise NotImplementedError(f"no flash kernel takes head dim {D} in {AttnMode(mode).value} mode: over "
                              f"{KERNEL_HEAD_DIMS[-1]} only self mode pads (to {D512}), and not past {D512} "
                              "(ROADMAP Queue 2 E lists what still raises)")


def _pad_head_dim(x: torch.Tensor, Dp: int) -> torch.Tensor:
    """x zero-padded along its last dim to Dp (a new contiguous tensor), or x."""
    return x if x.shape[-1] == Dp else torch.nn.functional.pad(x, (0, Dp - x.shape[-1]))


def _check_dtype(name: str, x: torch.Tensor, dtype=torch.bfloat16) -> None:
    if x.dtype != dtype:
        raise NotImplementedError(f"flash kernel takes {dtype} here; {name} is {x.dtype} "
                                  "(ROADMAP Queue 2 lists the instances still to port)")


def _check_operand(name: str, x: torch.Tensor, dtype=torch.bfloat16) -> None:
    """x as a kernel reads it: its dtype, a contiguous head dim and 16-byte rows."""
    _check_dtype(name, x, dtype)
    strides = x.stride()
    if strides[-1] != 1:
        raise ValueError(f"{name}: the head dim must be contiguous, strides {strides}")
    per_16_bytes = 16 // x.element_size()
    if any(s % per_16_bytes for s in strides[:-1]) or x.data_ptr() % 16:
        raise ValueError(f"{name}: 16-byte row alignment needed, strides {strides}")


#: the bf16 D=512 kernel's tiles: (query rows per block, keys per K/V tile,
#: slots in each of the K and V rings, consumer warpgroups splitting D),
#: csrc/flash_attention_bf16_d512.cu's kBQ, kBK, kStages and kWG
D512_BF16_TILES = (64, 32, 2, 2)


def d512_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None) -> dict:
    """Check the operands of the D=512 self-attention kernel of q's dtype
    (f32: ``csrc/flash_attention_f32_d512.cu``, bf16: ``csrc/
    flash_attention_bf16_d512.cu``) and lay out one call of its C entry:
    ``entry``, ``tensors`` (q, k, v and the output: f32 (B, H, Sq, 512);
    bf16 a (B, H, Sq, 512) view of a new (B, Sq, H, 512) buffer, as the
    other bf16 kernel writes), ``dims`` (B, H, Sq, Lk, then the (b, h, s)
    element strides of the four), ``scale``, ``head_dim`` (the caller's D)
    and ``out`` (the output at that D). A head dim between 160 and 512 is
    zero-padded to 512, the scale kept at the unpadded D. Nothing here
    needs a device."""
    B, H, Sq, D = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"the D={D512} self-attention kernels take f32 or bf16; q is {q.dtype} "
                                  "(ROADMAP Queue 2 lists the instances still to port)")
    if k.dim() != 4 or k.shape[:2] != (B, H) or k.shape[-1] != D or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if not KERNEL_HEAD_DIMS[-1] < D <= D512:
        raise NotImplementedError(f"the D={D512} self-attention kernels take head dims {KERNEL_HEAD_DIMS[-1] + 1}.."
                                  f"{D512} (padded to {D512}); q has {D} (ROADMAP Queue 2 E lists what still raises)")
    if Sq == 0 or k.shape[2] == 0:
        raise ValueError("empty query or key sequence")
    q, k, v = (_pad_head_dim(x, D512) for x in (q, k, v))
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, q.dtype)
    if q.dtype == torch.float32:
        entry, out = "aid_flash_attn_f32_d512", torch.empty(q.shape, dtype=q.dtype, device=q.device)
    else:
        entry = "aid_flash_attn_bf16_d512"
        out = torch.empty((B, Sq, H, D512), dtype=q.dtype, device=q.device).transpose(1, 2)
    dims = [B, H, Sq, k.shape[2]]
    for x in (q, k, v, out):
        dims += _bhs_strides(x)
    return dict(entry=entry, tensors=(q, k, v, out), dims=dims, scale=float(D ** -0.5 if scale is None else scale),
                head_dim=D, out=out[..., :D])


def d512_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None) -> tuple:
    """:func:`d512_operands` on CUDA tensors, prepared for launching:
    returns ``(out, launch)``, where ``launch()`` runs the kernel into
    ``out`` on the current stream, as often as it is called. Counts
    nothing: the wrappers count their launches."""
    ops = d512_operands(q, k, v, scale)
    entry, out, dims = ops["entry"], ops["out"], ops["dims"]

    from aid_tpu_torch.ops import _build

    fn = getattr(_build.library(), entry)
    c_args = (*(x.data_ptr() for x in ops["tensors"]), (ctypes.c_longlong * len(dims))(*dims), ops["scale"],
              torch.cuda.current_stream(q.device).cuda_stream)

    def launch() -> None:
        _build.check(fn(*c_args), f"{entry} launch")

    launch.operands = ops  # the pointers in c_args stay valid while launch lives
    return out, launch


def flash_self_attention_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v in f32 with head dim 512 (the VAE mid-block
    contract): ``csrc/flash_attention_f32_d512.cu`` on CUDA tensors, the
    plain ``_softmax_attn`` on CPU tensors. On CUDA a head dim between 160
    and 512 pads to 512; one of 160 or less (a tiny VAE's) takes the D <= 160
    kernel in self mode, padded where needed.

    q: (B, H, Sq, D), k/v: (B, H, Lk, D), all f32. Returns (B, H, Sq, D) f32.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not use_kernel(q, k, v):
        return _softmax_attn(q, k, v, scale)
    _check_dtype("q", q, torch.float32)
    if q.shape[-1] <= KERNEL_HEAD_DIMS[-1]:
        return flash_interpolated_attention_f32(q, k, v, scale=scale)
    out, launch = d512_launch(q, k, v, scale)
    launch()
    flash_self_attention_f32.launches += 1
    return out


#: kernel launches since the last reset (chip_smoke.py reads it around each path)
flash_self_attention_f32.launches = 0


def flash_self_attention_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v in bf16 with head dim 512 (the mid-block
    attention of a bf16 VAE): ``csrc/flash_attention_bf16_d512.cu`` on CUDA
    tensors, the plain ``_softmax_attn`` (f32 logits and softmax, the
    probabilities rounded to bf16 before P V) on CPU tensors. On CUDA a head
    dim between 160 and 512 pads to 512; one of 160 or less takes the bf16
    D <= 160 kernel in self mode, padded where needed.

    q: (B, H, Sq, D), k/v: (B, H, Lk, D), all bf16. Returns (B, H, Sq, D)
    bf16; on CUDA a view of a (B, Sq, H, D) buffer, as the other bf16 kernel
    writes (sliced from a padded one where D was padded).
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not use_kernel(q, k, v):
        return _softmax_attn(q, k, v, scale)
    _check_dtype("q", q, torch.bfloat16)
    if q.shape[-1] <= KERNEL_HEAD_DIMS[-1]:
        return flash_interpolated_attention(q, k, v, scale=scale)
    out, launch = d512_launch(q, k, v, scale)
    launch()
    flash_self_attention_bf16.launches += 1
    return out


#: kernel launches since the last reset (chip_smoke.py reads it around each path)
flash_self_attention_bf16.launches = 0


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
) -> dict:
    """Check the operands of the D <= 160 kernel of q's dtype (bf16 or f32)
    and lay out one call of its C entry (``entry``, :data:`KERNEL_ENTRIES`):
    ``tensors`` (q, k, v, k_begin, v_begin, k_end, v_end and the output, a
    (B, H, Sq, Dp) view of a new (B, Sq, H, Dp) buffer), ``dims`` (the
    entry's 30 shape and stride values), ``coef`` and ``skip`` (None where
    the mode reads neither), ``scale``, ``has_own``, ``n_sets``,
    ``head_dim`` (the caller's D) and ``out`` (the output at that D). A head
    dim that no instance takes is zero-padded to the next one, Dp
    (:func:`padded_head_dim`), after the endpoints are made and before the
    layout is checked; the scale stays D's. Self mode reads no endpoint: its
    slots repeat k and v. Nothing here needs a device."""
    mode = AttnMode(mode)
    B, H, Sq, D = q.shape
    if q.dtype not in KERNEL_ENTRIES:
        raise NotImplementedError(f"the flash kernels take bf16 or f32 at head dims {KERNEL_HEAD_DIMS}; q is "
                                  f"{q.dtype} (ROADMAP Queue 2 lists the instances still to port)")
    Dp = padded_head_dim(D, mode)
    if Dp > KERNEL_HEAD_DIMS[-1]:
        raise NotImplementedError(f"head dim {D} pads to {Dp}: the D={D512} self-attention kernels take it "
                                  "(d512_operands), not this one")
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
    return dict(entry=KERNEL_ENTRIES[q.dtype], tensors=tensors, dims=dims, coef=coef_t, skip=skip,
                scale=D ** -0.5 if scale is None else scale,
                has_own=int(mode in (AttnMode.SELF, AttnMode.FUSED_OUTER, AttnMode.FUSED_INNER)),
                n_sets=2 if mode.is_outer else (1 if mode.is_inner else 0), head_dim=D, out=out[..., :D])


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
    c_args = (*(x.data_ptr() for x in tensors),
              *(None if x is None else x.data_ptr() for x in (ops["coef"], ops["skip"])),
              _dims_array(ops["dims"]), float(ops["scale"]), ops["has_own"],
              ops["n_sets"], torch.cuda.current_stream(out.device).cuda_stream)

    fn = getattr(lib, ops["entry"])

    def launch() -> None:
        _build.check(fn(*c_args), f"{ops['entry']} launch")

    launch.operands = ops  # the pointers in c_args stay valid while launch lives
    return out, launch


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
) -> torch.Tensor:
    """Flash interpolated attention (see module docstring).

    ``skip_endpoints`` is honoured in fused modes only: those rows attend
    their own K/V alone, which is vanilla attention. Pure modes ignore it.
    Returns (B, H, Sq, D) in q's dtype; on CUDA the result is a view of a
    (B, Sq, H, D) buffer, so merging heads afterwards needs no copy.
    """
    mode = AttnMode(mode)
    if not use_kernel(q, k, v):
        return flash_interpolated_attention_plain(
            q, k, v, coef, mode, k_begin=k_begin, v_begin=v_begin, k_end=k_end, v_end=v_end,
            scale=scale, skip_endpoints=skip_endpoints)

    if mode == AttnMode.SELF and q.shape[-1] > KERNEL_HEAD_DIMS[-1]:  # the D=512 kernels, padded up to 512
        if q.dtype == torch.float32:
            return flash_self_attention_f32(q, k, v, scale)
        if q.dtype == torch.bfloat16:
            return flash_self_attention_bf16(q, k, v, scale)
    if q.dtype == torch.float32:
        return flash_interpolated_attention_f32(q, k, v, coef, mode, k_begin=k_begin, v_begin=v_begin, k_end=k_end,
                                                v_end=v_end, scale=scale, skip_endpoints=skip_endpoints)

    _check_dtype("q", q)  # bf16 from here on; kernel_operands checks the rest
    out, launch = kernel_launch(q, k, v, coef, mode, k_begin=k_begin, v_begin=v_begin, k_end=k_end, v_end=v_end,
                                scale=scale, skip_endpoints=skip_endpoints)
    launch()
    flash_interpolated_attention.launches += 1
    flash_interpolated_attention.launches_by_head_dim[launch.operands["dims"][5]] += 1
    return out


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
) -> torch.Tensor:
    """:func:`flash_interpolated_attention`'s contract in f32 at head dim
    40, 64, 80 or 160, every mode (an f32 UNet's attentions), and at any
    other head dim up to 160 padded to the next of those:
    ``csrc/flash_interpolated_attention_f32.cu`` (both products in 3xTF32
    on wgmma; at D = 160 two warpgroups split D) on CUDA tensors, the plain
    version on CPU tensors. Returns (B, H, Sq, D) f32; on CUDA a view of a
    (B, Sq, H, Dp) buffer, as the bf16 kernel writes.
    """
    mode = AttnMode(mode)
    if not use_kernel(q, k, v):
        return flash_interpolated_attention_plain(
            q, k, v, coef, mode, k_begin=k_begin, v_begin=v_begin, k_end=k_end, v_end=v_end,
            scale=scale, skip_endpoints=skip_endpoints)
    _check_dtype("q", q, torch.float32)
    out, launch = kernel_launch(q, k, v, coef, mode, k_begin=k_begin, v_begin=v_begin, k_end=k_end, v_end=v_end,
                                scale=scale, skip_endpoints=skip_endpoints)
    launch()
    flash_interpolated_attention_f32.launches += 1
    flash_interpolated_attention_f32.launches_by_head_dim[launch.operands["dims"][5]] += 1
    return out


def reset_launch_counts() -> None:
    """Set the D <= 160 kernels' launch counts (bf16 and f32, total and per
    instance head dim: a padded call counts under the head dim it pads to)
    to 0."""
    for fn in (flash_interpolated_attention, flash_interpolated_attention_f32):
        fn.launches = 0
        fn.launches_by_head_dim = dict.fromkeys(KERNEL_HEAD_DIMS, 0)


#: kernel launches since the last reset, in all and by head dim, of the bf16
#: and the f32 kernel (chip_smoke.py reads them around each path)
reset_launch_counts()
