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
    ``csrc/flash_interpolated_attention_f32.cu`` (3xTF32), reached through
    :func:`flash_interpolated_attention_f32` and counted by its
    ``launches`` and ``launches_by_head_dim``;
  * f32 with head dim 512, self mode (the VAE mid-block attention, one head
    over 4096 tokens at 512px, 16384 at 1024px):
    ``csrc/flash_attention_f32_d512.cu``, reached through
    :func:`flash_self_attention_f32` and counted by its ``launches``;
  * bf16 with head dim 512, self mode (the same attention in a bf16 VAE):
    ``csrc/flash_attention_bf16_d512.cu``, reached through
    :func:`flash_self_attention_bf16` and counted by its ``launches``.
Any other dtype, head dim or mode on a CUDA tensor raises
``NotImplementedError`` (ROADMAP Queue 2 lists the instances still to port).
:func:`kernel_operands` checks the operands of the D <= 160 kernels (bf16 or
f32, one C signature) and lays out their C entry's arguments (the CPU tests
replay the kernels' data movement from them); :func:`kernel_launch` and, for
the D=512 kernels, :func:`d512_launch` return the launch itself, which
``chip_smoke.py`` times apart from the wrapper's host work.
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
#: the f32 kernel's tiles by head dim: (keys per K/V tile, row pitch of Q and
#: K, row pitch of V, in floats), csrc/flash_interpolated_attention_f32.cu's
#: Tiles<D>; every block holds 64 query rows, 16 a warp.
KERNEL_F32_TILES = {40: (64, 40, 44), 64: (64, 72, 68), 80: (64, 88, 84), 160: (32, 168, 164)}
KERNEL_F32_ROWS = 64
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


def _check_operand(name: str, x: torch.Tensor, dtype=torch.bfloat16, head_dims=KERNEL_HEAD_DIMS) -> None:
    if x.dtype != dtype:
        raise NotImplementedError(f"flash kernel takes {dtype} here; {name} is {x.dtype} "
                                  "(ROADMAP Queue 2 lists the instances still to port)")
    if x.shape[-1] not in head_dims:
        raise NotImplementedError(f"flash kernel takes head dims {head_dims} here; {name} has {x.shape[-1]} "
                                  "(ROADMAP Queue 2 lists the instances still to port)")
    strides = x.stride()
    if strides[-1] != 1:
        raise ValueError(f"{name}: the head dim must be contiguous, strides {strides}")
    per_16_bytes = 16 // x.element_size()
    if any(s % per_16_bytes for s in strides[:-1]) or x.data_ptr() % 16:
        raise ValueError(f"{name}: 16-byte row alignment needed, strides {strides}")


def d512_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None) -> tuple:
    """The D=512 self-attention kernel of q's dtype (f32: ``csrc/
    flash_attention_f32_d512.cu``, bf16: ``csrc/flash_attention_bf16_d512.cu``)
    prepared for launching on CUDA tensors: checks the operands, allocates
    the output and returns ``(out, launch)``, where ``launch()`` runs the
    kernel into ``out`` on the current stream, as often as it is called.
    Counts nothing: the wrappers count their launches."""
    B, H, Sq, D = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"the D={D512} self-attention kernels take f32 or bf16; q is {q.dtype} "
                                  "(ROADMAP Queue 2 lists the instances still to port)")
    if k.dim() != 4 or k.shape[:2] != (B, H) or k.shape[-1] != D or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, q.dtype, (D512,))
    if Sq == 0 or k.shape[2] == 0:
        raise ValueError("empty query or key sequence")
    if q.dtype == torch.float32:
        entry, out = "aid_flash_attn_f32_d512", torch.empty(q.shape, dtype=q.dtype, device=q.device)
    else:  # a view of a (B, Sq, H, D) buffer, as the other bf16 kernel writes
        entry, out = "aid_flash_attn_bf16_d512", torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    dims = [B, H, Sq, k.shape[2]]
    for x in (q, k, v, out):
        dims += _bhs_strides(x)

    from aid_tpu_torch.ops import _build

    fn = getattr(_build.library(), entry)
    c_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), (ctypes.c_longlong * len(dims))(*dims),
              float(D ** -0.5 if scale is None else scale), torch.cuda.current_stream(q.device).cuda_stream)

    def launch() -> None:
        _build.check(fn(*c_args), f"{entry} launch")

    launch.operands = (q, k, v, out)  # the pointers in c_args stay valid while launch lives
    return out, launch


def flash_self_attention_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v in f32 with head dim 512 (the VAE mid-block
    contract): ``csrc/flash_attention_f32_d512.cu`` on CUDA tensors, the
    plain ``_softmax_attn`` on CPU tensors.

    q: (B, H, Sq, 512), k/v: (B, H, Lk, 512), all f32. Returns (B, H, Sq, 512) f32.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not use_kernel(q, k, v):
        return _softmax_attn(q, k, v, scale)
    _check_operand("q", q, torch.float32, (D512,))
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
    probabilities rounded to bf16 before P V) on CPU tensors.

    q: (B, H, Sq, 512), k/v: (B, H, Lk, 512), all bf16. Returns (B, H, Sq,
    512) bf16; on CUDA a view of a (B, Sq, H, 512) buffer, as the other bf16
    kernel writes.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not use_kernel(q, k, v):
        return _softmax_attn(q, k, v, scale)
    _check_operand("q", q, torch.bfloat16, (D512,))
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
    (B, H, Sq, D) view of a new (B, Sq, H, D) buffer), ``dims`` (the entry's
    30 shape and stride values), ``coef`` and ``skip`` (None where the mode
    reads neither), ``scale``, ``has_own`` and ``n_sets``. Self mode reads
    no endpoint: its slots repeat k and v. Nothing here needs a device."""
    mode = AttnMode(mode)
    B, H, Sq, D = q.shape
    if q.dtype not in KERNEL_ENTRIES:
        raise NotImplementedError(f"the flash kernels take bf16 or f32 at head dims {KERNEL_HEAD_DIMS}; q is "
                                  f"{q.dtype} (ROADMAP Queue 2 lists the instances still to port)")
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
    names = ("q", "k", "v", "k_begin", "v_begin", "k_end", "v_end")
    for i, (name, x) in enumerate(zip(names, tensors)):
        if any(x is y for y in tensors[:i]):
            continue  # checked already
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
        _check_operand(name, x, q.dtype)
    tensors.append(torch.empty((B, Sq, H, D), dtype=q.dtype, device=dev).transpose(1, 2))
    dims = [B, H, Sq, k.shape[2], tensors[3].shape[-2], D]
    for x in tensors:
        dims += _bhs_strides(x)
    return dict(entry=KERNEL_ENTRIES[q.dtype], tensors=tensors, dims=dims, coef=coef_t, skip=skip,
                scale=D ** -0.5 if scale is None else scale,
                has_own=int(mode in (AttnMode.SELF, AttnMode.FUSED_OUTER, AttnMode.FUSED_INNER)),
                n_sets=2 if mode.is_outer else (1 if mode.is_inner else 0))


def kernel_launch(*args, **kwargs) -> tuple:
    """:func:`kernel_operands` on CUDA tensors, prepared for launching:
    returns ``(out, launch)``, where ``launch()`` runs the kernel into
    ``out`` on the current stream, as often as it is called. Counts
    nothing: the wrapper counts its launches."""
    ops = kernel_operands(*args, **kwargs)
    tensors, out = ops["tensors"], ops["tensors"][-1]

    from aid_tpu_torch.ops import _build

    lib = _build.library()
    c_args = (*(x.data_ptr() for x in tensors),
              *(None if x is None else x.data_ptr() for x in (ops["coef"], ops["skip"])),
              (ctypes.c_longlong * len(ops["dims"]))(*ops["dims"]), float(ops["scale"]), ops["has_own"],
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

    if mode == AttnMode.SELF and q.shape[-1] == D512:
        if q.dtype == torch.float32:
            return flash_self_attention_f32(q, k, v, scale)
        if q.dtype == torch.bfloat16:
            return flash_self_attention_bf16(q, k, v, scale)
    if q.dtype == torch.float32:
        return flash_interpolated_attention_f32(q, k, v, coef, mode, k_begin=k_begin, v_begin=v_begin, k_end=k_end,
                                                v_end=v_end, scale=scale, skip_endpoints=skip_endpoints)

    _check_operand("q", q)  # bf16 from here on; kernel_operands checks the rest
    out, launch = kernel_launch(q, k, v, coef, mode, k_begin=k_begin, v_begin=v_begin, k_end=k_end, v_end=v_end,
                                scale=scale, skip_endpoints=skip_endpoints)
    launch()
    flash_interpolated_attention.launches += 1
    flash_interpolated_attention.launches_by_head_dim[q.shape[-1]] += 1
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
    40, 64, 80 or 160, every mode (an f32 UNet's attentions):
    ``csrc/flash_interpolated_attention_f32.cu`` (both products in 3xTF32)
    on CUDA tensors, the plain version on CPU tensors. Returns (B, H, Sq, D)
    f32; on CUDA a view of a (B, Sq, H, D) buffer, as the bf16 kernel writes.
    """
    mode = AttnMode(mode)
    if not use_kernel(q, k, v):
        return flash_interpolated_attention_plain(
            q, k, v, coef, mode, k_begin=k_begin, v_begin=v_begin, k_end=k_end, v_end=v_end,
            scale=scale, skip_endpoints=skip_endpoints)
    _check_operand("q", q, torch.float32)
    out, launch = kernel_launch(q, k, v, coef, mode, k_begin=k_begin, v_begin=v_begin, k_end=k_end, v_end=v_end,
                                scale=scale, skip_endpoints=skip_endpoints)
    launch()
    flash_interpolated_attention_f32.launches += 1
    flash_interpolated_attention_f32.launches_by_head_dim[q.shape[-1]] += 1
    return out


def reset_launch_counts() -> None:
    """Set the D <= 160 kernels' launch counts (bf16 and f32, total and per
    head dim) to 0."""
    for fn in (flash_interpolated_attention, flash_interpolated_attention_f32):
        fn.launches = 0
        fn.launches_by_head_dim = dict.fromkeys(KERNEL_HEAD_DIMS, 0)


#: kernel launches since the last reset, in all and by head dim, of the bf16
#: and the f32 kernel (chip_smoke.py reads them around each path)
reset_launch_counts()
