"""Flash interpolated attention: the hand-written Hopper kernel and its plain version.

``flash_interpolated_attention`` computes the contract of
``aid_tpu.ops.flash_attention.flash_interpolated_attention``
(aid_tpu/ops/flash_attention.py:683-1061). On a CUDA tensor it launches
``csrc/flash_interpolated_attention.cu``, which replaces both Pallas TPU
kernels behind that function (``_kernel``, flash_attention.py:101, and
``_kernel_onepass``, flash_attention.py:339); the source's header says what
bounds it on the card and how the design answers. On a CPU tensor it runs
:func:`flash_interpolated_attention_plain`.

Two kernels take CUDA calls:
  * bf16 with head dim 64, every mode (every SDXL and SD2.x UNet attention):
    ``csrc/flash_interpolated_attention.cu``, counted by
    ``flash_interpolated_attention.launches``;
  * f32 with head dim 512, self mode (the VAE mid-block attention, one head
    over 16384 tokens at 1024px): ``csrc/flash_attention_f32_d512.cu``,
    reached through :func:`flash_self_attention_f32` and counted by its
    ``launches``.
Any other dtype, head dim or mode on a CUDA tensor (the SD1.5 head dims
40/80/160 among them) raises ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from aid_tpu_torch.ops.attention import AttnMode, _softmax_attn, interpolated_attention
from aid_tpu_torch.ops.routing import use_kernel

KERNEL_HEAD_DIM = 64
F32_KERNEL_HEAD_DIM = 512


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
    if coef is None:
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


def _check_operand(name: str, x: torch.Tensor, dtype=torch.bfloat16, head_dim: int = KERNEL_HEAD_DIM) -> None:
    if x.dtype != dtype:
        raise NotImplementedError(f"flash kernel takes {dtype} here; {name} is {x.dtype}")
    if x.shape[-1] != head_dim:
        raise NotImplementedError(f"flash kernel takes head dim {head_dim} here; {name} has {x.shape[-1]}")
    if x.stride(-1) != 1:
        raise ValueError(f"{name}: the head dim must be contiguous, strides {x.stride()}")
    per_16_bytes = 16 // x.element_size()
    if any(s % per_16_bytes for s in x.stride()[:-1]) or x.data_ptr() % 16:
        raise ValueError(f"{name}: 16-byte row alignment needed, strides {x.stride()}")


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
    B, H, Sq, D = q.shape
    if k.dim() != 4 or k.shape[:2] != (B, H) or k.shape[-1] != D or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, torch.float32, F32_KERNEL_HEAD_DIM)
    if Sq == 0 or k.shape[2] == 0:
        raise ValueError("empty query or key sequence")
    out = torch.empty((B, H, Sq, D), dtype=torch.float32, device=q.device)
    dims = [B, H, Sq, k.shape[2]]
    for x in (q, k, v, out):
        dims += _bhs_strides(x)
    dims_c = (ctypes.c_longlong * len(dims))(*dims)

    from aid_tpu_torch.ops import _build

    lib = _build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.aid_flash_attn_f32_d512(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                       dims_c, float(scale), stream)
    _build.check(code, "flash_self_attention_f32 launch")
    flash_self_attention_f32.launches += 1
    return out


#: kernel launches since the last reset (chip_smoke.py reads it around each path)
flash_self_attention_f32.launches = 0


def _bhs_strides(x: torch.Tensor) -> list:
    """(b, h, s) element strides of a (B, H, L, D) or shared (H, L, D) tensor."""
    if x.dim() == 3:
        return [0, x.stride(0), x.stride(1)]
    return [x.stride(0), x.stride(1), x.stride(2)]


def flash_interpolated_attention(
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

    if q.dtype == torch.float32 and mode == AttnMode.SELF and q.shape[-1] == F32_KERNEL_HEAD_DIM:
        return flash_self_attention_f32(q, k, v, scale)

    B, H, Sq, D = q.shape
    if k.dim() != 4 or k.shape[:2] != (B, H) or k.shape[-1] != D or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if scale is None:
        scale = D ** -0.5
    if k_begin is None:
        k_begin, v_begin = k[0], v[0]
    if k_end is None:
        k_end, v_end = k[-1], v[-1]
    eps = (k_begin, v_begin, k_end, v_end)
    if any(e is None for e in eps):
        raise ValueError("pass endpoint K and V together")
    Le = k_begin.shape[-2]
    for name, e in zip(("k_begin", "v_begin", "k_end", "v_end"), eps):
        if e.dim() not in (3, 4) or e.shape[-3:] != (H, Le, D) or (e.dim() == 4 and e.shape[0] != B):
            raise ValueError(f"{name} shape {tuple(e.shape)}: want (H, Le, D) or (B, H, Le, D) with Le={Le}")

    dev = q.device
    coef = (torch.zeros(B, dtype=torch.float32, device=dev) if coef is None
            else coef.to(device=dev, dtype=torch.float32).reshape(B).contiguous())
    if mode.is_inner:
        # the lerped cross endpoint is made in f32 and stored in the input
        # dtype, as pack_stream does on the TPU; it rides the begin slot
        c = coef.reshape(B, 1, 1, 1)

        def lerped(e0, e1):
            return ((1.0 - c) * e0.float() + c * e1.float()).to(q.dtype).contiguous()

        k_begin, v_begin = lerped(k_begin, k_end), lerped(v_begin, v_end)
        k_end, v_end = k_begin, v_begin
    if skip_endpoints is None or not mode.is_fused:
        skip = torch.zeros(B, dtype=torch.int32, device=dev)
    else:
        skip = torch.as_tensor(skip_endpoints, device=dev).reshape(B).to(torch.int32).contiguous()

    tensors = dict(q=q, k=k, v=v, k_begin=k_begin, v_begin=v_begin, k_end=k_end, v_end=v_end)
    for name, x in tensors.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
        _check_operand(name, x)
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=dev).transpose(1, 2)

    dims = [B, H, Sq, k.shape[2], Le, D]
    for x in (q, k, v, k_begin, v_begin, k_end, v_end, out):
        dims += _bhs_strides(x)
    dims_c = (ctypes.c_longlong * len(dims))(*dims)
    has_own = int(mode in (AttnMode.SELF, AttnMode.FUSED_OUTER, AttnMode.FUSED_INNER))
    n_sets = 2 if mode.is_outer else (1 if mode.is_inner else 0)

    from aid_tpu_torch.ops import _build

    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.aid_flash_attn_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_begin.data_ptr(), v_begin.data_ptr(), k_end.data_ptr(), v_end.data_ptr(),
        out.data_ptr(), coef.data_ptr(), skip.data_ptr(),
        dims_c, float(scale), has_own, n_sets, stream)
    _build.check(code, "flash_interpolated_attention launch")
    flash_interpolated_attention.launches += 1
    return out


#: kernel launches since the last reset (chip_smoke.py reads it around the main path)
flash_interpolated_attention.launches = 0
