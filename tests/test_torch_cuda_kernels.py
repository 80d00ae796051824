"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they need an NVIDIA GPU with nvcc (the kernels build at first
use) and skip elsewhere. This file imports neither jax nor the JAX package,
so it runs where only PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Shapes are small and ragged on purpose (tails of every tile size, per-row
and shared endpoints, skip rows); chip_smoke.py checks the main path's shapes.
"""

import pytest
import torch
import torch.nn.functional as F

from aid_tpu_torch.models.layers import per_row_endpoints, skip_mask
from aid_tpu_torch.ops.attention import AttnMode, dispatch_attention
from aid_tpu_torch.ops.conv import (
    conv3x3_gnsilu,
    conv3x3_gnsilu_f32,
    conv3x3_gnsilu_plain,
    conv3x3_same,
    conv3x3_same_f32,
)
from aid_tpu_torch.ops.flash_attention import (
    flash_interpolated_attention,
    flash_interpolated_attention_f32,
    flash_interpolated_attention_plain,
    flash_self_attention_bf16,
    flash_self_attention_f32,
)

pytestmark = pytest.mark.cuda

MODES = [m.value for m in AttnMode]

# bf16 inputs and output: the kernel and the plain version round P to bf16 at
# different points (unnormalized tile probabilities vs normalized softmax)
# and sum in another order; each output also rounds once to bf16 (2^-9 of
# its size). 2% of max |ref| is a few bf16 ulps at the largest outputs.
ATTN_RTOL = 2e-2
# bf16 conv, f32 accumulation on both sides: one rounding of the output
# (relative 2^-8) plus order differences; relative to max |ref|.
CONV_RTOL = 1e-2
# f32 attention with 3xTF32 products in the kernel and full-f32 matmuls in
# the plain version (TF32 off, set in the fixture): the dropped lo*lo terms
# (~2^-22 relative), summation order and exp2 vs exp, ~1e-6 of max |ref|
# over thousands of keys. 1e-4 leaves margin; plain TF32 (~1e-3) or a wrong
# mask, scale or tile would not pass.
F32_ATTN_RTOL = 1e-4
# f32 conv with 3xTF32 products and f32 sums of each K chunk in the kernel,
# cuDNN in full f32 on the other side (TF32 off): the dropped lo*lo terms and
# summation order, ~1e-6 of max |ref| at K = 9 * 960. 1e-4 as for the f32
# attention; plain TF32 (~4e-4 at that K) or a wrong tap would not pass.
F32_CONV_RTOL = 1e-4


def _attn_err(got, want):
    """max |got - want| / max |want|"""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def _randn(shape, seed, dtype=torch.bfloat16):
    return torch.randn(shape, generator=_gen(seed), device="cuda", dtype=torch.float32).to(dtype)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("B,H,S,L,Le,ep", [
    (3, 2, 100, 100, None, None),     # rows 0 / B-1 as endpoints, ragged q and kv tails
    (4, 3, 130, 77, 77, 3),           # cross-like: 77 keys, shared 77-token endpoints
    (2, 2, 64, 64, 23, 4),            # per-row endpoints of their own length
])
def test_flash_kernel_matches_plain(dev, mode, B, H, S, L, Le, ep):
    q, k, v = _randn((B, H, S, 64), 1), _randn((B, H, L, 64), 2), _randn((B, H, L, 64), 3)
    coef = torch.linspace(0, 1, B, device=dev)
    skip = torch.zeros(B, dtype=torch.bool, device=dev)
    skip[0] = skip[-1] = True
    eps = {}
    if ep is not None:
        shape = (H, Le, 64) if ep == 3 else (B, H, Le, 64)
        eps = {n: _randn(shape, 10 + i) for i, n in enumerate(("k_begin", "v_begin", "k_end", "v_end"))}
    before = flash_interpolated_attention.launches
    got = flash_interpolated_attention(q, k, v, coef, mode, skip_endpoints=skip, **eps)
    torch.cuda.synchronize()
    assert flash_interpolated_attention.launches == before + 1
    want = flash_interpolated_attention_plain(q, k, v, coef, mode, skip_endpoints=skip, **eps)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert _attn_err(got, want) < ATTN_RTOL


@pytest.mark.parametrize("D", [40, 80, 160])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("B,H,S,L,Le,ep", [
    (3, 2, 100, 100, None, None),     # rows 0 / B-1 as endpoints, ragged q and kv tails
    (4, 3, 130, 77, 77, 3),           # cross-like: 77 keys, shared 77-token endpoints
    (2, 2, 64, 64, 23, 4),            # per-row endpoints of their own length
])
def test_flash_kernel_head_dims_match_plain(dev, D, mode, B, H, S, L, Le, ep):
    """SD1.x's head dims: 40 (Q K^T over 48 columns, the pad zero-filled by
    the tensor map), 80 (two 64-column boxes), and 160 (three boxes, 64-row
    q tiles, one accumulator set of 160 columns). The operands are (B, S, H*D) projections viewed as
    (B, H, S, D), as the model passes them, so each row's columns past D
    are the next head's: a kernel that read them would disagree."""
    def heads(x):
        return x.view(x.shape[0], x.shape[1], H, D).transpose(1, 2)

    q = heads(_randn((B, S, H * D), 1))
    k, v = heads(_randn((B, L, H * D), 2)), heads(_randn((B, L, H * D), 3))
    coef = torch.linspace(0, 1, B, device=dev)
    skip = torch.zeros(B, dtype=torch.bool, device=dev)
    skip[0] = skip[-1] = True
    eps = {}
    if ep is not None:
        shape = (H, Le, D) if ep == 3 else (B, H, Le, D)
        eps = {n: _randn(shape, 10 + i) for i, n in enumerate(("k_begin", "v_begin", "k_end", "v_end"))}
    before, before_d = flash_interpolated_attention.launches, flash_interpolated_attention.launches_by_head_dim[D]
    got = flash_interpolated_attention(q, k, v, coef, mode, skip_endpoints=skip, **eps)
    torch.cuda.synchronize()
    assert flash_interpolated_attention.launches == before + 1
    assert flash_interpolated_attention.launches_by_head_dim[D] == before_d + 1
    want = flash_interpolated_attention_plain(q, k, v, coef, mode, skip_endpoints=skip, **eps)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert torch.isfinite(got).all()
    assert _attn_err(got, want) < ATTN_RTOL
    # the strided views and contiguous copies give the same bits
    args = [x.contiguous() for x in (q, k, v)]
    assert torch.equal(got, flash_interpolated_attention(*args, coef, mode, skip_endpoints=skip, **eps))


@pytest.mark.parametrize("D", [40, 64, 80, 160])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("B,H,S,L,Le,ep", [
    (3, 2, 200, 129, None, None),   # Sq past one q tile (192, 128 or 64 rows), 129 keys: a 1-key last tile
    (2, 3, 77, 77, 23, 4),          # 77 keys and queries (one tile), per-row endpoints of 23 keys
    (4, 2, 130, 77, 129, 3),        # shared 3D endpoints of 129 keys
])
def test_flash_kernel_tile_edges(dev, D, mode, B, H, S, L, Le, ep):
    """The edges of the kernel's tiles at every head dim and mode: q tails
    of the q tile (192 rows at D=40/64, 128 at D=80, 64 at D=160), KV
    segments around one 128-key tile (two 64-key tiles at D=160),
    per-row and shared endpoints, skip rows at both ends; operands are the
    model's (B, S, H*D) views, and equal contiguous copies bit for bit."""
    def heads(x):
        return x.view(x.shape[0], x.shape[1], H, D).transpose(1, 2)

    q = heads(_randn((B, S, H * D), 81))
    k, v = heads(_randn((B, L, H * D), 82)), heads(_randn((B, L, H * D), 83))
    coef = torch.linspace(0, 1, B, device=dev)
    skip = torch.zeros(B, dtype=torch.bool, device=dev)
    skip[0] = skip[-1] = True
    eps = {}
    if ep is not None:
        shape = (H, Le, D) if ep == 3 else (B, H, Le, D)
        eps = {n: _randn(shape, 90 + i) for i, n in enumerate(("k_begin", "v_begin", "k_end", "v_end"))}
    got = flash_interpolated_attention(q, k, v, coef, mode, skip_endpoints=skip, **eps)
    torch.cuda.synchronize()
    want = flash_interpolated_attention_plain(q, k, v, coef, mode, skip_endpoints=skip, **eps)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert _attn_err(got, want) < ATTN_RTOL
    args = [x.contiguous() for x in (q, k, v)]
    assert torch.equal(got, flash_interpolated_attention(*args, coef, mode, skip_endpoints=skip, **eps))


def test_flash_kernel_launch_alone_repeats(dev):
    """kernel_launch prepares the operands once; each call of its launch
    writes the same result into the same buffer, and counts nothing."""
    from aid_tpu_torch.ops.flash_attention import kernel_launch

    q, k, v = _randn((3, 2, 150, 64), 84), _randn((3, 2, 90, 64), 85), _randn((3, 2, 90, 64), 86)
    coef = torch.tensor([0.0, 0.4, 1.0], device=dev)
    before = flash_interpolated_attention.launches
    out, launch = kernel_launch(q, k, v, coef, "fused_outer")
    launch()
    first = out.clone()
    launch()
    torch.cuda.synchronize()
    assert flash_interpolated_attention.launches == before
    assert torch.equal(out, first)
    assert torch.equal(out, flash_interpolated_attention(q, k, v, coef, "fused_outer"))


def test_flash_kernel_strided_heads(dev):
    """(B, S, H*D) projections viewed as (B, H, S, D) go in without a copy.

    Only the addressing differs from contiguous operands, so the kernel's
    result on the strided views must equal, bit for bit, its result on
    contiguous copies; a stride read wrongly anywhere breaks that."""
    B, S, H = 3, 96, 4
    coef = torch.tensor([0.0, 0.5, 1.0], device=dev)
    x = _randn((B, S, H * 64), 20)
    q = x.view(B, S, H, 64).transpose(1, 2)
    assert not q.is_contiguous()
    got = flash_interpolated_attention(q, q, q, coef, "fused_outer")
    qc = q.contiguous()
    assert torch.equal(got, flash_interpolated_attention(qc, qc, qc, coef, "fused_outer"))
    want = flash_interpolated_attention_plain(q, q, q, coef, "fused_outer")
    assert _attn_err(got, want) < ATTN_RTOL


def test_flash_kernel_refuses_what_it_does_not_take(dev):
    """On a CUDA tensor a dtype, head dim or mode with no kernel instance
    raises: no quiet fallback to the plain version. f32 at a UNet head dim
    has its instance: it launches the f32 kernel and matches the plain
    version."""
    q = _randn((2, 2, 64, 64), 30, torch.float32)
    before = flash_interpolated_attention_f32.launches
    got = flash_interpolated_attention(q, q, q)
    torch.cuda.synchronize()
    assert flash_interpolated_attention_f32.launches == before + 1
    assert _attn_err(got, flash_interpolated_attention_plain(q, q, q)) < F32_ATTN_RTOL
    with pytest.raises(NotImplementedError):  # f16 has no instance
        flash_interpolated_attention(q.half(), q.half(), q.half())
    q = _randn((2, 2, 64, 48), 31)  # a head dim with no kernel instance
    with pytest.raises(NotImplementedError):
        flash_interpolated_attention(q, q, q)
    with pytest.raises(NotImplementedError):
        flash_interpolated_attention(q.float(), q.float(), q.float())
    q = _randn((2, 1, 64, 512), 32, torch.float32)
    with pytest.raises(NotImplementedError):  # the f32 D=512 kernel is self mode only
        flash_interpolated_attention(q, q, q, torch.tensor([0.0, 1.0], device=dev), "fused_outer")
    with pytest.raises(NotImplementedError):
        flash_self_attention_f32(q.to(torch.bfloat16), q.to(torch.bfloat16), q.to(torch.bfloat16))
    x = _randn((1, 12, 8, 8), 33)  # Cin % 8 != 0
    with pytest.raises(NotImplementedError):
        conv3x3_gnsilu(x, _randn((8, 12, 3, 3), 34), _randn((8,), 35), _randn((12,), 36), _randn((12,), 37), 4)
    x = _randn((1, 16, 8, 8), 38, torch.float32)  # the GN+SiLU conv has no f16 instance
    with pytest.raises(NotImplementedError):
        conv3x3_gnsilu(x.half(), _randn((8, 16, 3, 3), 34).half(), _randn((8,), 35, torch.float32),
                       _randn((16,), 36, torch.float32), _randn((16,), 37, torch.float32), 4)
    with pytest.raises(NotImplementedError):  # nor has f16 a conv instance
        conv3x3_same(x.half(), _randn((8, 16, 3, 3), 34).half(), _randn((8,), 35).half())


@pytest.mark.parametrize("B,H,S,L", [
    (1, 1, 1000, 1000),   # ragged: not a multiple of the 64-row/16-key tiles
    (1, 1, 4096, 4096),
    (3, 2, 300, 200),     # B > 1, H > 1, fewer keys than queries
    (1, 1, 16384, 16384),  # one 1024px SDXL frame
    (2, 3, 1000, 1000),   # B, H > 1 with ragged tails
])
def test_flash_f32_d512_kernel_matches_plain(dev, B, H, S, L):
    q = _randn((B, H, S, 512), 50, torch.float32)
    k, v = _randn((B, H, L, 512), 51, torch.float32), _randn((B, H, L, 512), 52, torch.float32)
    before = flash_self_attention_f32.launches
    got = flash_interpolated_attention(q, k, v)  # routed by dtype and head dim, as the VAE calls it
    torch.cuda.synchronize()
    assert flash_self_attention_f32.launches == before + 1
    want = flash_interpolated_attention_plain(q, k, v)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _attn_err(got, want) < F32_ATTN_RTOL


@pytest.mark.parametrize("B,H,S,L", [
    (1, 1, 16384, 16384),  # one 1024px SDXL frame
    (7, 1, 4096, 4096),    # SD 1.5's batched 512px decode, a 512px tile, a 512px encode
    (1, 1, 4000, 4000),    # ragged: not a multiple of the 64-row / 32-key tiles
    (1, 1, 1, 1),          # one query, one key
    (2, 1, 63, 31),        # one row short of a q tile, one key short of a K/V tile
    (1, 2, 65, 33),        # one past each
    (3, 1, 100, 200),      # more keys than queries
    (2, 3, 129, 97),       # B, H > 1, ragged in both
])
def test_flash_bf16_d512_kernel_matches_plain(dev, B, H, S, L):
    """The bf16 D=512 self kernel, routed as the bf16 VAE calls it, against
    its plain version; operands are (B, S, H*512) projections viewed as
    (B, H, S, 512), and equal contiguous copies bit for bit."""
    def heads(x):
        return x.view(x.shape[0], x.shape[1], H, 512).transpose(1, 2)

    q = heads(_randn((B, S, H * 512), 53))
    k, v = heads(_randn((B, L, H * 512), 54)), heads(_randn((B, L, H * 512), 55))
    before = flash_self_attention_bf16.launches
    got = flash_interpolated_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_self_attention_bf16.launches == before + 1
    want = flash_interpolated_attention_plain(q, k, v)
    assert got.shape == want.shape and got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    assert _attn_err(got, want) < ATTN_RTOL
    args = [x.contiguous() for x in (q, k, v)]
    assert torch.equal(got, flash_self_attention_bf16(*args))


def test_flash_d512_refuses_other_instances(dev):
    """At D=512 only self mode has a kernel, in f32 and bf16: the other modes
    raise on the card. An f32 call at a UNet head dim has its own kernel:
    it launches the f32 instance, counted by head dim, and matches the plain
    version."""
    q = _randn((2, 1, 64, 512), 56)
    coef = torch.tensor([0.0, 1.0], device=dev)
    for mode in ("fused_outer", "pure_outer", "fused_inner", "pure_inner"):
        with pytest.raises(NotImplementedError):
            flash_interpolated_attention(q, q, q, coef, mode)
    for D in (40, 64, 80, 160):
        q = _randn((2, 2, 64, D), 57, torch.float32)
        before = flash_interpolated_attention_f32.launches_by_head_dim[D]
        got = flash_interpolated_attention(q, q, q, coef, "fused_outer")
        torch.cuda.synchronize()
        assert flash_interpolated_attention_f32.launches_by_head_dim[D] == before + 1
        assert got.dtype == torch.float32
        assert _attn_err(got, flash_interpolated_attention_plain(q, q, q, coef, "fused_outer")) < F32_ATTN_RTOL


@pytest.mark.parametrize("D", [40, 64, 80, 160])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("B,H,S,L,Le,ep", [
    (3, 2, 200, 129, None, None),   # Sq past a 64-row q tile, 129 keys: a 1-key last tile (64- and 32-key tiles)
    (2, 3, 77, 77, 23, 4),          # 77 keys and queries (a ragged key tail), per-row endpoints of 23 keys
    (4, 2, 130, 77, 129, 3),        # shared 3D endpoints of 129 keys
])
def test_flash_f32_kernel_matches_plain(dev, D, mode, B, H, S, L, Le, ep):
    """The f32 kernel at every head dim and mode, as an f32 UNet calls it:
    (B, S, H*D) projections viewed as (B, H, S, D) (columns past D are the
    next head's), q and key tails past every tile, per-row and shared
    endpoints, skip rows at both ends; one launch of the f32 instance, within
    the f32 promise of the plain version (TF32 off), and the strided views
    equal to contiguous copies bit for bit."""
    def heads(x):
        return x.view(x.shape[0], x.shape[1], H, D).transpose(1, 2)

    q = heads(_randn((B, S, H * D), 181, torch.float32))
    k, v = heads(_randn((B, L, H * D), 182, torch.float32)), heads(_randn((B, L, H * D), 183, torch.float32))
    coef = torch.linspace(0, 1, B, device=dev)
    skip = torch.zeros(B, dtype=torch.bool, device=dev)
    skip[0] = skip[-1] = True
    eps = {}
    if ep is not None:
        shape = (H, Le, D) if ep == 3 else (B, H, Le, D)
        eps = {n: _randn(shape, 190 + i, torch.float32) for i, n in enumerate(("k_begin", "v_begin", "k_end", "v_end"))}
    before, before_bf16 = flash_interpolated_attention_f32.launches, flash_interpolated_attention.launches
    got = flash_interpolated_attention(q, k, v, coef, mode, skip_endpoints=skip, **eps)
    torch.cuda.synchronize()
    assert flash_interpolated_attention_f32.launches == before + 1
    assert flash_interpolated_attention.launches == before_bf16
    want = flash_interpolated_attention_plain(q, k, v, coef, mode, skip_endpoints=skip, **eps)
    assert got.shape == want.shape and got.dtype == torch.float32 and torch.isfinite(got).all()
    assert _attn_err(got, want) < F32_ATTN_RTOL
    args = [x.contiguous() for x in (q, k, v)]
    assert torch.equal(got, flash_interpolated_attention(*args, coef, mode, skip_endpoints=skip, **eps))


@pytest.mark.parametrize("mode", [m for m in MODES if m != "self"])
def test_flash_f32_kernel_batched_cfg_rows(dev, mode):
    """Batched CFG's call in f32 at SDXL's D=64: 2N rows, per-row endpoints,
    the uncond half skipped in fused modes; the f32 kernel against the plain
    version, and its uncond half against vanilla attention."""
    N, H, S, D = 3, 2, 200, 64

    def heads(x):
        return x.view(x.shape[0], x.shape[1], H, D).transpose(1, 2)

    q, k, v = (heads(_randn((2 * N, S, H * D), 187 + i, torch.float32)) for i in range(3))
    coef = torch.linspace(0, 1, N, device=dev).repeat(2)
    kb, ke = per_row_endpoints(k, N)
    vb, ve = per_row_endpoints(v, N)
    eps = dict(k_begin=kb, v_begin=vb, k_end=ke, v_end=ve, skip_endpoints=skip_mask(coef, N))
    got = flash_interpolated_attention_f32(q, k, v, coef, mode, **eps)
    torch.cuda.synchronize()
    assert _attn_err(got, flash_interpolated_attention_plain(q, k, v, coef, mode, **eps)) < F32_ATTN_RTOL
    assert _attn_err(got[N:], flash_interpolated_attention_plain(q[N:], k[N:], v[N:])) < F32_ATTN_RTOL


@pytest.mark.parametrize("D", [40, 64])
@pytest.mark.parametrize("mode", [m for m in MODES if m != "self"])
def test_flash_kernel_batched_cfg_rows(dev, D, mode):
    """Batched CFG's call: 2N rows [cond; uncond], per-row (B, H, S, D)
    endpoints (cond rows 0 / N-1 for the cond half, each uncond row its
    own), the uncond half skipped in fused modes; the kernel against the
    plain version, and its uncond half against vanilla attention."""
    N, H, S = 3, 2, 200

    def heads(x):
        return x.view(x.shape[0], x.shape[1], H, D).transpose(1, 2)

    q, k, v = (heads(_randn((2 * N, S, H * D), 87 + i)) for i in range(3))
    coef = torch.linspace(0, 1, N, device=dev).repeat(2)
    kb, ke = per_row_endpoints(k, N)
    vb, ve = per_row_endpoints(v, N)
    eps = dict(k_begin=kb, v_begin=vb, k_end=ke, v_end=ve, skip_endpoints=skip_mask(coef, N))
    got = flash_interpolated_attention(q, k, v, coef, mode, **eps)
    torch.cuda.synchronize()
    assert _attn_err(got, flash_interpolated_attention_plain(q, k, v, coef, mode, **eps)) < ATTN_RTOL
    assert _attn_err(got[N:], flash_interpolated_attention_plain(q[N:], k[N:], v[N:])) < ATTN_RTOL


@pytest.mark.parametrize("mode", [m for m in MODES if m != "self"])
def test_force_vanilla_is_one_launch(dev, mode):
    """dispatch_attention's force_vanilla on the card: one kernel launch
    (fused modes fold it into the skip rows, pure modes substitute the
    endpoints), the forced rows vanilla, the others as without it."""
    q, k, v = (_randn((4, 2, 150, 64), 95 + i) for i in range(3))
    coef = torch.tensor([0.0, 0.3, 0.7, 1.0], device=dev)
    force = torch.tensor([False, True, False, True], device=dev)
    before = flash_interpolated_attention.launches
    got = dispatch_attention(q, k, v, coef, mode, force_vanilla=force)
    torch.cuda.synchronize()
    assert flash_interpolated_attention.launches == before + 1
    assert _attn_err(got[force], flash_interpolated_attention_plain(q, k, v)[force]) < ATTN_RTOL
    free = flash_interpolated_attention_plain(q, k, v, coef, mode)
    assert _attn_err(got[~force], free[~force]) < ATTN_RTOL


# the redesigned kernel's tile classes: 4 x 64-pixel tiles against W = 96
# (SD 2.1's 96^2 latents, a half tile at the edge) and W = 100 (ragged in
# both), N tiles of 160 against Cout 320 / 640 (exact) and 130 (ragged), a
# 16-channel K chunk against Cin = 40 (the last chunk half zero-filled), and
# the SDXL 960 -> 320 class at 128^2 with all 7 frames
REDESIGN_CLASSES = [(2, 40, cout, w, w) for w in (96, 100) for cout in (320, 640, 130)] + [(7, 960, 320, 128, 128)]


@pytest.mark.parametrize("B,Cin,Cout,H,W", [
    (2, 64, 64, 16, 16),
    (1, 40, 24, 13, 7),     # ragged pixels, Cin not a multiple of 16, Cout of 160
    (3, 96, 130, 9, 11),
] + REDESIGN_CLASSES)
def test_conv_kernel_matches_plain(dev, B, Cin, Cout, H, W):
    x = _randn((B, Cin, H, W), 40)
    w = _randn((Cout, Cin, 3, 3), 41) * Cin ** -0.5
    b = _randn((Cout,), 42)
    before = conv3x3_same.launches
    got = conv3x3_same(x, w, b)
    torch.cuda.synchronize()
    assert conv3x3_same.launches == before + 1
    want = F.conv2d(x.float(), w.float(), b.float(), padding=1)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    err = (got.float() - want).abs().max().item() / want.abs().max().item()
    assert err < CONV_RTOL


def _ring(H, W, device):
    ring = torch.zeros(H, W, dtype=torch.bool, device=device)
    ring[0], ring[-1], ring[:, 0], ring[:, -1] = True, True, True, True
    return ring


@pytest.mark.parametrize("B,Cin,Cout,H,W,groups", [
    (1, 320, 320, 13, 11, 32),    # pixels not a multiple of the 128-pixel tile
    (7, 320, 640, 16, 16, 32),
    (2, 2560, 1280, 9, 7, 32),    # the widest SDXL resnet input
    (7, 2560, 1280, 8, 8, 32),
    (3, 40, 24, 5, 6, 8),         # Cin not a multiple of the 16-channel K chunk
] + [(*c, 8) for c in REDESIGN_CLASSES])
def test_conv_gnsilu_kernel_matches_plain(dev, B, Cin, Cout, H, W, groups):
    """The prologue kernel against its plain version (same one-pass
    statistics, silu in f32 rounded to bf16, cuDNN conv with zero padding).
    The border ring is checked on its own: a halo that took silu(shift)
    moves only that ring, which the whole-tensor bound would barely see."""
    x = (_randn((B, Cin, H, W), 60).float() * 2.0 + 1.0).to(torch.bfloat16)
    w = _randn((Cout, Cin, 3, 3), 61) * (9 * Cin) ** -0.5
    b = _randn((Cout,), 62)
    gamma = (1.0 + 0.3 * _randn((Cin,), 63, torch.float32))
    beta = 0.5 * _randn((Cin,), 64, torch.float32)
    before = conv3x3_gnsilu.launches
    got = conv3x3_gnsilu(x, w, b, gamma, beta, groups)
    torch.cuda.synchronize()
    assert conv3x3_gnsilu.launches == before + 1
    want = conv3x3_gnsilu_plain(x, w, b, gamma, beta, groups)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs()
    ref = want.float().abs().max().item()
    ring = _ring(H, W, dev)
    assert err[:, :, ring].max().item() < CONV_RTOL * ref
    assert err[:, :, ~ring].max().item() < CONV_RTOL * ref


def test_conv_packed_is_the_prologue_free_kernel(dev):
    """conv3x3_same(packed=True) launches the same kernel as packed=False
    (one conv kernel serves both TPU contracts): equal bits, one launch each."""
    x = _randn((2, 64, 12, 10), 70)
    w = _randn((96, 64, 3, 3), 71) * 64 ** -0.5
    b = _randn((96,), 72)
    before = conv3x3_same.launches
    packed = conv3x3_same(x, w, b, packed=True)
    plain_flag = conv3x3_same(x, w, b)
    torch.cuda.synchronize()
    assert conv3x3_same.launches == before + 2
    assert torch.equal(packed, plain_flag)
    want = F.conv2d(x.float(), w.float(), b.float(), padding=1)
    assert (packed.float() - want).abs().max().item() < CONV_RTOL * want.abs().max().item()


def test_conv_retiles_a_weight_updated_in_place(dev):
    """The wrapper keeps a weight's tiling between calls; an in-place update
    (a new version of the weight) must reach the kernel on the next call."""
    x = _randn((2, 64, 12, 10), 73)
    w = torch.nn.Parameter(_randn((96, 64, 3, 3), 74) * 64 ** -0.5)
    b = _randn((96,), 75)
    with torch.no_grad():
        first = conv3x3_same(x, w, b)
        w.mul_(-2)
        second = conv3x3_same(x, w, b)
    torch.cuda.synchronize()
    want = F.conv2d(x.float(), w.detach().float(), b.float(), padding=1)
    assert not torch.equal(first, second)
    assert (second.float() - want).abs().max().item() < CONV_RTOL * want.abs().max().item()


@pytest.mark.parametrize("layout", ["nchw", "channels_last", "channel_slice", "misaligned_slice", "row_slice"])
def test_conv_layout_kernel_matches_plain(dev, layout):
    """The conv's layout kernel writes (B, C/8, H, W, 8) from x at its own
    strides, bit for bit: NCHW, channels-last (16-byte loads), a
    channels-last view 16 bytes in, one 8 bytes in (no 16-byte loads), and
    a view of rows."""
    from aid_tpu_torch.ops.conv import blocked_input, blocked_input_plain

    x = _randn((3, 48, 13, 11), 76)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    elif layout == "channel_slice":
        x = x.contiguous(memory_format=torch.channels_last)[:, 8:40]
    elif layout == "misaligned_slice":
        x = x.contiguous(memory_format=torch.channels_last)[:, 4:36]
    elif layout == "row_slice":
        x = x[:, :, 1:]
    got = blocked_input(x)
    assert got.shape == (x.shape[0], x.shape[1] // 8, x.shape[2], x.shape[3], 8)
    assert torch.equal(got, blocked_input_plain(x))


# the f32 kernel's tile classes: 2 x 64-pixel tiles against W = 96 and 100
# (half and ragged column tiles), N tiles of 160 against Cout 320 (exact)
# and 130 (ragged), an 8-channel K chunk against Cin = 36 (the last chunk
# half zero-filled), and the three SDXL classes at 128^2 with all 7 frames
F32_CONV_CLASSES = [(2, 36, cout, w, w) for w in (96, 100) for cout in (320, 130)] + [
    (7, 960, 320, 128, 128), (7, 640, 320, 128, 128), (7, 640, 640, 128, 128)]


@pytest.mark.parametrize("B,Cin,Cout,H,W", [
    (2, 64, 64, 16, 16),
    (1, 40, 24, 13, 7),     # ragged pixels, Cout not a multiple of the 160-channel N tile
    (3, 12, 130, 9, 11),    # Cin % 8 != 0: the last K chunk's second block zero-filled
] + F32_CONV_CLASSES)
def test_conv_f32_kernel_matches_plain(dev, B, Cin, Cout, H, W):
    """The f32 conv kernel, routed by conv3x3_same as an f32 UNet calls it,
    against cuDNN in full f32: one launch of the f32 instance, none of the
    bf16 one, a channels-last f32 result within the f32 promise."""
    x = _randn((B, Cin, H, W), 140, torch.float32)
    w = _randn((Cout, Cin, 3, 3), 141, torch.float32) * (9 * Cin) ** -0.5
    b = _randn((Cout,), 142, torch.float32)
    before, before_bf16 = conv3x3_same_f32.launches, conv3x3_same.launches
    got = conv3x3_same(x, w, b)
    torch.cuda.synchronize()
    assert conv3x3_same_f32.launches == before + 1 and conv3x3_same.launches == before_bf16
    want = F.conv2d(x, w, b, padding=1)
    assert got.shape == want.shape and got.dtype == torch.float32
    err = (got - want).abs().max().item() / want.abs().max().item()
    assert err < F32_CONV_RTOL
    # packed=True launches the same instance: the same bits
    assert torch.equal(got, conv3x3_same(x, w, b, packed=True))


def test_conv_f32_retiles_a_weight_updated_in_place(dev):
    """The f32 weight tiling is kept between calls and redone after an
    in-place update."""
    x = _randn((2, 64, 12, 10), 143, torch.float32)
    w = torch.nn.Parameter(_randn((96, 64, 3, 3), 144, torch.float32) * 64 ** -0.5)
    b = _randn((96,), 145, torch.float32)
    with torch.no_grad():
        first = conv3x3_same(x, w, b)
        w.mul_(-2)
        second = conv3x3_same(x, w, b)
    torch.cuda.synchronize()
    want = F.conv2d(x, w.detach(), b, padding=1)
    assert not torch.equal(first, second)
    assert (second - want).abs().max().item() < F32_CONV_RTOL * want.abs().max().item()


@pytest.mark.parametrize("layout", ["nchw", "channels_last", "channel_slice", "misaligned_slice", "row_slice"])
def test_conv_f32_layout_kernel_matches_plain(dev, layout):
    """The f32 layout kernel writes (B, C/4, H, W, 4) from x at its own
    strides, bit for bit: NCHW, channels-last (16-byte loads), a
    channels-last view 16 bytes in, one 8 bytes in (no 16-byte loads), and
    a view of rows."""
    from aid_tpu_torch.ops.conv import blocked_input, blocked_input_plain

    x = _randn((3, 48, 13, 11), 146, torch.float32)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    elif layout == "channel_slice":
        x = x.contiguous(memory_format=torch.channels_last)[:, 4:40]
    elif layout == "misaligned_slice":
        x = x.contiguous(memory_format=torch.channels_last)[:, 2:38]
    elif layout == "row_slice":
        x = x[:, :, 1:]
    got = blocked_input(x)
    assert got.shape == (x.shape[0], x.shape[1] // 4, x.shape[2], x.shape[3], 4)
    assert torch.equal(got, blocked_input_plain(x))


@pytest.mark.parametrize("B,Cin,Cout,H,W,groups", [
    (1, 320, 320, 13, 11, 32),    # pixels not a multiple of the 128-pixel tile
    (3, 12, 24, 5, 6, 4),         # Cin % 8 != 0: the last K chunk's second block zero-filled
    (2, 2560, 1280, 9, 7, 32),    # the widest SDXL resnet input
    (1, 320, 320, 96, 96, 32),    # SD 2.1's fused classes at 96^2 (one full, one half column tile)
    (1, 640, 320, 96, 96, 32),
    (1, 640, 640, 48, 48, 32),    # and at 48^2
    (1, 1280, 640, 48, 48, 32),
])
def test_conv_gnsilu_f32_kernel_matches_plain(dev, B, Cin, Cout, H, W, groups):
    """The f32 GN+SiLU conv (the prologue in the f32 layout pass, then the
    f32 conv kernel), routed by conv3x3_gnsilu as an f32 UNet calls it,
    against its plain version in full f32: one launch of the f32 instance,
    none of the bf16 ones, the border ring (where a halo that took
    silu(shift) would show) and the interior each within the f32 promise."""
    x = _randn((B, Cin, H, W), 160, torch.float32) * 2.0 + 1.0
    w = _randn((Cout, Cin, 3, 3), 161, torch.float32) * (9 * Cin) ** -0.5
    b = _randn((Cout,), 162, torch.float32)
    gamma = 1.0 + 0.3 * _randn((Cin,), 163, torch.float32)
    beta = 0.5 * _randn((Cin,), 164, torch.float32)
    before = (conv3x3_gnsilu_f32.launches, conv3x3_gnsilu.launches, conv3x3_same_f32.launches)
    got = conv3x3_gnsilu(x, w, b, gamma, beta, groups)
    torch.cuda.synchronize()
    assert (conv3x3_gnsilu_f32.launches, conv3x3_gnsilu.launches, conv3x3_same_f32.launches) == (
        before[0] + 1, before[1], before[2])
    want = conv3x3_gnsilu_plain(x, w, b, gamma, beta, groups)
    assert got.shape == want.shape and got.dtype == torch.float32
    err = (got - want).abs()
    ref = want.abs().max().item()
    ring = _ring(H, W, dev)
    assert err[:, :, ring].max().item() < F32_CONV_RTOL * ref
    assert err[:, :, ~ring].max().item() < F32_CONV_RTOL * ref


@pytest.mark.parametrize("layout", ["nchw", "channels_last", "row_slice"])
def test_conv_f32_prologue_layout_matches_plain(dev, layout):
    """The f32 layout pass with the prologue writes silu(x * scale + shift)
    as (B, C/4, H, W, 4) from x at its own strides, within a few f32 ulps
    of the plain version (fma and expf against torch's separate mul, add
    and silu)."""
    from aid_tpu_torch.ops.conv import blocked_input, blocked_input_plain

    x = _randn((3, 48, 13, 11), 165, torch.float32) * 3.0
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    elif layout == "row_slice":
        x = x[:, :, 1:]
    sc, sh = _randn((3, 48), 166, torch.float32), _randn((3, 48), 167, torch.float32)
    got = blocked_input(x, sc, sh)
    want = blocked_input_plain(x, sc, sh)
    assert got.shape == want.shape == (3, 12, x.shape[2], 11, 4)
    assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("S,L", [
    (144, 144),   # SD 2.1's 12^2 self-attention: queries under one 192-row tile, a ragged 16-key tail
    (576, 576),   # its 24^2 self-attention: 576 keys, not a multiple of the 128-key tile
    (144, 77),    # a 77-key cross-attention at 12^2
])
def test_flash_kernels_at_sd21_shapes(dev, dtype, mode, S, L):
    """The bf16 and f32 attention at D=64 with SD 2.1's 20 heads at its new
    ragged sequence lengths, as its UNet calls them ((B, S, H*D) views), in
    every mode with skip rows at both ends."""
    B, H, D = 3, 20, 64

    def heads(x):
        return x.view(x.shape[0], x.shape[1], H, D).transpose(1, 2)

    q = heads(_randn((B, S, H * D), 170, dtype))
    k, v = heads(_randn((B, L, H * D), 171, dtype)), heads(_randn((B, L, H * D), 172, dtype))
    coef = torch.tensor([0.0, 0.4, 1.0], device=dev)
    skip = skip_mask(coef, B)
    counter = flash_interpolated_attention_f32 if dtype == torch.float32 else flash_interpolated_attention
    before = counter.launches
    got = flash_interpolated_attention(q, k, v, coef, mode, skip_endpoints=skip)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    want = flash_interpolated_attention_plain(q, k, v, coef, mode, skip_endpoints=skip)
    assert got.shape == want.shape and got.dtype == dtype and torch.isfinite(got).all()
    assert _attn_err(got, want) < (F32_ATTN_RTOL if dtype == torch.float32 else ATTN_RTOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Cin,Cout", [(960, 320), (640, 320), (640, 640)])
def test_conv_kernels_at_sd21_width(dev, dtype, Cin, Cout):
    """The bf16 and f32 conv at W = 96 (SD 2.1's 96^2 up-block convs: one
    full 64-column tile and one half-empty tile per row), a few rows."""
    x = _randn((2, Cin, 6, 96), 175, dtype)
    w = _randn((Cout, Cin, 3, 3), 176, dtype) * (9 * Cin) ** -0.5
    b = _randn((Cout,), 177, dtype)
    got = conv3x3_same(x, w, b)
    torch.cuda.synchronize()
    want = F.conv2d(x.float(), w.float(), b.float(), padding=1)
    assert got.shape == want.shape and got.dtype == dtype
    err = (got.float() - want).abs().max().item() / want.abs().max().item()
    assert err < (F32_CONV_RTOL if dtype == torch.float32 else CONV_RTOL)
