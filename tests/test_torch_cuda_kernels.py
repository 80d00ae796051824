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

from aid_tpu_torch.ops.attention import AttnMode
from aid_tpu_torch.ops.conv import conv3x3_gnsilu, conv3x3_gnsilu_plain, conv3x3_same
from aid_tpu_torch.ops.flash_attention import (
    flash_interpolated_attention,
    flash_interpolated_attention_plain,
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
# f32 attention with f32 FMA in the kernel and full-f32 matmuls in the plain
# version (TF32 off, set in the fixture): summation order and exp2 vs exp,
# ~1e-6 of max |ref| over thousands of keys. 1e-4 leaves margin; TF32
# (~1e-3) or a wrong mask, scale or tile would not pass.
F32_ATTN_RTOL = 1e-4


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
    """On a CUDA tensor an unsupported dtype, head dim or mode raises: no
    quiet fallback to the plain version."""
    q = _randn((2, 2, 64, 64), 30, torch.float32)
    with pytest.raises(NotImplementedError):
        flash_interpolated_attention(q, q, q)
    q = _randn((2, 2, 64, 40), 31)
    with pytest.raises(NotImplementedError):
        flash_interpolated_attention(q, q, q)
    q = _randn((2, 1, 64, 512), 32, torch.float32)
    with pytest.raises(NotImplementedError):  # the f32 kernel is self mode only
        flash_interpolated_attention(q, q, q, torch.tensor([0.0, 1.0], device=dev), "fused_outer")
    with pytest.raises(NotImplementedError):
        flash_self_attention_f32(q.to(torch.bfloat16), q.to(torch.bfloat16), q.to(torch.bfloat16))
    x = _randn((1, 12, 8, 8), 33)  # Cin % 8 != 0
    with pytest.raises(NotImplementedError):
        conv3x3_gnsilu(x, _randn((8, 12, 3, 3), 34), _randn((8,), 35), _randn((12,), 36), _randn((12,), 37), 4)


@pytest.mark.parametrize("B,H,S,L", [
    (1, 1, 1000, 1000),   # ragged: not a multiple of the 32-row/32-key tiles
    (1, 1, 4096, 4096),
    (3, 2, 300, 200),     # B > 1, H > 1, fewer keys than queries
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


@pytest.mark.parametrize("B,Cin,Cout,H,W", [
    (2, 64, 64, 16, 16),
    (1, 40, 24, 13, 7),     # ragged pixels, Cin not a multiple of 32, Cout of 128
    (3, 96, 130, 9, 11),
])
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
    (3, 40, 24, 5, 6, 8),         # Cin not a multiple of the 32-channel K step
])
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
