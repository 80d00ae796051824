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
from aid_tpu_torch.ops.conv import conv3x3_same
from aid_tpu_torch.ops.flash_attention import flash_interpolated_attention, flash_interpolated_attention_plain

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
    q = _randn((2, 2, 64, 64), 30, torch.float32)
    with pytest.raises(NotImplementedError):
        flash_interpolated_attention(q, q, q)
    q = _randn((2, 2, 64, 40), 31)
    with pytest.raises(NotImplementedError):
        flash_interpolated_attention(q, q, q)


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
