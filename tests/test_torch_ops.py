"""The port's ops against aid_tpu's: interpolation math, attention, conv.

Same seeded numpy inputs through both packages, f32 on the CPU. Where the
JAX function reaches a Pallas kernel it runs in interpret mode, as
tests/test_flash_attention.py and tests/test_conv3x3.py run it. On the CPU
the port's kernel wrappers take their plain versions, which is what these
pin; the kernels themselves are held to the same plain versions on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_helpers as th
from aid_tpu.ops import interp as jax_interp
from aid_tpu.ops.attention import interpolated_attention as jax_interpolated_attention
from aid_tpu.ops.conv import conv3x3_gnsilu as jax_conv3x3_gnsilu
from aid_tpu.ops.conv import conv3x3_same as jax_conv3x3_same
from aid_tpu.ops.flash_attention import flash_interpolated_attention as jax_flash
from aid_tpu_torch.models import layers
from aid_tpu_torch.models.layers import Conv3x3, conv_lowering
from aid_tpu_torch.ops import interp
from aid_tpu_torch.ops.attention import AttnMode, dispatch_attention, interpolated_attention
from aid_tpu_torch.ops.conv import conv3x3_gnsilu, conv3x3_same
from aid_tpu_torch.ops.flash_attention import (
    KERNEL_HEAD_DIMS,
    flash_interpolated_attention,
    flash_interpolated_attention_plain,
)
from aid_tpu_torch.ops.routing import reference_ops, use_kernel

MODES = [m.value for m in AttnMode]
HEAD_DIMS = list(KERNEL_HEAD_DIMS)  # 40, 64, 80, 160: SD1.x's three and SDXL's

# f32 attention on both sides: only summation order differs (~1e-7 of the
# output scale); 1e-5 of max |ref| catches any wrong segment, scale or blend.
ATTN_TOL = 1e-5
# The interpret-mode Pallas kernel is an online (tiled) softmax: its f32
# rescaling chain rounds differently from one softmax, ~1e-6 of max |ref|.
FLASH_TOL = 1e-4
# f32 conv through XLA's Pallas interpreter vs oneDNN: summation order only.
CONV_TOL = 1e-5


@pytest.mark.parametrize("size,alpha,beta", [(7, 28, 28), (5, 28, 28), (9, 3.0, 3.0), (3, 0.5, 2.0)])
@pytest.mark.parametrize("force", [True, False])
def test_beta_schedule_equal(size, alpha, beta, force):
    got = interp.generate_beta_schedule(size, alpha, beta, force_endpoints=force)
    want = jax_interp.generate_beta_schedule(size, alpha, beta, force_endpoints=force)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_lerp_slerp_match_jax():
    v0, v1 = th.normal(0, (6, 16)), th.normal(1, (6, 16))
    v1[2] = 3.0 * v0[2]  # colinear row -> lerp branch
    v0[4] = 0.0  # zero row -> NaN dot -> lerp branch
    t = np.linspace(0, 1, 6, dtype=np.float32)[:, None]
    got = interp.slerp(torch.from_numpy(v0), torch.from_numpy(v1), torch.from_numpy(t))
    want = jax_interp.slerp(jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    got = interp.lerp(torch.from_numpy(v0), torch.from_numpy(v1), 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_interp.lerp(v0, v1, 0.3)), rtol=1e-6, atol=1e-6)


def _attn_inputs(B=3, H=2, S=40, L=40, D=16, Le=None, ep_rank=None, seed=0):
    q, k, v = th.normal(seed, (B, H, S, D)), th.normal(seed + 1, (B, H, L, D)), th.normal(seed + 2, (B, H, L, D))
    coef = np.linspace(0, 1, B).astype(np.float32)
    eps = {}
    if ep_rank is not None:
        shape = (H, Le, D) if ep_rank == 3 else (B, H, Le, D)
        eps = {n: th.normal(seed + 3 + i, shape) for i, n in enumerate(("k_begin", "v_begin", "k_end", "v_end"))}
    return q, k, v, coef, eps


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("endpoints", ["rows", "shared3d_ragged", "per_row4d_ragged"])
def test_plain_attention_matches_jax(mode, endpoints):
    ep_rank = {"rows": None, "shared3d_ragged": 3, "per_row4d_ragged": 4}[endpoints]
    q, k, v, coef, eps = _attn_inputs(Le=23, ep_rank=ep_rank)
    want = jax_interpolated_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(coef), mode,
                                      **{n: jnp.asarray(e) for n, e in eps.items()})
    got = interpolated_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(coef), mode, **{n: torch.from_numpy(e) for n, e in eps.items()})
    assert th.max_rel_err(got.numpy(), np.asarray(want)) < ATTN_TOL


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("mode", MODES)
def test_flash_wrapper_matches_pallas_interpret(mode, D):
    """The wrapper's CPU route against the Pallas kernel run in interpret
    mode: a ragged cross-attention-like shape (S=64 queries, 77 keys), coef
    0/1 endpoint rows marked as skip rows (dropped in fused modes), at every
    head dim the CUDA kernel has an instance for."""
    B, H, S, L = 3, 2, 64, 77
    q, k, v, _, _ = _attn_inputs(B, H, S, L, D, seed=10)
    coef = np.array([0.0, 0.35, 1.0], np.float32)
    skip = np.array([True, False, True])
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(coef), mode,
                     skip_endpoints=jnp.asarray(skip), block_q=64, block_k=64, interpret=True)
    got = flash_interpolated_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                       torch.from_numpy(coef), mode, skip_endpoints=torch.from_numpy(skip))
    assert th.max_rel_err(got.numpy(), np.asarray(want)) < FLASH_TOL


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("mode", ["fused_outer", "pure_inner"])
def test_flash_wrapper_explicit_endpoints_match_pallas_interpret(mode, D):
    """Shared 3D endpoints of their own ragged length (Le=48 vs Lk=32)."""
    q, k, v, coef, eps = _attn_inputs(3, 2, 64, 32, D, Le=48, ep_rank=3, seed=20)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(coef), mode,
                     block_q=64, block_k=64, interpret=True, **{n: jnp.asarray(e) for n, e in eps.items()})
    got = flash_interpolated_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                       torch.from_numpy(coef), mode, **{n: torch.from_numpy(e) for n, e in eps.items()})
    assert th.max_rel_err(got.numpy(), np.asarray(want)) < FLASH_TOL


def test_plain_skip_rows_are_vanilla():
    """A fused-mode skip row attends its own K/V only, even where its
    endpoints differ from its own K/V (what the kernel's dropped segments give)."""
    q, k, v, coef, eps = _attn_inputs(Le=40, ep_rank=3, seed=30)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    skip = torch.tensor([False, True, False])
    out = flash_interpolated_attention_plain(qt, kt, vt, torch.from_numpy(coef), "fused_outer",
                                             skip_endpoints=skip, **{n: torch.from_numpy(e) for n, e in eps.items()})
    van = interpolated_attention(qt, kt, vt, torch.from_numpy(coef), "self")
    full = interpolated_attention(qt, kt, vt, torch.from_numpy(coef), "fused_outer",
                                  **{n: torch.from_numpy(e) for n, e in eps.items()})
    torch.testing.assert_close(out[1], van[1], rtol=0, atol=0)
    torch.testing.assert_close(out[[0, 2]], full[[0, 2]], rtol=0, atol=0)


def test_plain_attention_chunking_is_exact(monkeypatch):
    """The plain path's memory chunking over (batch, head) rows changes no arithmetic."""
    from aid_tpu_torch.ops import attention

    q, k, v, coef, _ = _attn_inputs(seed=40)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(coef), "fused_outer")
    whole = interpolated_attention(*args)
    monkeypatch.setattr(attention, "_PLAIN_LOGIT_BUDGET", 1)  # one (b, h) row per chunk
    torch.testing.assert_close(interpolated_attention(*args), whole, rtol=0, atol=0)


@pytest.mark.parametrize("hw,cin,cout", [(16, 32, 24), (8, 64, 64)])
def test_conv_plain_matches_pallas_interpret(hw, cin, cout):
    x = th.normal(50, (2, hw, hw, cin))
    w = th.normal(51, (3, 3, cin, cout), scale=cin ** -0.5)  # HWIO
    b = th.normal(52, (cout,))
    want = jax_conv3x3_same(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), block_rows=8, interpret=True)
    got = conv3x3_same(th.nhwc_to_nchw(x), torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
                       torch.from_numpy(b))
    assert th.max_rel_err(th.nchw_to_nhwc(got), np.asarray(want)) < CONV_TOL


@pytest.mark.parametrize("hw,cin,cout", [(16, 32, 24), (8, 64, 64)])
def test_conv_packed_plain_matches_pallas_interpret(hw, cin, cout):
    """conv3x3_same(packed=True): the JAX packed-K kernel, the same result."""
    x = th.normal(53, (2, hw, hw, cin))
    w = th.normal(54, (3, 3, cin, cout), scale=cin ** -0.5)
    b = th.normal(55, (cout,))
    want = jax_conv3x3_same(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), block_rows=8, interpret=True,
                            packed=True)
    got = conv3x3_same(th.nhwc_to_nchw(x), torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
                       torch.from_numpy(b), packed=True)
    assert th.max_rel_err(th.nchw_to_nhwc(got), np.asarray(want)) < CONV_TOL


@pytest.mark.parametrize("hw,cin,cout,groups", [(16, 64, 48, 8), (8, 32, 32, 32)])
def test_conv_gnsilu_plain_matches_pallas_interpret(hw, cin, cout, groups):
    """conv3x3_gnsilu: one-pass GN statistics folded into scale/shift, SiLU,
    conv with the halo zero after the prologue. The input has a mean and
    scale far from 0/1 and per-channel gamma/beta, so both the statistics
    and a halo that took silu(shift) would show."""
    x = th.normal(56, (2, hw, hw, cin), scale=3.0) + 1.5
    w = th.normal(57, (3, 3, cin, cout), scale=cin ** -0.5)
    b = th.normal(58, (cout,))
    gamma, beta = 1.0 + th.normal(59, (cin,), scale=0.3), th.normal(60, (cin,), scale=0.5)
    want = jax_conv3x3_gnsilu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jnp.asarray(gamma),
                              jnp.asarray(beta), num_groups=groups, block_rows=8, interpret=True)
    got = conv3x3_gnsilu(th.nhwc_to_nchw(x), torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
                         torch.from_numpy(b), torch.from_numpy(gamma), torch.from_numpy(beta), groups)
    assert th.max_rel_err(th.nchw_to_nhwc(got), np.asarray(want)) < CONV_TOL


def test_gn_conv_fused_rule(monkeypatch):
    """The fused prologue's classes are the JAX package's: 1024 <= hw <= 16384
    at cin >= 320, and none while the flag is off (its default)."""
    from aid_tpu.models import layers as jl

    cases = [(1024, 320), (16384, 2560), (4096, 640), (512, 1280), (32768, 320), (4096, 256), (1024, 319)]
    assert not any(layers.gn_conv_fused(hw, cin) for hw, cin in cases)
    monkeypatch.setattr(layers, "_FUSED_GN_CONV", True)
    monkeypatch.setattr(jl, "_FUSED_GN_CONV", True)
    assert [layers.gn_conv_fused(hw, cin) for hw, cin in cases] == [jl.gn_conv_fused(hw, cin) for hw, cin in cases]
    assert [layers.gn_conv_fused(hw, cin) for hw, cin in cases] == [True, True, True, False, False, False, False]


def test_conv_routing_classes():
    """The kernel class is the JAX package's Pallas class: cin >= 512 at hw > 4096."""
    assert conv_lowering(128 * 128, 960) == "kernel"
    assert conv_lowering(128 * 128, 640) == "kernel"
    assert conv_lowering(128 * 128, 320) == "torch"
    assert conv_lowering(64 * 64, 1280) == "torch"
    assert conv_lowering(64 * 65, 512) == "kernel"


def test_cpu_routes_to_plain_versions():
    """CPU tensors never launch a kernel (the counters stay put); other
    devices have no route, except inside reference_ops, where every device
    takes the plain version; reference_ops nests."""
    x = torch.zeros(1, 8)
    assert not use_kernel(x)
    with pytest.raises(ValueError):
        use_kernel(torch.zeros(1, device="meta"))
    n_attn, n_conv, n_gn = flash_interpolated_attention.launches, conv3x3_same.launches, conv3x3_gnsilu.launches
    q, k, v, coef, _ = _attn_inputs(seed=60)
    dispatch_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(coef),
                       "fused_outer")
    Conv3x3(512, 8)(torch.zeros(1, 512, 65, 65))
    conv3x3_gnsilu(torch.zeros(1, 8, 4, 4), torch.zeros(8, 8, 3, 3), torch.zeros(8), torch.ones(8), torch.zeros(8), 4)
    assert (flash_interpolated_attention.launches, conv3x3_same.launches, conv3x3_gnsilu.launches) == (
        n_attn, n_conv, n_gn)
    with reference_ops():
        with reference_ops():
            assert not use_kernel(x)
        assert not use_kernel(x)
        assert not use_kernel(torch.zeros(1, device="meta"))


def _emulate_conv_kernel(x, w, b, factors=()):
    """csrc/conv3x3.cu's data movement, replayed in plain torch (f32 math).

    The operands go through ``kernel_operands``' layouts; per K chunk the
    window arrives as the kernel's TMA box (8-byte elements, zero outside
    the tensor) and the weights as the chunk's contiguous bulk copy, both as
    bytes of shared memory; the GN+SiLU prologue (if ``factors``) rewrites
    the in-image, in-Cin part of the window; each tap's wgmma operands are
    read through their no-swizzle descriptors (start address, LBO along K,
    SBO between 8-row groups), exactly as the kernel builds them. A layout,
    box or descriptor that disagrees with the others breaks the conv."""
    from aid_tpu_torch.ops import conv as C

    xb, wt, bf, fac = C.kernel_operands(x, w, b, *factors)
    B, G, H, W, _ = xb.shape
    Cin, Cout, BN = 8 * G, bf.shape[0], C.KERNEL_N_TILE
    TR, TW, KC = C.KERNEL_TILE_ROWS, C.KERNEL_TILE_COLS, C.KERNEL_K_CHUNK  # one wgmma's M is TW, its K is KC
    WR, WC = TR + 2, TW + 2
    plane = WR * WC * 16  # bytes of one 8-channel group of the window
    xe = xb.reshape(B, G, H, 2 * W, 4)  # 8-byte elements: 4 bf16 each
    m = torch.arange(TW)[:, None]
    n = torch.arange(BN)[:, None]
    k = torch.arange(KC)[None, :]

    def operand(start, rows, lbo):  # bf16 element index of (row, k) through a descriptor
        return (start + (rows // 8) * 128 + (rows % 8) * 16 + (k // 8) * lbo + (k % 8) * 2) // 2

    out = torch.zeros(B, Cout, H, W)
    for bi in range(B):
        for y0 in range(0, H, TR):
            for x0 in range(0, W, TW):
                for nt in range(wt.shape[0]):
                    acc = torch.zeros(TR, TW, BN)
                    for kt in range(wt.shape[1]):
                        box = torch.zeros(2, WR, 2 * WC, 4, dtype=xb.dtype)  # (groups, rows, elements, bf16)
                        for g in range(2):
                            for r in range(WR):
                                gy, yy = 2 * kt + g, y0 - 1 + r
                                if gy < G and 0 <= yy < H:
                                    e0 = 2 * (x0 - 1)
                                    lo, hi = max(e0, 0), min(e0 + 2 * WC, 2 * W)
                                    box[g, r, lo - e0:hi - e0] = xe[bi, gy, yy, lo:hi]
                        if fac:
                            win = box.reshape(2, WR, WC, 8).float()
                            for g in range(2):
                                c = (2 * kt + g) * 8
                                if c >= Cin:
                                    continue
                                sc, sh = fac[0][bi, c:c + 8], fac[1][bi, c:c + 8]
                                ys = torch.arange(WR)[:, None] + y0 - 1
                                xs = torch.arange(WC)[None, :] + x0 - 1
                                inside = ((ys >= 0) & (ys < H) & (xs >= 0) & (xs < W))[..., None]
                                act = torch.nn.functional.silu(win[g] * sc + sh).to(xb.dtype).float()
                                win[g] = torch.where(inside, act, win[g])
                            box = win.to(xb.dtype)
                        smem_x = box.reshape(-1).float()
                        smem_w = wt[nt, kt].reshape(-1).float()
                        for tap in range(9):
                            dy, dx = divmod(tap, 3)
                            bmat = smem_w[operand(tap * 2 * BN * 16, n, BN * 16)]
                            for r in range(TR):
                                amat = smem_x[operand(((r + dy) * WC + dx) * 16, m, plane)]
                                acc[r] += amat @ bmat.T
                    for r in range(TR):
                        y = y0 + r
                        xs = min(TW, W - x0)
                        nn = min(BN, Cout - nt * BN)
                        if y < H:
                            out[bi, nt * BN:nt * BN + nn, y, x0:x0 + xs] = (
                                acc[r, :xs, :nn].T + bf[nt * BN:nt * BN + nn, None])
    return out


@pytest.mark.parametrize("B,Cin,Cout,H,W", [
    (1, 40, 24, 13, 7),    # ragged rows, Cin not a multiple of the 16-channel chunk
    (2, 16, 170, 5, 70),   # two column tiles, two N tiles (the second ragged)
])
@pytest.mark.parametrize("prologue", [False, True])
def test_conv_kernel_layouts_replayed(B, Cin, Cout, H, W, prologue):
    """The CUDA conv kernel's operand layouts, TMA box, bulk copy and wgmma
    descriptors, replayed on the CPU, compute the conv (and, with the
    prologue, the GN+SiLU conv with its halo zero). The arithmetic is f32
    on both sides, so only summation order differs."""
    from aid_tpu_torch.ops.conv import conv3x3_same_plain, gn_scale_shift

    g = torch.Generator().manual_seed(5)
    x = (torch.randn(B, Cin, H, W, generator=g) * 2 + 1).to(torch.bfloat16)
    w = (torch.randn(Cout, Cin, 3, 3, generator=g) * (9 * Cin) ** -0.5).to(torch.bfloat16)
    b = torch.randn(Cout, generator=g)
    if prologue:
        gamma, beta = 1 + 0.3 * torch.randn(Cin, generator=g), 0.5 * torch.randn(Cin, generator=g)
        scale, shift = gn_scale_shift(x, gamma, beta, 8, 1e-5)
        got = _emulate_conv_kernel(x, w, b, (scale, shift))
        # conv3x3_gnsilu_plain's arithmetic (silu rounded once to bf16), with an f32 conv
        act = torch.nn.functional.silu(x.float() * scale[:, :, None, None] + shift[:, :, None, None])
        want = conv3x3_same_plain(act.to(torch.bfloat16).float(), w.float(), b)
    else:
        got = _emulate_conv_kernel(x, w, b)
        want = conv3x3_same_plain(x.float(), w.float(), b)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_conv_tile_constants_follow_the_kernel_source():
    """ops/conv.py's tile constants, which its weight tiling and the replay
    above use, are the ones csrc/conv3x3.cu compiles with."""
    import re
    from pathlib import Path

    from aid_tpu_torch.ops import conv as C

    src = (Path(C.__file__).resolve().parents[1] / "csrc" / "conv3x3.cu").read_text()
    found = {name: int(v) for name, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (found["kTR"], found["kTW"], found["kBN"], found["kKc"]) == (
        C.KERNEL_TILE_ROWS, C.KERNEL_TILE_COLS, C.KERNEL_N_TILE, C.KERNEL_K_CHUNK)


def test_weight_is_tiled_once_until_it_changes():
    """tiled_weight keeps a weight's tiling: the second call returns the same
    tensor, an in-place update (a new version) tiles again, and another
    weight gets its own tiling."""
    from aid_tpu_torch.ops.conv import tiled_weight

    g = torch.Generator().manual_seed(8)
    w = torch.nn.Parameter(torch.randn(170, 24, 3, 3, generator=g).to(torch.bfloat16))
    first = tiled_weight(w)
    assert first.shape == (2, 2, 3, 3, 2, 160, 8)
    assert tiled_weight(w) is first
    with torch.no_grad():
        w.mul_(2)
    again = tiled_weight(w)
    assert again is not first and torch.equal(again, 2 * first)
    other = w.detach().clone()
    assert tiled_weight(other) is not again and torch.equal(tiled_weight(other), again)
    # the tiling holds w's values at (N tile, K chunk, dy, dx, 8-group, co, ci % 8), zeros past Cout and Cin
    assert torch.equal(again[1, 1, 2, 0, 0, 9, 3], w[169, 19, 2, 0]) and not again[1, 1, :, :, 1].any()


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> tf32 by round to nearest, ties away from zero (cvt.rna.tf32.f32):
    add half of the 13 dropped mantissa bits to the magnitude, then clear them."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """The tf32 part of an f32 operand as the tensor cores read it: the low 13
    mantissa bits dropped."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _tf32_matmul(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b.T with the operands rounded as csrc/flash_attention_f32_d512.cu
    rounds them: 1 pass is plain TF32 (hi * hi); 3 passes add hi * lo + lo *
    hi with lo = a - hi. The products are summed in f64, so only the
    operands' rounding is measured."""
    ah, bh = _tf32_round(a), _tf32_round(b)
    out = ah.double() @ bh.double().T
    if passes == 3:
        al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
        out = out + ah.double() @ bl.double().T + al.double() @ bh.double().T
    return out


def _tf32_tiled_attention(q, k, v, passes: int, bk: int = 64) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v as csrc/flash_interpolated_attention_f32.cu's
    wgmma instances round it: operands split with the raw f32 value as hi
    (read truncated to tf32) and lo = a - trunc(a) (read truncated too), 3
    passes (hi*hi + hi*lo + lo*hi) or 1 (plain TF32, hi*hi); an online
    softmax over ``bk``-key tiles with P in f32, each tile's P V summed from
    zero (f64 here, rounded to the f32 accumulator) and folded into the f32
    O by an FMA, as the kernel folds it."""
    def mm(a, b):  # a @ b.T, operands as the tensor cores read them
        out = _tf32_trunc(a).double() @ _tf32_trunc(b).double().T
        if passes == 3:
            out = out + _tf32_trunc(a).double() @ _tf32_trunc(b - _tf32_trunc(b)).double().T
            out = out + _tf32_trunc(a - _tf32_trunc(a)).double() @ _tf32_trunc(b).double().T
        return out

    sl2 = q.shape[-1] ** -0.5 * 1.4426950408889634
    o = torch.zeros(q.shape[0], v.shape[1])
    m = torch.full((q.shape[0],), -math.inf)
    lsum = torch.zeros(q.shape[0])
    for r0 in range(0, k.shape[0], bk):
        s = mm(q, k[r0:r0 + bk]).float()
        mn = torch.maximum(m, s.max(dim=1).values)
        alpha = torch.exp2((m - mn) * sl2)
        p = torch.exp2(s * sl2 - (mn * sl2)[:, None])
        m, lsum = mn, lsum * alpha + p.sum(dim=1)
        part = mm(p, v[r0:r0 + bk].T.contiguous()).float()
        o = torch.addcmul(part, o, alpha[:, None])  # fmaf(o, alpha, part) up to one rounding
    return o.double() / lsum.double()[:, None]


@pytest.mark.parametrize("passes,within,split", [(3, True, "rna"), (1, False, "rna"), (3, True, "raw"),
                                                 (1, False, "raw")],
                         ids=["3-True", "1-False", "raw-3-True", "raw-1-False"])
def test_three_tf32_passes_keep_the_f32_attention_promise(passes, within, split):
    """Why the f32 attention kernels spend three tensor-core passes per
    product. ``rna`` (the D=512 kernel's split, hi = cvt.rna): softmax(Q K^T
    / sqrt(d)) V at (1, 1, 1024, 512) with both products in 3xTF32 stays
    within the f32 attention's 1e-4 of max |out| (chip_smoke.py's
    F32_ATTN_TOL, the VAE decode's promise) of the f64 result; plain TF32
    misses it. ``raw`` (the D = 40/64/80 kernel's split, hi = the raw f32
    value read truncated, ~4x coarser): at D = 64 over a key stream as long
    as SD 2.1's fused_outer (9216 own + 9216 endpoint keys), with the
    kernel's online softmax over 64-key tiles and each tile's P V folded in
    f32, 3xTF32 still stays within 1e-4 of max |out|; plain TF32 does not."""
    f32_attn_tol = 1e-4
    rng = np.random.default_rng(0)
    S, L, D = (1024, 1024, 512) if split == "rna" else (128, 18432, 64)
    q = torch.from_numpy(rng.standard_normal((S, D), dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((L, D), dtype=np.float32)) for _ in range(2))
    want = torch.softmax(q.double() @ k.double().T * D ** -0.5, dim=-1) @ v.double()
    if split == "rna":
        p = torch.softmax(_tf32_matmul(q, k, passes) * D ** -0.5, dim=-1).float()
        got = _tf32_matmul(p, v.T.contiguous(), passes)
    else:
        got = _tf32_tiled_attention(q, k, v, passes)
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert (err < f32_attn_tol) == within, err


def _swizzle128(addr: torch.Tensor) -> torch.Tensor:
    """The 128-byte swizzle of a byte address in a 1024-byte-aligned tile:
    16-byte chunk j of row r (128-byte rows) lies at chunk j ^ (r % 8)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _emulate_flash_kernel(ops: dict) -> torch.Tensor:
    """csrc/flash_interpolated_attention.cu's data movement, replayed in plain
    torch from the C entry's own arguments (``kernel_operands``).

    Each operand is read as its tensor map reads it: (D, H, S, B) over the
    tensor's storage at the strides in ``dims`` (a batch stride of 0: batch
    extent 1), boxes of 64 columns by a tile of rows, zeros outside the
    extents (columns past D, rows past the segment), stored 128-byte
    swizzled. Q K^T reads Q and K through K-major descriptors (start + 32
    bytes per k16 step, 8-row groups 1024 bytes apart), P V reads V through
    the MN-major descriptor (LBO = one box of the tile, 2048 bytes per 16
    keys). Softmax, bf16 P, the outer modes' parked state and the swizzled
    output tile clipped by the TMA store follow the kernel. f32 arithmetic."""
    from aid_tpu_torch.ops.flash_attention import KERNEL_TILES

    tensors, dims = ops["tensors"], ops["dims"]
    B, H, Sq, Lk, Le, D = dims[:6]
    BQ, BK, _ = KERNEL_TILES[D]
    chunks, ksteps = -(-D // 64), -(-D // 16)
    sl2 = ops["scale"] * 1.4426950408889634
    flat = [torch.as_strided(x, (x.untyped_storage().nbytes() // 2 - x.storage_offset(),), (1,),
                             x.storage_offset()).float() for x in tensors]
    strides = [dims[6 + 3 * i:9 + 3 * i] for i in range(8)]
    extents = [Sq, Lk, Lk, Le, Le, Le, Le, Sq]

    def box(i, c, h, s0, b, rows):  # one TMA box of map i into a swizzled tile (bf16 elements)
        sb, sh, ss = strides[i]
        b = 0 if sb == 0 else b
        r = torch.arange(rows)[:, None]
        x = torch.arange(64)[None, :]
        ok = (64 * c + x < D) & (s0 + r < extents[i])
        idx = torch.where(ok, b * sb + h * sh + (s0 + r) * ss + 64 * c + x, 0)
        tile = torch.zeros(rows * 64)
        tile[_swizzle128(r * 128 + x * 2).reshape(-1) // 2] = torch.where(ok, flat[i][idx], 0.0).reshape(-1)
        return tile

    def tiles(i, h, s0, b, rows):  # the kChunks boxes of a row tile, one after the other
        return torch.cat([box(i, c, h, s0, b, rows) for c in range(chunks)])

    def kmajor(smem, start, rows):  # (rows, 16) through a K-major descriptor
        r, kc = torch.arange(rows)[:, None], torch.arange(16)[None, :]
        return smem[_swizzle128(start + (r // 8) * 1024 + (r % 8) * 128 + kc * 2) // 2]

    def mnmajor(smem, start, lbo):  # (16 keys, D) through the MN-major (transposed) descriptor
        kr, n = torch.arange(16)[:, None], torch.arange(D)[None, :]
        return smem[_swizzle128(start + (kr // 8) * 1024 + (kr % 8) * 128 + (n // 64) * lbo + (n % 64) * 2) // 2]

    coef, skip = ops["coef"], ops["skip"]
    has_own, n_sets = ops["has_own"], ops["n_sets"]
    out_flat = torch.zeros_like(flat[7])
    for b in range(B):
        skipped = n_sets > 0 and skip is not None and bool(skip[b])
        segs = ([(1, 2, Lk)] if has_own else []) + ([(3, 4, Le)] if n_sets and not skipped else []) + (
            [(5, 6, Le)] if n_sets == 2 and not skipped else [])
        for h in range(H):
            for q0 in range(0, Sq, BQ):
                for w in range(BQ // 64):
                    qt = tiles(0, h, q0 + 64 * w, b, 64)
                    o, m, lsum = torch.zeros(64, D), torch.full((64,), -math.inf), torch.zeros(64)
                    park = None
                    for n, (ki, vi, length) in enumerate(segs):
                        if n_sets == 2 and not skipped and n == len(segs) - 1:  # the end segment
                            if has_own:
                                park, (o, m, lsum) = o / lsum[:, None] * (1 - coef[b]), park
                            else:
                                park = o / lsum[:, None] * (1 - coef[b])
                                o, m, lsum = torch.zeros(64, D), torch.full((64,), -math.inf), torch.zeros(64)
                        for r0 in range(0, length, BK):
                            kt, vt = tiles(ki, h, r0, b, BK), tiles(vi, h, r0, b, BK)
                            s = sum(kmajor(qt, (kk // 4) * 8192 + (kk % 4) * 32, 64)
                                    @ kmajor(kt, (kk // 4) * BK * 128 + (kk % 4) * 32, BK).T for kk in range(ksteps))
                            s[:, min(BK, length - r0):] = -math.inf
                            mn = torch.maximum(m, s.max(dim=1).values)
                            alpha = torch.exp2((m - mn) * sl2)
                            p = torch.exp2(s * sl2 - (mn * sl2)[:, None])
                            m, lsum = mn, lsum * alpha + p.sum(dim=1)
                            pb = p.to(torch.bfloat16).float()
                            o = o * alpha[:, None] + sum(pb[:, 16 * kk:16 * kk + 16] @ mnmajor(vt, kk * 2048, BK * 128)
                                                         for kk in range(BK // 16))
                        if n_sets == 2 and not skipped and has_own and n == 0:
                            park = (o, m, lsum)
                    o = o / lsum[:, None] * (coef[b] if n_sets == 2 and not skipped else 1.0)
                    if park is not None and n_sets == 2 and not skipped:
                        o = o + park
                    # the output tile, swizzled, then the TMA store clipped to (D, Sq)
                    ob = o.to(torch.bfloat16).float()
                    r, col = torch.arange(64)[:, None], torch.arange(64 * chunks)[None, :]
                    tile = torch.zeros(64 * 64 * chunks)
                    addr = (col // 64) * 8192 + _swizzle128(r * 128 + (col % 64) * 2)
                    tile[(addr // 2)[:, :D].reshape(-1)] = ob.reshape(-1)
                    sb, sh, ss = strides[7]
                    rows = q0 + 64 * w + r
                    keep = (rows < Sq) & (col < D)
                    dst = (b * sb + h * sh + rows * ss + col)[keep]
                    out_flat[dst] = tile[(addr // 2)[keep]]
    out = tensors[7]
    return torch.as_strided(out_flat, out.shape, out.stride()).to(torch.bfloat16)


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("mode,endpoints", [("self", None), ("fused_outer", 3), ("pure_outer", 4),
                                            ("fused_inner", None), ("pure_inner", 3)])
def test_flash_kernel_data_movement_replayed(D, mode, endpoints):
    """The bf16 attention kernel's tensor-map boxes (zero fill past D and past
    each segment), 128-byte swizzle and wgmma descriptors for Q, K and
    transposed V, replayed on the CPU from the wrapper's own C arguments,
    compute the attention: on (B, S, H*D) projections viewed as (B, H, S, D),
    whose columns past D are the next head's, with skip rows at both ends,
    q tails past a tile and KV segments of 129 and 77 keys. Against the
    plain version in f32, the replay differs by P's bf16 rounding and the
    output's (a wrong box, swizzle or descriptor is O(1))."""
    from aid_tpu_torch.ops.flash_attention import kernel_operands

    g = torch.Generator().manual_seed(D)
    B, H, S, L, Le = 3, 2, 150, 129, 77

    def heads(n):
        return (torch.randn(B, n, H * D, generator=g)).to(torch.bfloat16).view(B, n, H, D).transpose(1, 2)

    q, k, v = heads(S), heads(L), heads(L)
    coef = torch.tensor([0.0, 0.4, 1.0])
    skip = torch.tensor([True, False, True])
    eps = {}
    if endpoints is not None:
        shape = (H, Le, D) if endpoints == 3 else (B, H, Le, D)
        eps = {n: torch.randn(shape, generator=g).to(torch.bfloat16)
               for n in ("k_begin", "v_begin", "k_end", "v_end")}
    ops = kernel_operands(q, k, v, coef, mode, skip_endpoints=skip, **eps)
    got = _emulate_flash_kernel(ops)
    want = flash_interpolated_attention_plain(q.float(), k.float(), v.float(), coef, mode, skip_endpoints=skip,
                                              **{n: e.float() for n, e in eps.items()})
    assert got.shape == want.shape
    assert th.max_rel_err(got.float().numpy(), want.numpy()) < 1e-2


def test_flash_tile_constants_follow_the_kernel_source():
    """ops/flash_attention.py's tile table, which the replay above uses, is
    the one csrc/flash_interpolated_attention.cu compiles with: query rows
    per block, keys per K/V tile and ring stages for each head dim."""
    import re
    from pathlib import Path

    from aid_tpu_torch.ops import flash_attention as FA

    src = (Path(FA.__file__).resolve().parents[1] / "csrc" / "flash_interpolated_attention.cu").read_text()
    pat = r"struct Tiles<(\d+)> \{ static constexpr int kBQ = (\d+), kBK = (\d+), kStages = (\d+); \};"
    found = {int(d): (int(bq), int(bk), int(st)) for d, bq, bk, st in re.findall(pat, src)}
    assert found == FA.KERNEL_TILES
    assert sorted(found) == HEAD_DIMS


def _wgmma_acc_index(n_cols: int) -> tuple:
    """(row, col) of accumulator register i of warpgroup thread ct in a wgmma
    m64nN f32 result: (128, N / 2) index tensors. Warp w = ct / 32 holds rows
    16 w + g and 16 w + g + 8, n8 tile j columns 8 j + 2 t and 8 j + 2 t + 1
    (g = lane / 4, t = lane % 4)."""
    ct, i = torch.arange(128)[:, None], torch.arange(n_cols // 2)[None, :]
    lane, j, e = ct % 32, i // 4, i % 4
    return 16 * (ct // 32) + lane // 4 + 8 * (e // 2), 8 * j + 2 * (lane % 4) + e % 2


def _emulate_flash_bf16_d512_kernel(ops: dict) -> torch.Tensor:
    """csrc/flash_attention_bf16_d512.cu's data movement, replayed in plain
    torch from the C entry's own arguments (``d512_operands``).

    Each operand is read as its tensor map reads it: (512, H, S, B) over the
    tensor's storage at the strides in ``dims``, boxes of 64 columns by 64
    query rows or 32 keys, zeros past Sq or Lk, stored 128-byte swizzled.
    Each consumer warpgroup computes partial scores over its four boxes of
    Q and K through K-major descriptors, writes them to the exchange buffer
    in its accumulator order and adds the other warpgroup's; both run the
    same online softmax, P in bf16, and O += P V over their 256 columns
    through the MN-major descriptor (LBO one box). The output leaves
    through the warpgroups' halves of the swizzled Q tile and a TMA store
    clipped at Sq. f32 arithmetic."""
    from aid_tpu_torch.ops.flash_attention import D512_BF16_TILES

    BQ, BK, _, NWG = D512_BF16_TILES
    D, cols = 512, 512 // NWG
    boxes_wg = cols // 64
    tensors, dims = ops["tensors"], ops["dims"]
    B, H, Sq, Lk = dims[:4]
    sl2 = ops["scale"] * 1.4426950408889634
    flat = [torch.as_strided(x, (x.untyped_storage().nbytes() // 2 - x.storage_offset(),), (1,),
                             x.storage_offset()).float() for x in tensors]
    strides = [dims[4 + 3 * i:7 + 3 * i] for i in range(4)]
    extents = [Sq, Lk, Lk, Sq]

    def box(i, c, h, s0, b, rows):  # one TMA box of map i into a swizzled tile (bf16 elements)
        sb, sh, ss = strides[i]
        r, x = torch.arange(rows)[:, None], torch.arange(64)[None, :]
        ok = (s0 + r < extents[i]).expand(rows, 64)
        idx = torch.where(ok, b * sb + h * sh + (s0 + r) * ss + 64 * c + x, 0)
        tile = torch.zeros(rows * 64)
        tile[_swizzle128(r * 128 + x * 2).reshape(-1) // 2] = torch.where(ok, flat[i][idx], 0.0).reshape(-1)
        return tile

    def kmajor(smem, start, rows):  # (rows, 16) through a K-major descriptor
        r, kc = torch.arange(rows)[:, None], torch.arange(16)[None, :]
        return smem[_swizzle128(start + (r // 8) * 1024 + (r % 8) * 128 + kc * 2) // 2]

    def mnmajor(smem, start, lbo):  # (16 keys, 256 columns) through the MN-major (transposed) descriptor
        kr, n = torch.arange(16)[:, None], torch.arange(cols)[None, :]
        return smem[_swizzle128(start + (kr // 8) * 1024 + (kr % 8) * 128 + (n // 64) * lbo + (n % 64) * 2) // 2]

    arow, acol = _wgmma_acc_index(BK)
    tiles = -(-Sq // BQ)
    out_flat = torch.zeros_like(flat[3])
    for b in range(B):
        for h in range(H):
            for blk in range(tiles):
                q0 = blk * BQ
                qt = torch.cat([box(0, c, h, q0, b, BQ) for c in range(8)])
                o = [torch.zeros(BQ, cols) for _ in range(NWG)]
                m, lsum = torch.full((BQ,), -math.inf), torch.zeros(BQ)
                for r0 in range(0, Lk, BK):
                    kt = torch.cat([box(1, c, h, r0, b, BK) for c in range(8)])
                    vt = torch.cat([box(2, c, h, r0, b, BK) for c in range(8)])
                    xbuf = torch.zeros(NWG, 16, 128)
                    for w in range(NWG):  # partial scores over the warpgroup's boxes, in accumulator order
                        part = sum(kmajor(qt, (boxes_wg * w + kk // 4) * BQ * 128 + (kk % 4) * 32, BQ)
                                   @ kmajor(kt, (boxes_wg * w + kk // 4) * BK * 128 + (kk % 4) * 32, BK).T
                                   for kk in range(cols // 16))
                        xbuf[w] = part[arow, acol].T
                    scores = []
                    for w in range(NWG):  # own + the other's, read back by the same thread index
                        regs = xbuf[w] + xbuf[1 - w]
                        sw = torch.zeros(BQ, BK)
                        sw[arow, acol] = regs.T
                        scores.append(sw)
                    assert torch.equal(scores[0], scores[1])
                    s = scores[0]
                    s[:, min(BK, Lk - r0):] = -math.inf
                    mn = torch.maximum(m, s.max(dim=1).values)
                    alpha = torch.exp2((m - mn) * sl2)
                    p = torch.exp2(s * sl2 - (mn * sl2)[:, None])
                    m, lsum = mn, lsum * alpha + p.sum(dim=1)
                    pb = p.to(torch.bfloat16).float()
                    for w in range(NWG):
                        o[w] = o[w] * alpha[:, None] + sum(
                            pb[:, 16 * kk:16 * kk + 16] @ mnmajor(vt, boxes_wg * w * BK * 128 + kk * 2048, BK * 128)
                            for kk in range(BK // 16))
                ob = (torch.cat(o, dim=1) / lsum[:, None]).to(torch.bfloat16).float()
                r, col = torch.arange(BQ)[:, None], torch.arange(D)[None, :]
                tile = torch.zeros(BQ * D)
                addr = (col // 64) * (BQ * 128) + _swizzle128(r * 128 + (col % 64) * 2)
                tile[(addr // 2).reshape(-1)] = ob.reshape(-1)
                sb, sh, ss = strides[3]
                keep = (q0 + r < Sq).expand(BQ, D)
                dst = (b * sb + h * sh + (q0 + r) * ss + col)[keep]
                out_flat[dst] = tile[(addr // 2)[keep]]
    out = tensors[3]
    return torch.as_strided(out_flat, out.shape, out.stride()).to(torch.bfloat16)


@pytest.mark.parametrize("Sq,Lk", [(150, 77), (63, 33), (129, 32), (65, 31)])
def test_flash_bf16_d512_kernel_data_movement_replayed(Sq, Lk):
    """The bf16 D=512 kernel's tensor-map boxes (zeros past Sq and Lk), the
    D split across two warpgroups and their partial-score exchange, the
    128-byte swizzle and the wgmma descriptors, replayed on the CPU from the
    wrapper's own C arguments, compute the attention: on (B, S, H*512)
    projections viewed as (B, H, S, 512) (the next head's columns lie past
    each row), at ragged Sq (a query tile one row short of, or past, the
    64-row tile) and Lk (one key past a tile, a tile and one short).
    Against the plain version in f32, the replay differs by P's bf16
    rounding and the output's (a wrong box, swizzle, descriptor or
    exchange is O(1))."""
    from aid_tpu_torch.ops.attention import _softmax_attn
    from aid_tpu_torch.ops.flash_attention import d512_operands

    g = torch.Generator().manual_seed(Sq + Lk)
    B, H, D = 2, 2, 512

    def heads(n):
        return torch.randn(B, n, H * D, generator=g).to(torch.bfloat16).view(B, n, H, D).transpose(1, 2)

    q, k, v = heads(Sq), heads(Lk), heads(Lk)
    ops = d512_operands(q, k, v)
    assert ops["entry"] == "aid_flash_attn_bf16_d512" and ops["dims"][:4] == [B, H, Sq, Lk]
    got = _emulate_flash_bf16_d512_kernel(ops)
    want = _softmax_attn(q.float(), k.float(), v.float(), D ** -0.5)
    assert got.shape == want.shape
    assert th.max_rel_err(got.float().numpy(), want.numpy()) < 1e-2


def test_flash_bf16_d512_tile_constants_follow_the_kernel_source():
    """ops/flash_attention.py's D512_BF16_TILES, which the replay above uses,
    are the constants csrc/flash_attention_bf16_d512.cu compiles with, and
    its shared memory (Q, the K/V stages, the double-buffered exchange) fits
    the 227 KB a block can use."""
    import re
    from pathlib import Path

    from aid_tpu_torch.ops import flash_attention as FA

    src = (Path(FA.__file__).resolve().parents[1] / "csrc" / "flash_attention_bf16_d512.cu").read_text()
    found = {name: int(v) for name, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    bq, bk, stages, wg = FA.D512_BF16_TILES
    assert (found["kBQ"], found["kBK"], found["kStages"], found["kWG"]) == FA.D512_BF16_TILES
    smem = 1024 + bq * 1024 + stages * 2 * bk * 1024 + 2 * wg * 16 * 128 * 4 + (4 * stages + 1) * 8
    assert smem <= 232448
    assert bq * 512 // wg // 128 <= 128  # each warpgroup's share of the 64 x 512 f32 accumulator, a thread


# ---------------------------------------------------------------------------
# the f32 instances: csrc/flash_interpolated_attention_f32.cu, csrc/conv3x3_f32.cu
# ---------------------------------------------------------------------------

# mma.sync.m16n8k8 (tf32) fragment layout by lane (g = lane / 4, t = lane % 4):
# A a0..a3 at (row, k) = (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4);
# B b0, b1 at (k, n) = (t, g), (t + 4, g); C c0..c3 at (row, n) = (g, 2t),
# (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
_LANE_G, _LANE_T = torch.arange(32) // 4, torch.arange(32) % 4
_A_ROW = torch.stack([_LANE_G, _LANE_G + 8, _LANE_G, _LANE_G + 8], 1)
_A_K = torch.stack([_LANE_T, _LANE_T, _LANE_T + 4, _LANE_T + 4], 1)
_B_K = torch.stack([_LANE_T, _LANE_T + 4], 1)
_B_N = torch.stack([_LANE_G, _LANE_G], 1)
_C_ROW = torch.stack([_LANE_G, _LANE_G, _LANE_G + 8, _LANE_G + 8], 1)
_C_N = torch.stack([2 * _LANE_T, 2 * _LANE_T + 1, 2 * _LANE_T, 2 * _LANE_T + 1], 1)


def _a_matrix(regs: torch.Tensor) -> torch.Tensor:
    """(..., 32, 4) A registers -> (..., 16, 8) matrix."""
    out = regs.new_zeros(*regs.shape[:-2], 16, 8)
    out[..., _A_ROW, _A_K] = regs
    return out


def _b_matrix(regs: torch.Tensor) -> torch.Tensor:
    """(..., 32, 2) B registers -> (..., 8, 8) matrix (k, n)."""
    out = regs.new_zeros(*regs.shape[:-2], 8, 8)
    out[..., _B_K, _B_N] = regs
    return out


def _c_regs(mat: torch.Tensor) -> torch.Tensor:
    """(..., 16, 8) accumulator matrix -> (..., 32, 4) C registers."""
    return mat[..., _C_ROW, _C_N]


def _pair_offsets(ld: int, rows8: bool) -> torch.Tensor:
    """The kernels' 8-byte fragment loads from a tile of pitch ld: rows g (and
    g + 8 for A), columns 2t and 2t + 1, in register order."""
    g, t = _LANE_G, _LANE_T
    if rows8:  # A: (g, 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1)
        return torch.stack([g * ld + 2 * t, (g + 8) * ld + 2 * t, g * ld + 2 * t + 1, (g + 8) * ld + 2 * t + 1], 1)
    return torch.stack([g * ld + 2 * t, g * ld + 2 * t + 1], 1)  # B: (n = g; k = t, t + 4)


def _tf32_read(x: torch.Tensor) -> torch.Tensor:
    """An f32 operand as the tensor cores read it (tf32: the low 13 mantissa
    bits dropped), in f64."""
    return _tf32_trunc(x.float()).double()


def _tf32_rest(x: torch.Tensor) -> torch.Tensor:
    """x - trunc(x) in f32 (tf32_rest in csrc/tf32_mma.cuh): the lo operand
    of the split whose hi operand is the raw f32 value."""
    x = x.float()
    return x - _tf32_trunc(x)


def _swizzle64(addr: torch.Tensor) -> torch.Tensor:
    """The 64-byte swizzle of a byte address in a 512-byte-aligned tile:
    16-byte chunk j of row r (64-byte rows) lies at chunk j ^ (r / 2 % 4)."""
    return addr ^ (((addr >> 7) & 3) << 4)


def _emulate_flash_f32_kernel(ops: dict) -> torch.Tensor:
    """csrc/flash_interpolated_attention_f32.cu (every head dim), replayed
    in plain torch from the C entry's own arguments (``kernel_operands``).

    Each operand is read as its tensor map reads it: (D, H, S, B) over the
    tensor's storage at the strides in ``dims`` (a batch stride of 0: batch
    extent 1), boxes of 32 f32 by a tile of rows, zeros outside the extents
    (columns past D, rows past the segment), stored 128-byte swizzled. Each
    consumer warpgroup owns 64 query rows and, where the instance splits D
    (``KERNEL_F32_D_SPLIT``: two warpgroups at D = 160), D / split columns:
    its Q A fragments are loaded from the row group's Q tile at its columns
    and split (hi = the raw value, lo = its rest); the split warps write K_lo
    chunk by chunk and V^T, (V^T)_lo with each 8-key group permuted
    (0,2,4,6,1,3,5,7), in rows of 128 bytes (128-byte swizzle) or, for
    16-key tiles, 64 bytes (64-byte swizzle); S = Q K^T reads K and K_lo
    through K-major descriptors (start + 32 bytes per k8 step, the
    warpgroup's steps only, 8-row groups 1024 bytes apart). With D split,
    each warpgroup's partial scores go to the exchange buffer in its
    accumulator order and come back added to the other's, read by the same
    thread index; both must hold the same scores. P's A fragment is taken
    from the S accumulator registers as the kernel takes it, and P V reads
    the warpgroup's rows of V^T and (V^T)_lo the same way (8-row groups 1024
    or 512 bytes apart). Every operand is truncated to tf32 where the tensor
    cores read it, products summed in f64; the online softmax, the per-tile
    fold, the parked outer state and the strided output store at the
    warpgroup's columns follow the kernel."""
    from aid_tpu_torch.ops.flash_attention import KERNEL_F32_D_SPLIT, KERNEL_F32_TILES

    tensors, dims = ops["tensors"], ops["dims"]
    B, H, Sq, Lk, Le, D = dims[:6]
    BQ, BK, _ = KERNEL_F32_TILES[D]
    split = KERNEL_F32_D_SPLIT[D]
    DW = D // split  # a warpgroup's columns
    chunks, ks_qk, ks_pv = -(-D // 32), DW // 8, BK // 8
    vt_row = min(BK, 32) * 4  # bytes of a V^T row
    vt_groups, vt_swz = vt_row // 32, (_swizzle128 if vt_row == 128 else _swizzle64)
    sl2 = ops["scale"] * 1.4426950408889634
    flat = [torch.as_strided(x, (x.untyped_storage().nbytes() // 4 - x.storage_offset(),), (1,),
                             x.storage_offset()) for x in tensors]
    strides = [dims[6 + 3 * i:9 + 3 * i] for i in range(8)]
    extents = [Sq, Lk, Lk, Le, Le, Le, Le]

    def tile(i, h, s0, b, rows):  # the boxes of a row tile, one after the other (f32 elements, swizzled)
        sb, sh, ss = strides[i]
        b = 0 if sb == 0 else b
        r, x = torch.arange(rows)[:, None], torch.arange(32)[None, :]
        out = torch.zeros(chunks * rows * 32)
        for c in range(chunks):
            ok = (32 * c + x < D) & (s0 + r < extents[i])
            idx = torch.where(ok, b * sb + h * sh + (s0 + r) * ss + 32 * c + x, 0)
            out[c * rows * 32 + _swizzle128(r * 128 + x * 4).reshape(-1) // 4] = torch.where(
                ok, flat[i][idx], 0.0).reshape(-1)
        return out

    def kmajor(smem, start, rows, row=128, swz=_swizzle128):  # (rows, 8) through a K-major descriptor at `start`
        r, kc = torch.arange(rows)[:, None], torch.arange(8)[None, :]
        return smem[swz(start + (r // 8) * (8 * row) + (r % 8) * row + kc * 4) // 4]

    # the split warps: V^T (D rows of vt_row bytes of keys) from the raw V tile, each 8-key group permuted
    lane, w8 = torch.arange(32), torch.arange(8)
    pos = torch.tensor([0, 4, 1, 5, 2, 6, 3, 7])  # key w of a group -> its position in V^T's row

    def transposed(vraw):
        vt = torch.zeros(BK * D)
        for cb in range(chunks):
            d = 32 * cb + lane
            keep = d < D
            for grp in range(BK // 8):
                src = cb * BK * 32 + _swizzle128((8 * grp + w8[None, :]) * 128 + lane[:, None] * 4) // 4  # (lane, w)
                row = (grp // vt_groups) * D * vt_row + d[:, None] * vt_row + (grp % vt_groups) * 32 + pos[None, :] * 4
                vt[(vt_swz(row) // 4)[keep]] = vraw[src[keep]]
        return vt

    g, t = _LANE_G, _LANE_T
    arow, acol = _wgmma_acc_index(BK)  # the exchange's accumulator order: (thread, register) -> (row, key)
    coef, skip = ops["coef"], ops["skip"]
    has_own, n_sets = ops["has_own"], ops["n_sets"]
    out_flat = torch.zeros(flat[7].shape, dtype=torch.float64)
    for b in range(B):
        skipped = n_sets > 0 and skip is not None and bool(skip[b])
        segs = ([(1, 2, Lk)] if has_own else []) + ([(3, 4, Le)] if n_sets and not skipped else []) + (
            [(5, 6, Le)] if n_sets == 2 and not skipped else [])
        blend = n_sets == 2 and not skipped
        c = float(coef[b]) if blend else 0.0
        for h in range(H):
            for q0 in range(0, Sq, BQ):
                for rg in range(BQ // 64):
                    qt = tile(0, h, q0 + 64 * rg, b, 64)
                    # A registers of each warpgroup w (w, warp, k8 step, lane, reg): rows 16 warp + g (+8),
                    # columns DW w + 8 kk + t (+4)
                    e = torch.arange(4)
                    rr = 16 * torch.arange(4)[None, :, None, None, None] + g[None, None, None, :, None] + 8 * (e & 1)
                    cc = (DW * torch.arange(split)[:, None, None, None, None]
                          + 8 * torch.arange(ks_qk)[None, None, :, None, None] + t[None, None, None, :, None]
                          + 4 * (e >> 1))
                    qv = qt[(cc // 32) * 64 * 32 + _swizzle128(rr * 128 + (cc % 32) * 4) // 4]
                    qhi, qlo = _a_matrix(_tf32_read(qv)), _a_matrix(_tf32_read(_tf32_rest(qv)))  # (W, 4, KS, 16, 8)
                    o = torch.zeros(split, 4, 16, DW, dtype=torch.float64)
                    m = torch.full((4, 16), -math.inf, dtype=torch.float64)
                    lsum = torch.zeros(4, 16, dtype=torch.float64)
                    park = None
                    for n, (ki, vi, length) in enumerate(segs):
                        if blend and n == len(segs) - 1:  # the end segment: (1 - c) O_begin / l exchanged
                            if has_own:
                                park, (o, m, lsum) = o / lsum[..., None] * (1 - c), park
                            else:
                                park = o / lsum[..., None] * (1 - c)
                                o = torch.zeros_like(o)
                                m, lsum = torch.full_like(m, -math.inf), torch.zeros_like(lsum)
                        for r0 in range(0, length, BK):
                            kt, vraw = tile(ki, h, r0, b, BK), tile(vi, h, r0, b, BK)
                            klo = _tf32_rest(kt)  # chunk by chunk, in place of the raw K
                            vt = transposed(vraw)
                            vtlo = _tf32_rest(vt)
                            partial = []
                            for w in range(split):  # S over the warpgroup's k8 steps: (4, 16, BK), keys in order
                                offs = [(ks // 4) * BK * 128 + (ks % 4) * 32 for ks in range(w * ks_qk, (w + 1) * ks_qk)]
                                kh = torch.stack([_tf32_read(kmajor(kt, o_, BK)) for o_ in offs])  # (KS, BK, 8)
                                kl = torch.stack([_tf32_read(kmajor(klo, o_, BK)) for o_ in offs])
                                partial.append(torch.einsum("wkrc,knc->wrn", qhi[w], kh)
                                               + (torch.einsum("wkrc,knc->wrn", qlo[w], kh)
                                                  + torch.einsum("wkrc,knc->wrn", qhi[w], kl)))
                            if split == 1:
                                s = partial[0]
                            else:  # the exchange: out in accumulator order, back added by the same thread
                                xbuf = [p_.reshape(64, BK)[arow, acol] for p_ in partial]  # (128 threads, BK/2)
                                scores = []
                                for w in range(split):
                                    sw = torch.zeros(64, BK, dtype=torch.float64)
                                    sw[arow, acol] = xbuf[w] + xbuf[1 - w]
                                    scores.append(sw.reshape(4, 16, BK))
                                assert torch.equal(scores[0], scores[1])
                                s = scores[0]
                            s[..., min(BK, length - r0):] = -math.inf
                            mn = torch.maximum(m, s.max(dim=-1).values)
                            alpha = torch.exp2((m - mn) * sl2)
                            p = torch.exp2(s * sl2 - (mn * sl2)[..., None]).float()  # f32 in the kernel
                            m, lsum = mn, lsum * alpha + p.double().sum(dim=-1)
                            # P's A registers from its S registers: a = (c0, c2, c1, c3) of n8 tile j
                            pc = _c_regs(p.reshape(4, 16, BK // 8, 8).transpose(1, 2))  # (4, BK/8, 32, 4)
                            pa = pc[..., [0, 2, 1, 3]]
                            ph, pl = _a_matrix(_tf32_read(pa)), _a_matrix(_tf32_read(_tf32_rest(pa)))
                            for w in range(split):  # P V over the warpgroup's rows of V^T
                                offs = [(ks // vt_groups) * D * vt_row + w * DW * vt_row + (ks % vt_groups) * 32
                                        for ks in range(ks_pv)]
                                vh = torch.stack([_tf32_read(kmajor(vt, o_, DW, vt_row, vt_swz)) for o_ in offs])
                                vl = torch.stack([_tf32_read(kmajor(vtlo, o_, DW, vt_row, vt_swz)) for o_ in offs])
                                pv = (torch.einsum("wkrc,knc->wrn", pl, vh) + torch.einsum("wkrc,knc->wrn", ph, vl)
                                      + torch.einsum("wkrc,knc->wrn", ph, vh))  # (4, 16, DW)
                                o[w] = o[w] * alpha[..., None] + pv
                        if blend and has_own and n == 0:
                            park = (o.clone(), m, lsum)  # o itself is updated in place per warpgroup
                    o = o / lsum[..., None] * (c if blend else 1.0)
                    if blend:
                        o = o + park
                    sb, sh, ss = strides[7]
                    rows = q0 + 64 * rg + torch.arange(64).reshape(4, 16)
                    keep = (rows < Sq)[..., None].expand(4, 16, DW)
                    for w in range(split):
                        dst = b * sb + h * sh + rows[..., None] * ss + DW * w + torch.arange(DW)
                        out_flat[dst[keep]] = o[w][keep]
    out = tensors[7]
    return torch.as_strided(out_flat, out.shape, out.stride()).float()


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("mode,endpoints", [("self", None), ("fused_outer", 3), ("pure_outer", 4),
                                            ("fused_inner", None), ("pure_inner", 3), ("fused_outer", None)])
def test_flash_f32_kernel_data_movement_replayed(D, mode, endpoints):
    """The f32 attention kernel's data movement, replayed on the CPU from the
    wrapper's own C arguments, computes the attention at every head dim: the
    tensor-map boxes (zero fill past D and past each segment, a shared
    endpoint through a batch extent of 1), the 128-byte swizzle, Q's
    register fragments, the split warps' K_lo and permuted V^T, (V^T)_lo
    (128-byte rows; 64-byte rows under the 64-byte swizzle for D = 160's
    16-key tiles), the K-major descriptors, P's A fragment from the S
    registers and the raw-hi split, read as tf32; at D = 160 also the D
    split across two warpgroups and their partial-score exchange in
    accumulator order. With the outer modes' parked state and the strided
    output, on (B, S, H*D) projections viewed as (B, H, S, D), skip rows at
    both ends, q tails past the query tile, 77-key segments ragged against
    64-, 32- and 16-key tiles. f64 sums in the replay: it differs from the
    plain version by the 3xTF32 split (~2^-20 of the output) and the order
    of sums; a wrong box, swizzle, permutation, descriptor or exchange is
    O(1)."""
    from aid_tpu_torch.ops.flash_attention import kernel_operands

    g = torch.Generator().manual_seed(100 + D)
    B, H, S, L, Le = 3, 2, 70, 77, 40

    def heads(n):
        return torch.randn(B, n, H * D, generator=g).view(B, n, H, D).transpose(1, 2)

    q, k, v = heads(S), heads(L), heads(L)
    coef = torch.tensor([0.0, 0.4, 1.0])
    skip = torch.tensor([True, False, True])
    eps = {}
    if endpoints is not None:
        shape = (H, Le, D) if endpoints == 3 else (B, H, Le, D)
        eps = {n: torch.randn(shape, generator=g) for n in ("k_begin", "v_begin", "k_end", "v_end")}
    ops = kernel_operands(q, k, v, coef, mode, skip_endpoints=skip, **eps)
    assert ops["entry"] == "aid_flash_attn_f32"
    got = _emulate_flash_f32_kernel(ops)
    want = flash_interpolated_attention_plain(q, k, v, coef, mode, skip_endpoints=skip, **eps)
    assert got.shape == want.shape
    assert th.max_rel_err(got.numpy(), want.numpy()) < 1e-5


@pytest.mark.parametrize("mode", MODES)
def test_flash_kernel_operands_f32(mode):
    """kernel_operands at f32, with no device: the f32 entry, the 30 dims and
    strides of the (B, S, H*D) views and of the (B, Sq, H, D) output buffer,
    shared endpoints with a batch stride of 0, and the lerped inner endpoint
    made in f32 and kept f32 (not rounded through bf16); bf16 operands keep
    the bf16 entry, and mixed or f16 operands raise."""
    from aid_tpu_torch.ops.flash_attention import kernel_operands

    B, H, S, L, D = 3, 2, 50, 40, 80
    g = torch.Generator().manual_seed(7)

    def heads(n, dtype=torch.float32):
        return torch.randn(B, n, H * D, generator=g).to(dtype).view(B, n, H, D).transpose(1, 2)

    q, k, v = heads(S), heads(L), heads(L)
    coef = torch.tensor([0.0, 0.3, 1.0])
    eps = {n: torch.randn(H, 23, D, generator=g) for n in ("k_begin", "v_begin", "k_end", "v_end")}
    ops = kernel_operands(q, k, v, coef, mode, skip_endpoints=torch.tensor([True, False, True]), **eps)
    assert ops["entry"] == "aid_flash_attn_f32"
    assert all(x.dtype == torch.float32 for x in ops["tensors"])
    dims = ops["dims"]
    assert len(dims) == 30 and dims[:6] == [B, H, S, L, 40 if mode == "self" else 23, D][:4] + dims[4:5] + [D]
    assert dims[6:9] == [S * H * D, D, H * D]  # q: (b, h, s) element strides of the view
    out = ops["tensors"][-1]
    assert out.shape == (B, H, S, D) and dims[27:30] == [S * H * D, D, H * D]
    if mode == "self":
        assert ops["coef"] is None and ops["skip"] is None and ops["n_sets"] == 0
    elif AttnMode(mode).is_inner:
        kb = ops["tensors"][3]
        want = (1 - coef.reshape(B, 1, 1, 1)) * eps["k_begin"] + coef.reshape(B, 1, 1, 1) * eps["k_end"]
        assert kb.dtype == torch.float32 and torch.equal(kb, want)  # exact: made in f32 and kept f32
        assert ops["n_sets"] == 1 and dims[15:18] == [H * 23 * D, 23 * D, D]
    else:
        assert ops["n_sets"] == 2 and dims[15:18] == [0, 23 * D, D]  # shared: a batch stride of 0
    assert (ops["skip"] is not None) == AttnMode(mode).is_fused
    assert kernel_operands(q.bfloat16(), k.bfloat16(), v.bfloat16())["entry"] == "aid_flash_attn_bf16"
    with pytest.raises(NotImplementedError):
        kernel_operands(q, k.bfloat16(), v.bfloat16())
    with pytest.raises(NotImplementedError):
        kernel_operands(q.half(), k.half(), v.half())


# head dims that no instance takes, in every mode, and one past 160 in self mode
PAD_CASES = [(D, mode) for D in (16, 32, 48, 100) for mode in MODES] + [(200, "self")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D,mode", PAD_CASES)
def test_flash_operands_pad_head_dims(D, mode, dtype):
    """A head dim that no kernel instance takes is zero-padded, as the JAX
    wrapper pads (aid_tpu/ops/flash_attention.py:784, 800-801): below 160 to
    the next of 40/64/80/160 in every mode (kernel_operands), between 160
    and 512 to 512 in self mode (d512_operands). Every operand the entry
    reads has the padded head dim with zeros past D, the scale is the
    unpadded D's, and ``out`` is the output sliced back to D. The padded
    call replayed on the CPU (the bf16 and f32 kernels' replays above; at
    D = 200 the bf16 D=512 kernel's replay, in f32 the padded operands' own
    softmax at the entry's scale) computes the plain version at the
    unpadded D, with skip rows at both ends and shared endpoints of their
    own ragged length; at D = 48 it is held against the JAX wrapper in
    interpret mode too. f32 to 1e-5 of max |ref| (the 3xTF32 split and the
    order of sums), bf16 to 1e-2 (P's bf16 rounding and the output's)."""
    from aid_tpu_torch.ops.attention import _softmax_attn
    from aid_tpu_torch.ops.flash_attention import d512_operands, kernel_operands, padded_head_dim

    g = torch.Generator().manual_seed(300 + D)
    B, H, S, L, Le = 3, 2, 70, 37, 21
    f32 = dtype == torch.float32

    def heads(n):
        return torch.randn(B, n, H * D, generator=g).to(dtype).view(B, n, H, D).transpose(1, 2)

    q, k, v = heads(S), heads(L), heads(L)
    coef = torch.tensor([0.0, 0.4, 1.0])
    skip = torch.tensor([True, False, True])
    eps = {} if mode == "self" else {n: torch.randn(H, Le, D, generator=g).to(dtype)
                                     for n in ("k_begin", "v_begin", "k_end", "v_end")}
    Dp = padded_head_dim(D, mode)
    assert Dp == {16: 40, 32: 40, 48: 64, 100: 160, 200: 512}[D]
    if Dp == 512:
        ops = d512_operands(q, k, v)
        assert ops["dims"][:4] == [B, H, S, L]
        if f32:
            qp, kp, vp = ops["tensors"][:3]
            got = _softmax_attn(qp.double(), kp.double(), vp.double(), ops["scale"]).float()
        else:
            got = _emulate_flash_bf16_d512_kernel(ops)
    else:
        ops = kernel_operands(q, k, v, coef, mode, skip_endpoints=skip, **eps)
        assert ops["dims"][5] == Dp
        got = _emulate_flash_f32_kernel(ops) if f32 else _emulate_flash_kernel(ops)
    assert all(x.shape[-1] == Dp and not x[..., D:].any() for x in ops["tensors"][:-1])
    assert ops["head_dim"] == D and ops["scale"] == D ** -0.5
    out = ops["out"]
    assert out.shape == (B, H, S, D) and out.data_ptr() == ops["tensors"][-1].data_ptr()
    got = got[..., :D]
    want = flash_interpolated_attention_plain(q.float(), k.float(), v.float(), coef, mode, skip_endpoints=skip,
                                              **{n: e.float() for n, e in eps.items()})
    tol = 1e-5 if f32 else 1e-2
    assert got.shape == want.shape
    assert th.max_rel_err(got.float().numpy(), want.numpy()) < tol
    if D == 48:
        jax_want = jax_flash(*(jnp.asarray(x.float().numpy()) for x in (q, k, v)), jnp.asarray(coef.numpy()), mode,
                             skip_endpoints=jnp.asarray(skip.numpy()), block_q=64, block_k=64, interpret=True,
                             **{n: jnp.asarray(e.float().numpy()) for n, e in eps.items()})
        assert th.max_rel_err(got.float().numpy(), np.asarray(jax_want)) < (FLASH_TOL if f32 else 1e-2)


def test_flash_f32_tile_constants_follow_the_kernel_source():
    """ops/flash_attention.py's f32 tile table, which the replay above uses,
    is the one csrc/flash_interpolated_attention_f32.cu compiles with: query
    rows, keys per tile and ring stages for every head dim, one wgmma
    instance each, and the D split (kSplit: two warpgroups above D = 128,
    so at 160 alone). The header's table agrees with the shared memory
    Cfg<D> adds up: the Q / parked regions, the exchange, the stages (raw
    K, raw V, K_lo and V^T, (V^T)_lo), all within the 227 KB a block can
    use; no mma.sync instance is left."""
    import re
    from pathlib import Path

    from aid_tpu_torch.ops import flash_attention as FA

    src = (Path(FA.__file__).resolve().parents[1] / "csrc" / "flash_interpolated_attention_f32.cu").read_text()
    pat = r"struct Tiles<(\d+)> \{ static constexpr int kBQ = (\d+), kBK = (\d+), kStages = (\d+); \};"
    found = {int(d): (int(bq), int(bk), int(st)) for d, bq, bk, st in re.findall(pat, src)}
    assert found == FA.KERNEL_F32_TILES
    assert sorted(found) == HEAD_DIMS
    assert "kSplit = D > 128 ? 2 : 1;" in src
    assert FA.KERNEL_F32_D_SPLIT == {d: 2 if d > 128 else 1 for d in HEAD_DIMS}
    assert "mma.sync" not in src and "namespace mma" not in src
    table = {int(r[0]): tuple(int(x.replace(",", "")) for x in r[1:])
             for r in re.findall(r"^//\s+(\d+)\s+(\d+)\s+(\d+)\s+(\d+)\s+\d+ x \d+\s+(\d+)\s+([\d,]+)\s+\d+$",
                                 src, re.M)}
    assert sorted(table) == HEAD_DIMS
    for d, (bq, bk, stages) in FA.KERNEL_F32_TILES.items():
        split = FA.KERNEL_F32_D_SPLIT[d]
        chunks, slot = -(-d // 32), d // split // 2 + 4
        region = -(-max(64 * 128 * chunks, split * 128 * slot * 4) // 1024) * 1024
        xbytes = 2 * split * (bk // 2) * 128 * 4 if split > 1 else 0
        stage = 3 * bk * 128 * chunks + 2 * bk * 4 * d
        smem = 1024 + bq // 64 * (region + xbytes) + stages * stage + (3 * stages + 1) * 8
        assert table[d] == (bq, bk, stages, stage, smem)
        assert smem <= 232448


def _emulate_conv_f32_kernel(x, w, b, *factors):
    """csrc/conv3x3_f32.cu's data movement, replayed in plain torch (f64
    arithmetic on the operands as the tensor cores read them, tf32).

    The operands go through ``kernel_operands``' f32 layouts (with
    ``factors``, the GN+SiLU prologue's scale and shift, applied by the
    layout pass): x as (2, B, Cin/4, H, W, 4), the 4-channel blocked copy and
    then its lo part; w tiled by N tile and 8-channel K chunk, raw then lo.
    Per block and chunk the stage is built as bytes of shared memory: the
    kernel's two TMA boxes (8-byte elements of the map whose dim 3 runs over
    the raw images and then the lo ones: image b, then image B + b; zeros
    outside the tensor) and the chunk's weights as one contiguous run. Each
    warpgroup (one output row) reads every tap's operands through the
    no-swizzle K-major descriptors the kernel builds (start address moved by
    (dy * 66 + dx) * 16 bytes, LBO between the two 4-channel groups of a k8
    step, SBO between 8-row groups), sums the chunk's 27 products (hi*hi +
    hi*lo + lo*hi, hi the raw value) from zero and folds the sum into its
    accumulator; the store is masked and channels-last. A layout, box or
    descriptor that disagrees with the others breaks the conv."""
    from aid_tpu_torch.ops import conv as C

    xb, wt, bf, fac = C.kernel_operands(x, w, b, *factors)
    assert fac == ()  # the prologue is the layout pass's: the conv launch takes no factors
    parts, B, G, H, W, _ = xb.shape
    assert parts == 2
    Cout, BN, KC = bf.shape[0], C.F32_N_TILE, C.F32_K_CHUNK
    TR, TW = C.F32_TILE_ROWS, C.F32_TILE_COLS
    WR, WC = TR + 2, TW + 2
    plane = WR * WC * 16  # bytes of one 4-channel group of the window
    win_bytes, tap_bytes = 2 * plane, 2 * BN * 16
    wts_bytes = 9 * tap_bytes
    xe = xb.reshape(2 * B, G, H, 2 * W, 2)  # the map: 8-byte elements, raw images then lo images
    m = torch.arange(TW)[:, None]
    n = torch.arange(BN)[:, None]
    k = torch.arange(KC)[None, :]

    def operand(start, rows, lbo):  # f32 element index of (row, k) through a no-swizzle K-major descriptor
        return (start + (rows // 8) * 128 + (rows % 8) * 16 + (k // 4) * lbo + (k % 4) * 4) // 4

    out = torch.zeros(B, Cout, H, W, dtype=torch.float64)
    for bi in range(B):
        for y0 in range(0, H, TR):
            for x0 in range(0, W, TW):
                for nt in range(wt.shape[0]):
                    acc = torch.zeros(TR, TW, BN, dtype=torch.float64)
                    for kt in range(wt.shape[1]):
                        stage = []
                        for img in (bi, B + bi):  # the raw window's box, then the lo window's
                            box = torch.zeros(2, WR, 2 * WC, 2)  # (groups, rows, elements, f32)
                            for g in range(2):
                                for r in range(WR):
                                    gy, yy = 2 * kt + g, y0 - 1 + r
                                    if gy < G and 0 <= yy < H:
                                        e0 = 2 * (x0 - 1)
                                        lo, hi = max(e0, 0), min(e0 + 2 * WC, 2 * W)
                                        box[g, r, lo - e0:hi - e0] = xe[img, gy, yy, lo:hi]
                            stage.append(box.reshape(-1))
                        stage.append(wt[nt, kt].reshape(-1))  # one bulk copy: raw weights, then lo
                        smem = _tf32_read(torch.cat(stage))
                        for r in range(TR):  # warpgroup r: output row y0 + r
                            part = torch.zeros(TW, BN, dtype=torch.float64)
                            for tap in range(9):
                                dy, dx = divmod(tap, 3)
                                a_at = (r * WC + dy * WC + dx) * 16
                                ahi, alo = (smem[operand(p + a_at, m, plane)] for p in (0, win_bytes))
                                bhi, blo = (smem[operand(p + tap * tap_bytes, n, BN * 16)]
                                            for p in (2 * win_bytes, 2 * win_bytes + wts_bytes))
                                part += ahi @ bhi.T + ahi @ blo.T + alo @ bhi.T
                            acc[r] += part  # the chunk's sum, folded
                    for r in range(TR):
                        y, xs, nn = y0 + r, min(TW, W - x0), min(BN, Cout - nt * BN)
                        if y < H:
                            out[bi, nt * BN:nt * BN + nn, y, x0:x0 + xs] = (
                                acc[r, :xs, :nn].T + bf[nt * BN:nt * BN + nn, None].double())
    return out.float()


@pytest.mark.parametrize("B,Cin,Cout,H,W", [
    (1, 12, 24, 5, 7),      # Cin % 8 != 0 (the last chunk's second block zero-filled), ragged everything
    (2, 16, 170, 3, 70),    # two column tiles, two N tiles (the second ragged), a half row tile
    (1, 20, 26, 3, 96),     # W = 96 (SD 2.1): a full and a half-empty column tile; Cin % 8 == 4, Cout ragged
])
def test_conv_f32_kernel_layouts_replayed(B, Cin, Cout, H, W):
    """The f32 conv kernel's operand layouts (4-channel blocks followed by
    their lo part, the (N tile, 8-channel chunk, [raw, lo], tap, 2, 160, 4)
    weight tiling), TMA boxes, bulk copy, shifted no-swizzle descriptors and
    per-chunk fold, replayed on the CPU from kernel_operands, compute the
    conv in 3xTF32: within 1e-5 of max |out| of the f32 conv."""
    from aid_tpu_torch.ops.conv import conv3x3_same_plain

    g = torch.Generator().manual_seed(6)
    x = torch.randn(B, Cin, H, W, generator=g) * 2 + 1
    w = torch.randn(Cout, Cin, 3, 3, generator=g) * (9 * Cin) ** -0.5
    b = torch.randn(Cout, generator=g)
    got = _emulate_conv_f32_kernel(x, w, b)
    want = conv3x3_same_plain(x, w, b)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("B,Cin,Cout,H,W,groups", [
    (1, 12, 24, 5, 7, 4),     # Cin % 8 != 0, ragged everything
    (2, 16, 170, 3, 70, 8),   # two column tiles, two N tiles, a half row tile
])
def test_conv_gnsilu_f32_kernel_replayed(B, Cin, Cout, H, W, groups):
    """The f32 GN+SiLU conv: the prologue applied in the layout pass (the
    blocked copy holds silu(x * scale + shift) and its lo part), then the f32
    conv kernel's boxes, descriptors and fold replayed unchanged, compute conv3x3_gnsilu_plain;
    the window's zero fill outside the image is the zero halo after the
    prologue. Input and gamma/beta far from 0/1, so a halo that took
    silu(shift) would show on the border. 3xTF32 in the replay."""
    from aid_tpu_torch.ops.conv import conv3x3_gnsilu_plain, gn_scale_shift

    g = torch.Generator().manual_seed(7)
    x = torch.randn(B, Cin, H, W, generator=g) * 3 + 1.5
    w = torch.randn(Cout, Cin, 3, 3, generator=g) * (9 * Cin) ** -0.5
    b = torch.randn(Cout, generator=g)
    gamma, beta = 1 + 0.3 * torch.randn(Cin, generator=g), 0.5 * torch.randn(Cin, generator=g)
    got = _emulate_conv_f32_kernel(x, w, b, *gn_scale_shift(x, gamma, beta, groups, 1e-5))
    want = conv3x3_gnsilu_plain(x, w, b, gamma, beta, groups)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_conv_gnsilu_f32_operands():
    """kernel_operands with f32 factors: x laid out with the prologue
    applied (blocked_input_plain of silu_affine(x)), the factors consumed;
    bf16 passes them on to its kernel, as before."""
    from aid_tpu_torch.ops import conv as C

    g = torch.Generator().manual_seed(8)
    x = torch.randn(2, 8, 3, 5, generator=g) * 2 + 1
    w, b = torch.randn(6, 8, 3, 3, generator=g), torch.randn(6, generator=g)
    sc, sh = torch.randn(2, 8, generator=g), torch.randn(2, 8, generator=g)
    xb, wt, bf, fac = C.kernel_operands(x, w, b, sc, sh)
    want = F.silu(x * sc[:, :, None, None] + sh[:, :, None, None])
    assert fac == () and torch.equal(xb, C.blocked_input_plain(want))
    assert torch.equal(xb, C.blocked_input(x, sc, sh)) and xb.shape == (2, 2, 2, 3, 5, 4)
    assert torch.equal(xb[1], C.tf32_rest(xb[0])) and xb[1].any()
    xb16, _, _, fac16 = C.kernel_operands(x.bfloat16(), w.bfloat16(), b, sc, sh)
    assert torch.equal(xb16, C.blocked_input_plain(x.bfloat16())) and len(fac16) == 2


@pytest.mark.parametrize("hw,cin,cout,groups", [(16, 64, 48, 8), (8, 32, 32, 32)])
def test_conv_gnsilu_f32_plain_matches_pallas_interpret(hw, cin, cout, groups):
    """The f32 conv3x3_gnsilu (and conv3x3_gnsilu_f32, on the CPU its plain
    version) against the JAX conv3x3_gnsilu in f32 through the Pallas kernel
    in interpret mode, within 1e-5 of max |ref|: both compute the one-pass
    statistics and the f32 prologue, then an f32 conv; only summation order
    differs (~1e-7)."""
    from aid_tpu_torch.ops.conv import conv3x3_gnsilu_f32

    x = th.normal(61, (2, hw, hw, cin), scale=3.0) + 1.5
    w = th.normal(62, (3, 3, cin, cout), scale=cin ** -0.5)
    b = th.normal(63, (cout,))
    gamma, beta = 1.0 + th.normal(64, (cin,), scale=0.3), th.normal(65, (cin,), scale=0.5)
    want = np.asarray(jax_conv3x3_gnsilu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jnp.asarray(gamma),
                                         jnp.asarray(beta), num_groups=groups, block_rows=8, interpret=True))
    args = (th.nhwc_to_nchw(x), torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))), torch.from_numpy(b),
            torch.from_numpy(gamma), torch.from_numpy(beta), groups)
    for fn in (conv3x3_gnsilu, conv3x3_gnsilu_f32):
        got = fn(*args)
        assert got.dtype == torch.float32
        assert th.max_rel_err(th.nchw_to_nhwc(got), want) < 1e-5


def test_conv_f32_layouts():
    """The f32 layouts the kernel reads: blocked_input_plain puts 4 channels
    (16 bytes) in a block and follows the blocks with their lo part, and
    tiled_weight tiles an f32 weight as (N tile, 8-channel chunk, [raw, lo],
    dy, dx, channel group, co, ci % 4) with zeros past Cout and Cin, kept
    apart from a bf16 copy's tiling; raw + lo is the weight, lo is what tf32
    drops."""
    from aid_tpu_torch.ops import conv as C
    from aid_tpu_torch.ops.conv import blocked_input_plain, tiled_weight

    g = torch.Generator().manual_seed(9)
    x = torch.randn(2, 12, 3, 5, generator=g)
    xb = blocked_input_plain(x)
    assert xb.shape == (2, 2, 3, 3, 5, 4) and torch.equal(xb[0, 1, 2, 1, 4], x[1, 8:12, 1, 4])
    assert xb[1].any() and torch.equal(xb[1], C.tf32_rest(xb[0]))
    assert blocked_input_plain(torch.zeros(1, 16, 2, 2, dtype=torch.bfloat16)).shape == (1, 2, 2, 2, 8)
    w = torch.randn(170, 20, 3, 3, generator=g)
    wt = tiled_weight(w)
    assert wt.shape == (2, 3, 2, 3, 3, 2, 160, 4) and wt.dtype == torch.float32
    assert torch.equal(wt[1, 2, 0, 2, 0, 0, 9, 3], w[169, 19, 2, 0]) and not wt[1, 2, :, :, :, 1].any()
    assert not wt[1, :, :, :, :, :, 10:].any()
    assert torch.equal(wt[:, :, 1], C.tf32_rest(wt[:, :, 0])) and wt[:, :, 1].any()
    wb = w.bfloat16()
    assert tiled_weight(wb).shape == (2, 2, 3, 3, 2, 160, 8) and tiled_weight(w) is wt


def test_conv_f32_tile_constants_follow_the_kernel_source():
    """ops/conv.py's f32 tile constants, which the f32 weight tiling and the
    replay above use, are the ones csrc/conv3x3_f32.cu compiles with; the
    stage the replay builds (two window boxes, raw and lo weights) is the
    kernel's kStageBytes, and two stages fit the 227 KB a block can use."""
    import re
    from pathlib import Path

    from aid_tpu_torch.ops import conv as C

    src = (Path(C.__file__).resolve().parents[1] / "csrc" / "conv3x3_f32.cu").read_text()
    found = {name: int(v) for name, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (found["kTR"], found["kTW"], found["kBN"], found["kKc"], found["kStages"]) == (
        C.F32_TILE_ROWS, C.F32_TILE_COLS, C.F32_N_TILE, C.F32_K_CHUNK, C.F32_STAGES)
    window = (C.F32_TILE_ROWS + 2) * (C.F32_TILE_COLS + 2) * 16 * 2  # two 4-channel groups
    weights = 9 * 2 * C.F32_N_TILE * 16  # one part of a chunk's weights
    assert "kStageBytes = 2 * kWinBytes + 2 * kWtsBytes" in src
    assert C.F32_STAGES * (2 * window + 2 * weights) + 2 * C.F32_STAGES * 8 + 128 <= 232448
    assert re.search(r"kThreads = (\d+);", src).group(1) == str(128 * C.F32_TILE_ROWS)  # a warpgroup a row


@pytest.mark.parametrize("passes,within", [(3, True), (1, False)])
def test_three_tf32_passes_keep_the_f32_conv_promise(passes, within):
    """Why the f32 conv kernel spends three tensor-core passes per product:
    an SDXL-like conv's GEMM at K = 9 * 960 (256 output pixels, 64 output
    channels, x ~ N(0, 1), w ~ N(0, 1/K)) in 3xTF32 stays within the f32
    conv's 1e-4 of max |out| (chip_smoke.py's F32_CONV_TOL) of the f64
    result; plain TF32 misses it."""
    f32_conv_tol = 1e-4
    rng = np.random.default_rng(1)
    K = 9 * 960
    patches = torch.from_numpy(rng.standard_normal((256, K), dtype=np.float32))
    w = torch.from_numpy((rng.standard_normal((64, K)) * K ** -0.5).astype(np.float32))
    want = patches.double() @ w.double().T
    got = _tf32_matmul(patches, w, passes)
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert (err < f32_conv_tol) == within, err
