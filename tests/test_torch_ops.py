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
    devices have no route; reference_ops nests."""
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


@pytest.mark.parametrize("passes,within", [(3, True), (1, False)])
def test_three_tf32_passes_keep_the_f32_attention_promise(passes, within):
    """Why the f32 D=512 kernel spends three tensor-core passes per product:
    softmax(Q K^T / sqrt(d)) V at (1, 1, 1024, 512) with both products in
    3xTF32 stays within the f32 attention's 1e-4 of max |out| (chip_smoke.py's
    F32_ATTN_TOL, the VAE decode's promise) of the f64 result; plain TF32
    misses it."""
    f32_attn_tol = 1e-4
    rng = np.random.default_rng(0)
    S, D = 1024, 512
    q, k, v = (torch.from_numpy(rng.standard_normal((S, D), dtype=np.float32)) for _ in range(3))
    want = torch.softmax(q.double() @ k.double().T * D ** -0.5, dim=-1) @ v.double()
    p = torch.softmax(_tf32_matmul(q, k, passes) * D ** -0.5, dim=-1).float()
    got = _tf32_matmul(p, v.T.contiguous(), passes)
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
