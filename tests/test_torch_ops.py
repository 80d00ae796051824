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


def _emulate_flash_f32_kernel(ops: dict) -> torch.Tensor:
    """csrc/flash_interpolated_attention_f32.cu's data movement, replayed in
    plain torch (f64 arithmetic) from the C entry's own arguments
    (``kernel_operands``): each block's 64-row Q tile and each segment's
    K/V tiles copied row by row at the operands' strides into tiles of the
    kernel's pitches (zeros past the segment; a batch stride of 0 reads one
    shared endpoint), every product through the m16n8k8 fragments the kernel
    loads (Q and K pairs of columns 2t, 2t + 1; P from the S accumulator;
    V rows 2t, 2t + 1 of column g), the online softmax with the masked key
    tail, the outer modes' parked state and the strided output store."""
    from aid_tpu_torch.ops.flash_attention import KERNEL_F32_ROWS, KERNEL_F32_TILES

    tensors, dims = ops["tensors"], ops["dims"]
    B, H, Sq, Lk, Le, D = dims[:6]
    BK, LDQ, LDV = KERNEL_F32_TILES[D]
    BQ, NT = KERNEL_F32_ROWS, D // 8
    sl2 = ops["scale"] * 1.4426950408889634
    flat = [torch.as_strided(x, (x.untyped_storage().nbytes() // 4 - x.storage_offset(),), (1,),
                             x.storage_offset()).double() for x in tensors]
    strides = [dims[6 + 3 * i:9 + 3 * i] for i in range(8)]

    def rows_tile(i, b, h, row0, length, rows, ld):  # load_rows: rows past `length` zero-filled
        sb, sh, ss = strides[i]
        tile = torch.zeros(rows * ld, dtype=torch.float64)
        r = torch.arange(rows)[:, None]
        c = torch.arange(D)[None, :]
        ok = (row0 + r < length).expand(rows, D)
        idx = torch.where(ok, b * sb + h * sh + (row0 + r) * ss + c, 0)
        tile[(r * ld + c)[ok]] = flat[i][idx[ok]]
        return tile

    offa, offb = _pair_offsets(LDQ, True), _pair_offsets(LDQ, False)
    lane_g, lane_t = _LANE_G, _LANE_T
    coef, skip = ops["coef"], ops["skip"]
    has_own, n_sets = ops["has_own"], ops["n_sets"]
    out_flat = torch.zeros_like(flat[7])
    for b in range(B):
        skipped = n_sets > 0 and skip is not None and bool(skip[b])
        segs = ([(1, 2, Lk)] if has_own else []) + ([(3, 4, Le)] if n_sets and not skipped else []) + (
            [(5, 6, Le)] if n_sets == 2 and not skipped else [])
        blend = n_sets == 2 and not skipped
        c = float(coef[b]) if blend else 0.0
        for h in range(H):
            for q0 in range(0, Sq, BQ):
                qt = rows_tile(0, b, h, q0, Sq, BQ, LDQ)
                # A registers of every warp and k step: (warp, kk, lane, reg)
                a_idx = (torch.arange(4)[:, None, None, None] * 16 * LDQ + torch.arange(NT)[None, :, None, None] * 8
                         + offa[None, None])
                qa = _a_matrix(qt[a_idx])  # (4, NT, 16, 8)
                o = torch.zeros(4, 16, D, dtype=torch.float64)
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
                        kt = rows_tile(ki, b, h, r0, length, BK, LDQ)
                        vt = rows_tile(vi, b, h, r0, length, BK, LDV)
                        b_idx = (torch.arange(BK // 8)[:, None, None, None] * 8 * LDQ
                                 + torch.arange(NT)[None, :, None, None] * 8 + offb[None, None])
                        kb_ = _b_matrix(kt[b_idx])  # (BK/8, NT, 8, 8)
                        s_mat = torch.einsum("wkrc,nkcm->wnrm", qa, kb_)  # (4, BK/8, 16, 8)
                        s = torch.cat(list(s_mat.unbind(1)), dim=-1)  # (4, 16, BK)
                        s[..., min(BK, length - r0):] = -math.inf
                        mn = torch.maximum(m, s.max(dim=-1).values)
                        alpha = torch.exp2((m - mn) * sl2)
                        p = torch.exp2(s * sl2 - (mn * sl2)[..., None])
                        m, lsum = mn, lsum * alpha + p.sum(dim=-1)
                        # P's A registers from its C registers: a = (c0, c2, c1, c3)
                        pc = _c_regs(p.reshape(4, 16, BK // 8, 8).transpose(1, 2))  # (4, BK/8, 32, 4)
                        pa = _a_matrix(pc[..., [0, 2, 1, 3]])
                        v_idx = ((torch.arange(BK // 8)[:, None, None] * 8 + 2 * lane_t[None, None, :]) * LDV
                                 + torch.arange(NT)[None, :, None] * 8 + lane_g[None, None, :])
                        vb_ = _b_matrix(torch.stack([vt[v_idx], vt[v_idx + LDV]], -1))  # (BK/8, NT, 8, 8)
                        pv = torch.einsum("wkrc,kncm->wnrm", pa, vb_)  # (4, NT, 16, 8)
                        o = o * alpha[..., None] + torch.cat(list(pv.unbind(1)), dim=-1)
                    if blend and has_own and n == 0:
                        park = (o, m, lsum)
                o = o / lsum[..., None] * (c if blend else 1.0)
                if blend:
                    o = o + park
                sb, sh, ss = strides[7]
                rows = q0 + torch.arange(64).reshape(4, 16)
                keep = (rows < Sq)[..., None].expand(4, 16, D)
                dst = b * sb + h * sh + rows[..., None] * ss + torch.arange(D)
                out_flat[dst[keep]] = o[keep]
    out = tensors[7]
    return torch.as_strided(out_flat, out.shape, out.stride()).float()


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("mode,endpoints", [("self", None), ("fused_outer", 3), ("pure_outer", 4),
                                            ("fused_inner", None), ("pure_inner", 3), ("fused_outer", None)])
def test_flash_f32_kernel_data_movement_replayed(D, mode, endpoints):
    """The f32 attention kernel's tile copies (the operands' strides, zeros
    past each segment, shared endpoints through a batch stride of 0), its
    m16n8k8 fragments with the permuted k order, P taken from the S
    accumulator, the outer modes' parked state and the strided output,
    replayed on the CPU from the wrapper's own C arguments, compute the
    attention: on (B, S, H*D) projections viewed as (B, H, S, D), skip rows
    at both ends, q tails past the 64-row tile, 77-key segments (ragged in
    64- and 32-key tiles). f64 arithmetic in the replay, so only the order
    of sums differs from the plain version."""
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


def test_flash_f32_tile_constants_follow_the_kernel_source():
    """ops/flash_attention.py's f32 tile table, which the replay above uses,
    is the one csrc/flash_interpolated_attention_f32.cu compiles with."""
    import re
    from pathlib import Path

    from aid_tpu_torch.ops import flash_attention as FA

    src = (Path(FA.__file__).resolve().parents[1] / "csrc" / "flash_interpolated_attention_f32.cu").read_text()
    pat = r"struct Tiles<(\d+)> \{ static constexpr int kBK = (\d+), kLdQK = (\d+), kLdV = (\d+); \};"
    found = {int(d): (int(bk), int(lq), int(lv)) for d, bk, lq, lv in re.findall(pat, src)}
    assert found == FA.KERNEL_F32_TILES
    assert int(re.search(r"constexpr int kBQ = (\d+);", src).group(1)) == FA.KERNEL_F32_ROWS


def _emulate_conv_f32_kernel(x, w, b, *factors):
    """csrc/conv3x3_f32.cu's data movement, replayed in plain torch (f64
    arithmetic): the operands through ``kernel_operands``' f32 layouts (with
    ``factors``, the GN+SiLU prologue's scale and shift, applied by the
    layout pass; x in
    4-channel blocks, w tiled by N tile and 8-channel K chunk); per block
    and chunk the (2 + 2) x (64 + 2) window copied 16 bytes a pixel and block
    (zeros outside the image and past Cin) into 8-float pixels, and the
    chunk's weights as one contiguous run; each warp's m16n8k8 fragments read
    as the kernel addresses them for every tap (pixel row g and g + 8 of the
    shifted window, channels 2t and 2t + 1; weight row g); each chunk's sum
    added to the accumulators; the masked channels-last store."""
    from aid_tpu_torch.ops import conv as C

    xb, wt, bf, fac = C.kernel_operands(x, w, b, *factors)
    assert fac == ()  # the prologue is the layout pass's: the conv launch takes no factors
    B, G, H, W, _ = xb.shape
    Cin, Cout, BN, KC = 4 * G, bf.shape[0], C.F32_N_TILE, C.F32_K_CHUNK
    TR, TW = C.F32_TILE_ROWS, C.F32_TILE_COLS
    WR, WC = TR + 2, TW + 2
    xd, wd = xb.double(), wt.double()
    offa, offb = _pair_offsets(KC, True), _pair_offsets(KC, False)
    warp = torch.arange(8)
    wm, wn = warp % 4, warp // 4
    r, xw = wm // 2, (wm % 2) * 32
    tap = torch.arange(9)
    dy, dx = tap // 3, tap % 3
    mi, nj = torch.arange(2), torch.arange(BN // 2 // 8)
    # A register addresses: (warp, tap, mi, lane, reg); B: (warp, tap, nj, lane, reg)
    a_idx = (((r[:, None, None] + dy[None, :, None]) * WC + xw[:, None, None] + 16 * mi[None, None, :]
              + dx[None, :, None]) * KC)[..., None, None] + offa
    b_idx = ((tap[None, :, None] * BN + wn[:, None, None] * (BN // 2) + 8 * nj[None, None, :]) * KC)[..., None, None] + offb
    out = torch.zeros(B, Cout, H, W, dtype=torch.float64)
    py, px = torch.arange(WR)[:, None], torch.arange(WC)[None, :]
    for bi in range(B):
        for y0 in range(0, H, TR):
            for x0 in range(0, W, TW):
                for nt in range(wt.shape[0]):
                    acc = torch.zeros(8, 2, BN // 2 // 8, 16, 8, dtype=torch.float64)
                    for kt in range(wt.shape[1]):
                        win = torch.zeros(WR, WC, KC, dtype=torch.float64)
                        iy, ix = y0 - 1 + py, x0 - 1 + px
                        inside = ((iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)).expand(WR, WC)
                        for j in range(2):
                            cg = 2 * kt + j
                            if cg < G:
                                win[..., 4 * j:4 * j + 4][inside] = xd[bi, cg][iy.clamp(0, H - 1),
                                                                              ix.clamp(0, W - 1)][inside]
                        win, wts = win.reshape(-1), wd[nt, kt].reshape(-1)
                        am = _a_matrix(win[a_idx])  # (warp, tap, mi, 16, 8)
                        bm = _b_matrix(wts[b_idx])  # (warp, tap, nj, 8, 8)
                        acc += torch.einsum("wtmrc,wtnck->wmnrk", am, bm)  # the chunk's sum over taps, added
                    for w_ in range(8):
                        y = y0 + int(r[w_])
                        if y >= H:
                            continue
                        for m in range(2):
                            xs = x0 + int(xw[w_]) + 16 * m + torch.arange(16)
                            for n in range(BN // 2 // 8):
                                co = nt * BN + int(wn[w_]) * (BN // 2) + 8 * n + torch.arange(8)
                                keep_x, keep_c = xs < W, co < Cout
                                blk = acc[w_, m, n][keep_x][:, keep_c]
                                out[bi, co[keep_c][None, :], y, xs[keep_x][:, None]] = blk + bf[co[keep_c]].double()
    return out.float()


@pytest.mark.parametrize("B,Cin,Cout,H,W", [
    (1, 12, 24, 5, 7),      # Cin % 8 != 0 (the last chunk's second block zero-filled), ragged everything
    (2, 16, 170, 3, 70),    # two column tiles, two N tiles (the second ragged), a half row tile
])
def test_conv_f32_kernel_layouts_replayed(B, Cin, Cout, H, W):
    """The f32 conv kernel's operand layouts (4-channel blocks, the (N tile,
    8-channel chunk, tap, 160, 8) weight tiling), window and weight copies and
    m16n8k8 fragments, replayed on the CPU from kernel_operands, compute the
    conv. f64 in the replay: only the order of sums differs."""
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
    blocked copy holds silu(x * scale + shift)), then the f32 conv kernel's
    copies and fragments replayed unchanged, compute conv3x3_gnsilu_plain;
    the window's zero fill outside the image is the zero halo after the
    prologue. Input and gamma/beta far from 0/1, so a halo that took
    silu(shift) would show on the border. f64 in the replay."""
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
    assert torch.equal(xb, C.blocked_input(x, sc, sh)) and xb.shape == (2, 2, 3, 5, 4)
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
    (16 bytes) in a block, and tiled_weight tiles an f32 weight as (N tile,
    8-channel chunk, dy, dx, co, ci % 8) with zeros past Cout and Cin, kept
    apart from a bf16 copy's tiling."""
    from aid_tpu_torch.ops.conv import blocked_input_plain, tiled_weight

    g = torch.Generator().manual_seed(9)
    x = torch.randn(2, 12, 3, 5, generator=g)
    xb = blocked_input_plain(x)
    assert xb.shape == (2, 3, 3, 5, 4) and torch.equal(xb[1, 2, 1, 4], x[1, 8:12, 1, 4])
    assert blocked_input_plain(torch.zeros(1, 16, 2, 2, dtype=torch.bfloat16)).shape == (1, 2, 2, 2, 8)
    w = torch.randn(170, 20, 3, 3, generator=g)
    wt = tiled_weight(w)
    assert wt.shape == (2, 3, 3, 3, 160, 8) and wt.dtype == torch.float32
    assert torch.equal(wt[1, 2, 2, 0, 9, 3], w[169, 19, 2, 0]) and not wt[1, 2, :, :, :, 4:].any()
    assert not wt[1, :, :, :, 10:].any()
    wb = w.bfloat16()
    assert tiled_weight(wb).shape == (2, 2, 3, 3, 2, 160, 8) and tiled_weight(w) is wt


def test_conv_f32_tile_constants_follow_the_kernel_source():
    """ops/conv.py's f32 tile constants, which the f32 weight tiling and the
    replay above use, are the ones csrc/conv3x3_f32.cu compiles with."""
    import re
    from pathlib import Path

    from aid_tpu_torch.ops import conv as C

    src = (Path(C.__file__).resolve().parents[1] / "csrc" / "conv3x3_f32.cu").read_text()
    found = {name: int(v) for name, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (found["kTR"], found["kTW"], found["kBN"], found["kKc"]) == (
        C.F32_TILE_ROWS, C.F32_TILE_COLS, C.F32_N_TILE, C.F32_K_CHUNK)


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
