"""The port's ops against aid_tpu's: interpolation math, attention, conv.

Same seeded numpy inputs through both packages, f32 on the CPU. Where the
JAX function reaches a Pallas kernel it runs in interpret mode, as
tests/test_flash_attention.py and tests/test_conv3x3.py run it. On the CPU
the port's kernel wrappers take their plain versions, which is what these
pin; the kernels themselves are held to the same plain versions on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""

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
from aid_tpu_torch.ops.flash_attention import flash_interpolated_attention, flash_interpolated_attention_plain
from aid_tpu_torch.ops.routing import reference_ops, use_kernel

MODES = [m.value for m in AttnMode]

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


@pytest.mark.parametrize("mode", MODES)
def test_flash_wrapper_matches_pallas_interpret(mode):
    """The wrapper's CPU route against the Pallas kernel run in interpret
    mode: a ragged cross-attention-like shape (S=64 queries, 77 keys), coef
    0/1 endpoint rows marked as skip rows (dropped in fused modes)."""
    B, H, S, L, D = 3, 2, 64, 77, 64
    q, k, v, _, _ = _attn_inputs(B, H, S, L, D, seed=10)
    coef = np.array([0.0, 0.35, 1.0], np.float32)
    skip = np.array([True, False, True])
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(coef), mode,
                     skip_endpoints=jnp.asarray(skip), block_q=64, block_k=64, interpret=True)
    got = flash_interpolated_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                       torch.from_numpy(coef), mode, skip_endpoints=torch.from_numpy(skip))
    assert th.max_rel_err(got.numpy(), np.asarray(want)) < FLASH_TOL


@pytest.mark.parametrize("mode", ["fused_outer", "pure_inner"])
def test_flash_wrapper_explicit_endpoints_match_pallas_interpret(mode):
    """Shared 3D endpoints of their own ragged length (Le=48 vs Lk=32)."""
    q, k, v, coef, eps = _attn_inputs(3, 2, 64, 32, 64, Le=48, ep_rank=3, seed=20)
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
