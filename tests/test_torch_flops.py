"""The port's FLOP counter (aid_tpu_torch/utils/flops.py) against aid_tpu's.

``count_flops`` counts matmul+conv FLOPs (2 x MACs). The JAX module traces a
function and sums its dot_generals and convolutions; on the CPU the JAX
package's attention and convs take their XLA paths, so its count of an
attention call is the XLA path's einsums. The port runs the call once under
``FlopCounterMode`` and counts the interpolated attention and the 3x3 convs
by their function's formula. Counts are integers: every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_helpers as th
from aid_tpu.models.layers import AidContext as JaxAidContext
from aid_tpu.models.layers import AidMode as JaxAidMode
from aid_tpu.ops.attention import attention as jax_attention
from aid_tpu.ops.attention import dispatch_attention as jax_dispatch_attention
from aid_tpu.utils.flops import count_flops as jax_count_flops
from aid_tpu_torch.models import configs
from aid_tpu_torch.models.layers import AidContext, AidMode
from aid_tpu_torch.ops import flash_attention
from aid_tpu_torch.ops.attention import AttnMode, attention, dispatch_attention, interpolated_attention
from aid_tpu_torch.ops.conv import conv3x3_gnsilu, conv3x3_same
from aid_tpu_torch.utils import flops
from aid_tpu_torch.utils.flops import count_flops, mfu

MODES = [m.value for m in AttnMode]


def test_linear_counts_as_jax():
    x, w, b = th.normal(1, (5, 7, 48)), th.normal(2, (48, 96)), th.normal(3, (96,))
    want = jax_count_flops(lambda x, w, b: x @ w + b, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = count_flops(F.linear, torch.from_numpy(x), torch.from_numpy(w.T.copy()), torch.from_numpy(b))
    assert got == want == 2 * 5 * 7 * 48 * 96


@pytest.mark.parametrize("gnsilu", [False, True])
def test_conv3x3_counts_as_jax(gnsilu):
    """The port's 3x3 conv entry points (the GN+SiLU one too: its prologue
    is a norm, not counted) against XLA's SAME convolution."""
    x, w, b = th.normal(4, (2, 8, 10, 16)), th.normal(5, (3, 3, 16, 24)), th.normal(6, (24,))
    want = jax_count_flops(
        lambda x, w: jax.lax.conv_general_dilated(x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")),
        jnp.asarray(x), jnp.asarray(w))
    xt, wt = th.nhwc_to_nchw(x), torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    if gnsilu:
        got = count_flops(conv3x3_gnsilu, xt, wt, torch.from_numpy(b), torch.ones(16), torch.zeros(16), 4)
    else:
        got = count_flops(conv3x3_same, xt, wt, torch.from_numpy(b))
    assert got == want == 2 * 2 * 8 * 10 * 24 * 9 * 16


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("endpoints", [None, "shared", "per_row"])
@pytest.mark.parametrize("D", [40, 640])
def test_attention_counts_as_jax_xla(mode, endpoints, D):
    """One interpolated attention call in each mode, endpoints from the rows
    or of their own length (shared or per row), skip rows and
    force_vanilla as the model passes them, against JAX's dispatch_attention
    on its XLA path."""
    B, H, S, L, Le = 3, 2, 16, 24, 9
    q, k, v = th.normal(7, (B, H, S, D)), th.normal(8, (B, H, L, D)), th.normal(9, (B, H, L, D))
    coef = np.array([0.0, 0.5, 1.0], np.float32)
    skip = np.array([True, False, True])
    eps = {}
    if endpoints:
        shape = (H, Le, D) if endpoints == "shared" else (B, H, Le, D)
        eps = {n: th.normal(10 + i, shape) for i, n in enumerate(("k_begin", "v_begin", "k_end", "v_end"))}
    force = skip if mode != "self" else None

    def jax_call(q, k, v, c, **e):
        return jax_dispatch_attention(q, k, v, c, mode, backend="xla", force_vanilla=force, **e)

    want = jax_count_flops(jax_call, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(coef),
                           **{n: jnp.asarray(e) for n, e in eps.items()})
    got = count_flops(dispatch_attention, torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                      torch.from_numpy(coef), mode, skip_endpoints=torch.from_numpy(skip),
                      force_vanilla=None if force is None else torch.from_numpy(force),
                      **{n: torch.from_numpy(e) for n, e in eps.items()})
    assert got == want > 0


def test_plain_attention_counts_as_jax():
    """ops.attention.attention (plain multi-head attention) is counted by its
    own products, as JAX counts its einsums."""
    q, k = th.normal(11, (2, 3, 20, 64)), th.normal(12, (2, 3, 30, 64))
    want = jax_count_flops(jax_attention, jnp.asarray(q), jnp.asarray(k), jnp.asarray(k))
    got = count_flops(attention, torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k))
    assert got == want == 4 * 2 * 3 * 20 * 30 * 64


@pytest.fixture(scope="module")
def tiny_unets():
    cfg = configs.TINY_UNET
    jax_model, params = th.jax_unet_and_params(cfg, seed=0)
    return cfg, jax_model, params, th.port_unet(cfg, params)


def _unet_inputs(cfg):
    B, s = 3, cfg.sample_size
    x = th.normal(1, (B, s, s, cfg.in_channels))
    ehs = th.normal(2, (B, 77, cfg.cross_attention_dim))
    return x, ehs, np.array([0.0, 0.4, 1.0], np.float32)


def _port_forward(unet, cfg, mode):
    x, ehs, coef = _unet_inputs(cfg)
    aid = None if mode == "self" else AidContext(coef=torch.from_numpy(coef), mode=AidMode.from_name(mode))
    return lambda: unet(th.nhwc_to_nchw(x), torch.tensor(321.0), torch.from_numpy(ehs), aid, None)


@pytest.mark.parametrize("mode", ["self", "fused_outer"])
def test_unet_forward_counts_as_jax(tiny_unets, mode):
    """A tiny UNet forward: every Linear, conv and attention of the port
    against the JAX UNet traced on its XLA path, to the FLOP."""
    cfg, jax_model, params, unet = tiny_unets
    x, ehs, coef = _unet_inputs(cfg)

    def jax_forward(p, x, e, c):
        aid = None if mode == "self" else JaxAidContext(coef=c, mode=JaxAidMode.from_name(mode))
        return jax_model.apply(p, x, jnp.array(321.0), e, aid, None)

    want = jax_count_flops(jax_forward, th.to_jnp(params), jnp.asarray(x), jnp.asarray(ehs), jnp.asarray(coef))
    assert count_flops(_port_forward(unet, cfg, mode)) == want > 0


@pytest.mark.parametrize("mode", ["self", "fused_outer"])
def test_unet_count_does_not_depend_on_what_runs_the_kernels(tiny_unets, monkeypatch, mode):
    """The count of a forward on the CPU equals the count the same program
    takes through the kernel wrappers: with the attention's and the convs'
    bodies made invisible to the counter (as a kernel's ctypes launch is on
    the card), the total is unchanged; and it equals the products the plain
    versions run where no skip row drops a segment (self mode), so the
    formulas are the plain versions' products."""
    from torch.utils._python_dispatch import _disable_current_modes
    from torch.utils.flop_counter import FlopCounterMode

    cfg, _, _, unet = tiny_unets
    forward = _port_forward(unet, cfg, mode)
    counted = count_flops(forward)

    def invisible(fn):
        def call(*args, **kwargs):
            with _disable_current_modes():
                return fn(*args, **kwargs)
        return call

    with monkeypatch.context() as m:  # what a launch on the card looks like to the counter
        m.setattr(flash_attention, "flash_interpolated_attention",
                  invisible(flash_attention.flash_interpolated_attention))
        from aid_tpu_torch.ops import conv
        m.setattr(conv, "conv3x3_same_plain", invisible(conv.conv3x3_same_plain))
        m.setattr(conv, "conv3x3_gnsilu_plain", invisible(conv.conv3x3_gnsilu_plain))
        assert count_flops(forward) == counted
    if mode == "self":
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            forward()
        assert counter.get_total_flops() == counted


def test_wrapper_formulas_match_the_plain_products():
    """Each attention mode's formula equals the products of its plain
    version (no skip rows), at a head dim the wide entries take."""
    from torch.utils.flop_counter import FlopCounterMode

    q, k = torch.from_numpy(th.normal(13, (2, 1, 8, 640))), torch.from_numpy(th.normal(14, (2, 1, 12, 640)))
    ep = torch.from_numpy(th.normal(15, (1, 5, 640)))
    for mode in MODES:
        for eps in ({}, dict(k_begin=ep, v_begin=ep, k_end=ep, v_end=ep)):
            with torch.no_grad(), FlopCounterMode(display=False) as counter:
                interpolated_attention(q, k, k, torch.tensor([0.2, 0.7]), mode, **eps)
            want = flops.attention_flops(q.shape, k.shape, mode, ep.shape[-2] if eps else None)
            assert counter.get_total_flops() == want, (mode, bool(eps))


def test_count_flops_does_not_nest_and_closes():
    with pytest.raises(RuntimeError):
        count_flops(count_flops, F.linear, torch.zeros(2, 3), torch.zeros(4, 3))
    assert not flops.counting()
    with pytest.raises(ValueError):  # a failing call still closes the count
        count_flops(lambda: (_ for _ in ()).throw(ValueError("boom")))
    assert not flops.counting()


def test_mfu_arithmetic():
    """FLOPs / seconds / peak, the peak the H100 SXM's dense bf16 rate."""
    assert flops.H100_PEAK_BF16_FLOPS == 989e12
    assert mfu(989e12, 1.0) == pytest.approx(1.0)
    assert mfu(4.945e14, 2.0) == pytest.approx(0.25)
    assert mfu(3e12, 0.5, peak=12e12) == pytest.approx(0.5)
