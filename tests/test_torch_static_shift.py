"""The static-shift softmax (``static_smax``) of the port against aid_tpu's.

The JAX package's model path runs its Pallas kernels with
``static_smax="auto"``: C = 40, p = exp(min(s * scale - C, 30)) with no row
max, wherever its wrapper does not send a self call to `_kernel_onepass`
(aid_tpu/ops/flash_attention.py:44-65, 728-746, 863-896). Here the port's
plain version of that softmax is held to the JAX kernels in interpret mode
(as tests/test_flash_attention.py:213-281 runs them), its resolution of
"auto" to the JAX wrapper's choice, its logit-window probe to
aid_tpu/ops/attention.py's, and a tiny pipeline to the JAX one with the
kernels forced on. Inputs are seeded numpy draws handed to both packages.
The CUDA instances run only on the card (tests/test_torch_cuda_kernels.py,
``-k static``); their data movement is replayed in tests/test_torch_ops.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aid_tpu.ops.flash_attention import flash_interpolated_attention as jax_flash
from aid_tpu_torch.ops import flash_attention as fa
from aid_tpu_torch.ops.attention import AttnMode, dispatch_attention
from aid_tpu_torch.ops.flash_attention import (
    STATIC_SHIFT_C,
    d512_operands,
    flash_interpolated_attention,
    flash_interpolated_attention_plain,
    flash_self_attention_bf16,
    flash_self_attention_f16,
    flash_self_attention_f32,
    jax_static_smax,
    kernel_operands,
    resolve_static_smax,
    takes_d512_self,
)

# the module (``aid_tpu_torch.ops.attention`` as an attribute is the function the package exports)
port_attn = importlib.import_module("aid_tpu_torch.ops.attention")
MODES = [m.value for m in AttnMode]
# the D <= 160 instances' head dims, then the D=161-512 kernels' (320: SD 1.x's wide heads) and the
# VAE's 512 (its endpoint modes on the D=161-512 kernels, self mode on the D=512 self kernels)
HEAD_DIMS = [40, 64, 80, 160, 320, 512]
# f32: the interpret-mode kernels' tiled sums and their exp against one
# softmax, ~1e-6 of the output (tests/test_flash_attention.py pins 2e-4);
# bf16: P and the output rounded to bf16 at other points in the two
# packages (the JAX kernel divides by the sum of bf16 P, the plain version
# normalises in f32 first), a few 2^-9.
TOLS = {"f32": 2e-4, "bf16": 2e-2}
JAX_DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TORCH_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _data(B, H, S, L, D, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, n, D)).astype(np.float32) for n in (S, L, L))
    return q, k, v, np.linspace(0, 1, B).astype(np.float32)


def _jax(dtype, *arrays):
    return [jnp.asarray(a, JAX_DTYPES[dtype]) for a in arrays]


def _torch(dtype, *arrays):
    return [torch.from_numpy(a).to(TORCH_DTYPES[dtype]) for a in arrays]


def _err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# the plain static shift against the JAX kernels in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("onepass_max", [3072, 0])
def test_plain_static_shift_matches_jax_kernels(dtype, D, mode, onepass_max):
    """Every mode and head dim, 70 queries over 150 keys (ragged against the
    128-wide blocks, so both JAX kernels mask), skip rows at both ends in
    the fused modes, through `_kernel_onepass` (onepass_max 3072) and
    `_kernel` (0) at static_smax = 40; D = 320 the JAX wrapper pads to 384,
    D = 512 it runs as it is."""
    q, k, v, coef = _data(4, 2, 70, 150, D, seed=D + 3)
    skip = np.array([True, False, False, True])
    kw = {"skip_endpoints": skip} if mode in ("fused_outer", "fused_inner") else {}
    want = jax_flash(*_jax(dtype, q, k, v), jnp.asarray(coef), mode, block_q=128, block_k=128, interpret=True,
                     static_smax=40.0, onepass_max=onepass_max,
                     **{n: jnp.asarray(x) for n, x in kw.items()})
    tq, tk, tv = _torch(dtype, q, k, v)
    got = flash_interpolated_attention_plain(tq, tk, tv, torch.from_numpy(coef), mode, static_smax=40.0,
                                             **{n: torch.from_numpy(x) for n, x in kw.items()})
    assert got.dtype == TORCH_DTYPES[dtype]
    assert _err(got.float().numpy(), want) < TOLS[dtype]


def _window_data(hot: bool, D=64, seed=23):
    """tests/test_flash_attention.py:250-281's inputs: cold, a dedicated
    column biases every logit to -25 at scale 1 (row maxes near -23); hot, q
    x 40 and k leaning on q (row maxes in the thousands at D**-0.5)."""
    rng = np.random.default_rng(seed)
    B, H, S = 2, 2, 128
    v = rng.normal(size=(B, H, S, D)).astype(np.float32)
    q = rng.normal(size=(B, H, S, D)).astype(np.float32)
    k = rng.normal(size=(B, H, S, D)).astype(np.float32)
    if hot:
        qh = q * 40.0
        return qh, k + qh * 0.1, v, None
    qc = np.concatenate([q[..., :-1] * 0.1, np.ones_like(q[..., :1])], -1)
    kc = np.concatenate([k[..., :-1], np.full_like(k[..., :1], -25.0)], -1)
    return qc, kc, v, 1.0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["fused_outer", "self", "pure_inner"])
def test_plain_static_shift_at_the_window_edges(dtype, mode):
    """Near the window's bottom (row max ~ -23) the static shift matches the
    exact result; far above its top it matches JAX's CLIPPED result, finite,
    and differs from the exact one by far more than the tolerance."""
    coef = np.array([0.25, 0.75], np.float32)
    for hot in (False, True):
        q, k, v, scale = _window_data(hot)
        want = jax_flash(*_jax(dtype, q, k, v), jnp.asarray(coef), mode, interpret=True, static_smax=40.0,
                         scale=scale, onepass_max=0, block_q=128, block_k=128)
        tq, tk, tv = _torch(dtype, q, k, v)
        got = flash_interpolated_attention_plain(tq, tk, tv, torch.from_numpy(coef), mode, scale=scale,
                                                 static_smax=40.0)
        exact = flash_interpolated_attention_plain(tq, tk, tv, torch.from_numpy(coef), mode, scale=scale)
        assert torch.isfinite(got).all() and bool(jnp.all(jnp.isfinite(want)))
        assert _err(got.float().numpy(), want) < TOLS[dtype]
        if hot:
            assert _err(got.float().numpy(), exact.float().numpy()) > 10 * TOLS[dtype]
        else:
            assert _err(got.float().numpy(), exact.float().numpy()) < TOLS[dtype]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("D,mode", [(320, "fused_outer"), (320, "self"), (512, "pure_inner"), (512, "self"),
                                    (640, "fused_outer"), (1024, "self")])
def test_plain_static_shift_at_the_window_edges_wide_heads(dtype, D, mode):
    """The window's edges at the D=161-512 kernels', the VAE's and the wide
    kernels' head dims (640, and 1024: the widest the JAX wrapper takes in f32):
    near the bottom (row maxes ~ -23) the static shift is the exact result;
    far above the top (row maxes in the thousands) it is JAX's CLIPPED
    result, finite, more than ten tolerances from the exact one."""
    coef = np.array([0.25, 0.75], np.float32)
    for hot in (False, True):
        q, k, v, scale = _window_data(hot, D=D, seed=D)
        want = jax_flash(*_jax(dtype, q, k, v), jnp.asarray(coef), mode, interpret=True, static_smax=40.0,
                         scale=scale, onepass_max=0, block_q=128, block_k=128)
        tq, tk, tv = _torch(dtype, q, k, v)
        got = flash_interpolated_attention_plain(tq, tk, tv, torch.from_numpy(coef), mode, scale=scale,
                                                 static_smax=40.0)
        exact = flash_interpolated_attention_plain(tq, tk, tv, torch.from_numpy(coef), mode, scale=scale)
        assert torch.isfinite(got).all() and bool(jnp.all(jnp.isfinite(want)))
        assert _err(got.float().numpy(), want) < TOLS[dtype]
        if hot:
            assert _err(got.float().numpy(), exact.float().numpy()) > 10 * TOLS[dtype]
        else:
            assert _err(got.float().numpy(), exact.float().numpy()) < TOLS[dtype]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("Sq,Lk", [(70, 333), (256, 129)])
def test_vae_self_static_shift_matches_jax_kernel(dtype, Sq, Lk):
    """The VAE mid block's call (one head, D = 512, B = 1, self mode) with a
    key count ragged against the 128-key blocks: the JAX `_kernel` at
    static_smax = 40 in interpret mode against the port's D=512 wrapper of
    the dtype on CPU tensors at the same shift (its plain route), and
    against flash_interpolated_attention's; "auto" and None there are the
    exact softmax."""
    rng = np.random.default_rng(Sq + Lk)
    q = rng.normal(size=(1, 1, Sq, 512)).astype(np.float32)
    k, v = (rng.normal(size=(1, 1, Lk, 512)).astype(np.float32) for _ in range(2))
    want = jax_flash(*_jax(dtype, q, k, v), None, "self", interpret=True, static_smax=40.0, onepass_max=0,
                     block_q=128, block_k=128)
    tq, tk, tv = _torch(dtype, q, k, v)
    wrapper = {"f32": flash_self_attention_f32, "bf16": flash_self_attention_bf16}[dtype]
    got = wrapper(tq, tk, tv, static_smax=40.0)
    assert got.dtype == TORCH_DTYPES[dtype] and got.shape == (1, 1, Sq, 512)
    assert _err(got.float().numpy(), want) < TOLS[dtype]
    assert torch.equal(flash_interpolated_attention(tq, tk, tv, static_smax=40.0), got)
    exact = wrapper(tq, tk, tv)
    assert torch.equal(wrapper(tq, tk, tv, static_smax="auto"), exact)
    assert torch.equal(flash_interpolated_attention_plain(tq, tk, tv), exact)


def test_auto_on_the_plain_route_is_exact_bit_for_bit():
    """On CPU tensors "auto" is the exact softmax, bit for bit, through the
    wrapper of each dtype and through dispatch_attention (the model path's
    default), at shapes the card would shift."""
    q, k, v, coef = _data(3, 2, 600, 600, 64, seed=5)
    for dtype in ("f32", "bf16"):
        tq, tk, tv = _torch(dtype, q, k, v)
        c = torch.from_numpy(coef)
        for mode in MODES:
            exact = flash_interpolated_attention(tq, tk, tv, c, mode, static_smax=None)
            assert torch.equal(flash_interpolated_attention(tq, tk, tv, c, mode, static_smax="auto"), exact)
            assert torch.equal(dispatch_attention(tq, tk, tv, c, mode), exact)
            assert torch.equal(flash_interpolated_attention_plain(tq, tk, tv, c, mode), exact)


def test_string_validation_and_f16():
    """A string other than "auto" raises ValueError naming the parameter (as
    aid_tpu/ops/flash_attention.py:764-766); a float shift in f16 raises
    ValueError on any device (exp(-40) flushes to 0 in f16), "auto" and None
    are exact there."""
    q, k, v, coef = _data(2, 1, 16, 16, 64, seed=1)
    tq, tk, tv = _torch("f32", q, k, v)
    with pytest.raises(ValueError, match="static_smax"):
        flash_interpolated_attention(tq, tk, tv, None, "self", static_smax="Auto")
    hq, hk, hv = (x.half() for x in (tq, tk, tv))
    with pytest.raises(ValueError, match="f16"):
        flash_interpolated_attention(hq, hk, hv, None, "self", static_smax=40.0)
    with pytest.raises(ValueError, match="f16"):
        kernel_operands(hq, hk, hv, static_smax=40.0)
    assert torch.equal(flash_interpolated_attention(hq, hk, hv, static_smax="auto"),
                       flash_interpolated_attention(hq, hk, hv))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("D,mode", [(520, "fused_outer"), (640, "self"), (1280, "pure_inner"), (2048, "fused_outer")])
def test_no_static_instance_past_160_raises(dtype, D, mode):
    """Past head dim 512 a float shift no longer raises in bf16 and f32: the
    kernel route lays out the wide kernels' static instance
    (STATIC_DWIDE_ENTRIES) with the exact entry's dims, workspace and key
    split, and the plain version computes it on any device. (What still
    raises, f16 and a head dim past 2048, is the next test's.)"""
    q, k, v, coef = _data(2, 1, 8, 8, D, seed=D)
    tq, tk, tv = _torch(dtype, q, k, v)
    c = torch.from_numpy(coef)
    ops, exact = kernel_operands(tq, tk, tv, c, mode, static_smax=40.0), kernel_operands(tq, tk, tv, c, mode)
    assert ops["entry"] == fa.STATIC_DWIDE_ENTRIES[TORCH_DTYPES[dtype]] and exact["entry"] == fa.DWIDE_ENTRIES[
        TORCH_DTYPES[dtype]]
    np.testing.assert_allclose(ops["static"], (40.0 * np.log2(np.e), 30.0 * np.log2(np.e)), rtol=1e-12)
    assert ops["dims"] == exact["dims"] and ops["splits"] == exact["splits"] and ops["scale"] == exact["scale"]
    assert (ops["work"] is None) == (exact["work"] is None)
    assert ops["work"] is None or ops["work"].shape == exact["work"].shape
    assert torch.isfinite(flash_interpolated_attention(tq, tk, tv, c, mode, static_smax=40.0)).all()


def test_static_shift_past_512_raises_only_without_an_instance():
    """What a float shift past 512 still raises, with no fallback: f16 (no
    instance: exp(-40) flushes to 0) ValueError, a head dim past 2048 (no
    kernel at all, as the JAX wrapper past its budget) NotImplementedError."""
    q, k, v, coef = _data(2, 1, 8, 8, 640, seed=3)
    hq, hk, hv = (torch.from_numpy(x).half() for x in (q, k, v))
    with pytest.raises(ValueError, match="f16"):
        kernel_operands(hq, hk, hv, torch.from_numpy(coef), "fused_outer", static_smax=40.0)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.zeros(1, 1, 4, 2056, dtype=dtype)
        with pytest.raises(NotImplementedError):
            kernel_operands(x, x, x, static_smax=40.0)


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("mode", MODES)
def test_kernel_operands_lay_out_the_static_instances(D, mode):
    """A float shift lays out the static entry of the dtype: bf16 on the
    mid-length stream kernel's in an endpoint mode at D = 64 where the route
    takes that kernel, else on the streaming kernel's (the short-stream
    kernel's calls too); f32 on its one; from 161 to 512 on the D=161-512
    kernels' (with the exact entry's workspace), and in self mode at 512 on
    the D=512 self kernels' (d512_operands). The shift and the clip are
    passed in log2 units; None keeps the exact entries."""
    static_log2 = (40.0 * np.log2(np.e), 30.0 * np.log2(np.e))
    for S, L in ((1024, 1024), (600, 77)):
        q, k, v = (torch.zeros(()).expand(2, 2, n, D) for n in (S, L, L))
        for dtype in (torch.bfloat16, torch.float32):
            x = [t.to(dtype).contiguous() for t in (q, k, v)]
            if takes_d512_self(D, mode, dtype):
                ops, exact = d512_operands(*x, static_smax=40.0), d512_operands(*x)
                assert ops["entry"] == fa.STATIC_D512_ENTRIES[dtype] and exact["entry"] == fa.D512_ENTRIES[dtype]
                np.testing.assert_allclose(ops["static"], static_log2, rtol=1e-12)
                assert exact["static"] is None and ops["dims"] == exact["dims"]
                continue
            ops = kernel_operands(*x, torch.zeros(2), mode, static_smax=40.0)
            exact = kernel_operands(*x, torch.zeros(2), mode)
            mid = (dtype == torch.bfloat16 and D == 64 and mode != "self" and exact["midstream"])
            want = ("aid_flash_attn_bf16_midstream_static" if mid else
                    {torch.bfloat16: "aid_flash_attn_bf16_static", torch.float32: "aid_flash_attn_f32_static"}[dtype])
            if D > 160:
                want = fa.STATIC_DMID_ENTRIES[dtype]
                assert exact["entry"] == fa.DMID_ENTRIES[dtype]
                assert (ops["work"] is None) == (exact["work"] is None)
                assert ops["work"] is None or ops["work"].shape == exact["work"].shape
            assert ops["entry"] == want and not ops["onepass"] and ops["midstream"] == mid
            np.testing.assert_allclose(ops["static"], static_log2, rtol=1e-12)
            assert exact["static"] is None and not exact["entry"].endswith("_static")
    x = [torch.zeros(2, 2, 1024, 64, dtype=torch.bfloat16) for _ in range(3)]
    with pytest.raises(NotImplementedError):
        kernel_operands(*x, static_smax=40.0, midstream=True)  # self mode: no mid-length static instance
    with pytest.raises(NotImplementedError):
        kernel_operands(*[t[:, :, :77] for t in x], static_smax=40.0, onepass=True)


@pytest.mark.parametrize("D", [200, 504, 512])
def test_d512_operands_lay_out_the_static_instances(D):
    """d512_operands lays out the D=512 self kernels' static entry of the
    dtype (bf16, f32) for a float shift, with the shift and the clip in log2
    units, the same dims and padded tensors as the exact entry's; None keeps
    the exact entry; a shift on f16 raises ValueError (no instance: exp(-40)
    flushes to 0), as the D=512 wrappers do on any device."""
    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        x = [torch.zeros(1, 1, n, D, dtype=dtype) for n in (100, 77, 77)]
        exact = d512_operands(*x)
        assert exact["entry"] == fa.D512_ENTRIES[dtype] and exact["static"] is None
        if dtype == torch.float16:
            with pytest.raises(ValueError, match="f16"):
                d512_operands(*x, static_smax=40.0)
            with pytest.raises(ValueError, match="f16"):
                flash_self_attention_f16(*x, static_smax=40.0)
            assert torch.equal(flash_self_attention_f16(*x, static_smax="auto"), flash_self_attention_f16(*x))
            continue
        ops = d512_operands(*x, static_smax=40.0)
        assert ops["entry"] == fa.STATIC_D512_ENTRIES[dtype]
        np.testing.assert_allclose(ops["static"], (40.0 * np.log2(np.e), 30.0 * np.log2(np.e)), rtol=1e-12)
        assert ops["dims"] == exact["dims"] and ops["scale"] == exact["scale"] == D ** -0.5
        assert all(a.shape == b.shape == (*b.shape[:3], 512) for a, b in zip(ops["tensors"], exact["tensors"]))
        assert ops["out"].shape == (1, 1, 100, D)


# ---------------------------------------------------------------------------
# "auto": the JAX wrapper's choice, and the port's exact classes
# ---------------------------------------------------------------------------

def _hot(B, H, S, L, D, seed):
    """Row maxes far past +70: the JAX kernels' exact and static branches
    give outputs tens of percent apart, so the output shows which ran."""
    q, k, v, coef = _data(B, H, S, L, D, seed)
    qh = q * 40.0
    return qh, k + qh * 0.1, v, coef


@pytest.mark.parametrize("mode,H,S,per_row,onepass_max,resident,want", [
    ("self", 2, 256, False, 3072, None, None),      # one-pass self: exact
    ("self", 2, 256, False, 128, None, 40.0),       # the stream past onepass_max: the streaming kernel shifts
    ("self", 2, 256, False, 3072, 128, 40.0),       # no head group fits the resident columns: streaming, shifted
    ("fused_outer", 2, 128, False, 256, None, 40.0),  # split endpoints past onepass_max: one-pass, shifted
    ("fused_outer", 2, 128, True, 256, None, 40.0),   # per-row endpoints: the streaming kernel, shifted
    ("pure_inner", 2, 128, False, 3072, None, 40.0),  # one-pass, not self: shifted
])
def test_jax_static_smax_is_the_jax_wrappers_choice(monkeypatch, mode, H, S, per_row, onepass_max, resident, want):
    """At small shapes with the JAX wrapper's limits set to match, JAX's
    "auto" output on logits past the window shows which branch its kernels
    ran (the static shift's clipped result or the exact one), and
    jax_static_smax predicts it with the same limits."""
    jfa = importlib.import_module("aid_tpu.ops.flash_attention")
    q, k, v, coef = _hot(3, H, S, S, 64, seed=31)
    eps = {}
    if per_row:
        eps = {n: jnp.asarray(np.broadcast_to(x[None], (3,) + x.shape).copy())
               for n, x in (("k_begin", k[0]), ("v_begin", v[0]), ("k_end", k[-1]), ("v_end", v[-1]))}
    limits = {}
    if resident is not None:
        monkeypatch.setattr(jfa, "_ONEPASS_MAX_RESIDENT_COLS", resident)
        limits["resident_cols"] = resident
    jax.clear_caches()  # the constant is read while tracing
    try:
        out = {s: np.asarray(jfa.flash_interpolated_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(coef), mode, block_q=128, block_k=128,
            interpret=True, onepass_max=onepass_max, static_smax=s, **eps)) for s in ("auto", 40.0, None)}
    finally:
        jax.clear_caches()
    near = {s: _err(out["auto"], out[s]) for s in (40.0, None)}
    # "auto" is one branch's output to the last bits, and the two branches are far apart here
    assert min(near.values()) < 1e-6 and max(near.values()) > 1e-2
    assert min(near, key=near.get) == want
    got = jax_static_smax((3, H, S, 64), torch.float32, S, mode, S, split_capable=not per_row,
                          onepass_max=onepass_max, block_k=128, **limits)
    assert got == want


# (label, dtype, mode, B, H, Sq, Lk, D, endpoints, the JAX model path's shift at that shape (the JAX package
# has no f16: the port keeps f16 exact), the static instance's kernel):
# the call classes of the published UNets' attention at their image sizes (SDXL 1024px at D = 64 over
# 64^2 / 32^2 tokens; SD 1.5 512px at D = 40 / 80 / 160 over 64^2 / 32^2 / 16^2 / 8^2; SD 2.1 768px at D = 64
# over 96^2 / 48^2 / 24^2 / 12^2), 77 text tokens, 7 frames (14 rows with per-row endpoints in batched CFG)
CLASSES = [
    ("SDXL self 4096", "bf16", "self", 7, 10, 4096, 4096, 64, None, 40.0, "streaming"),
    ("SDXL fused_outer 4096", "bf16", "fused_outer", 7, 10, 4096, 4096, 64, None, 40.0, "streaming"),
    ("SDXL fused_outer 4096 batched CFG", "bf16", "fused_outer", 14, 10, 4096, 4096, 64, "per_row", 40.0,
     "streaming"),
    ("SDXL self 1024", "bf16", "self", 7, 20, 1024, 1024, 64, None, None, None),
    ("SDXL fused_outer 1024", "bf16", "fused_outer", 7, 20, 1024, 1024, 64, None, 40.0, "midstream"),
    ("SDXL fused_outer 1024 batched CFG", "bf16", "fused_outer", 14, 20, 1024, 1024, 64, "per_row", 40.0,
     "midstream"),
    ("SDXL pure_inner 1024", "bf16", "pure_inner", 7, 20, 1024, 1024, 64, None, 40.0, "midstream"),
    ("SDXL cross self 4096x77", "bf16", "self", 7, 10, 4096, 77, 64, None, None, None),
    ("SDXL cross fused_outer 4096x77", "bf16", "fused_outer", 7, 10, 4096, 77, 64, None, None, None),
    ("SDXL cross fused_outer 1024x77", "bf16", "fused_outer", 7, 20, 1024, 77, 64, None, None, None),
    ("SD1.5 self 4096", "bf16", "self", 7, 8, 4096, 4096, 40, None, 40.0, "streaming"),
    ("SD1.5 fused_outer 4096", "bf16", "fused_outer", 7, 8, 4096, 4096, 40, None, 40.0, "streaming"),
    ("SD1.5 self 1024", "bf16", "self", 7, 8, 1024, 1024, 80, None, None, None),
    ("SD1.5 fused_outer 1024", "bf16", "fused_outer", 7, 8, 1024, 1024, 80, None, 40.0, "streaming"),
    ("SD1.5 self 256", "bf16", "self", 7, 8, 256, 256, 160, None, None, None),
    ("SD1.5 fused_outer 256", "bf16", "fused_outer", 7, 8, 256, 256, 160, None, None, None),
    ("SD1.5 fused_outer 64 (mid block)", "bf16", "fused_outer", 7, 8, 64, 64, 160, None, None, None),
    ("SD1.5 cross fused_outer 4096x77", "bf16", "fused_outer", 7, 8, 4096, 77, 40, None, None, None),
    ("SD2.1 self 9216", "bf16", "self", 7, 5, 9216, 9216, 64, None, 40.0, "streaming"),
    ("SD2.1 fused_outer 9216", "bf16", "fused_outer", 7, 5, 9216, 9216, 64, None, 40.0, "streaming"),
    ("SD2.1 self 2304", "bf16", "self", 7, 10, 2304, 2304, 64, None, None, None),
    ("SD2.1 fused_outer 2304", "bf16", "fused_outer", 7, 10, 2304, 2304, 64, None, 40.0, "streaming"),
    ("SD2.1 self 576", "bf16", "self", 7, 20, 576, 576, 64, None, None, None),
    ("SD2.1 fused_outer 576", "bf16", "fused_outer", 7, 20, 576, 576, 64, None, 40.0, "midstream"),
    ("SD2.1 self 144", "bf16", "self", 7, 20, 144, 144, 64, None, None, None),
    ("f32 SDXL self 4096", "f32", "self", 7, 10, 4096, 4096, 64, None, 40.0, "streaming"),
    ("f32 SDXL fused_outer 1024", "f32", "fused_outer", 7, 20, 1024, 1024, 64, None, 40.0, "streaming"),
    ("f32 SDXL self 1024", "f32", "self", 7, 20, 1024, 1024, 64, None, None, None),
    ("f32 SD1.5 fused_outer 1024", "f32", "fused_outer", 7, 8, 1024, 1024, 80, None, 40.0, "streaming"),
    ("f16 SDXL fused_outer 4096", "f16", "fused_outer", 7, 10, 4096, 4096, 64, None, 40.0, "streaming"),
    ("f16 SDXL self 4096", "f16", "self", 7, 10, 4096, 4096, 64, None, 40.0, "streaming"),
    # SD 1.x read with 320-wide heads (1 / 2 / 4 heads over 64^2 / 32^2 / 16^2 tokens): the D=161-512 kernels
    ("SD1.x D=320 self 4096", "bf16", "self", 7, 1, 4096, 4096, 320, None, 40.0, "dmid"),
    ("SD1.x D=320 fused_outer 4096", "bf16", "fused_outer", 7, 1, 4096, 4096, 320, None, 40.0, "dmid"),
    ("SD1.x D=320 self 1024", "bf16", "self", 7, 2, 1024, 1024, 320, None, None, None),
    ("SD1.x D=320 fused_outer 1024", "bf16", "fused_outer", 7, 2, 1024, 1024, 320, None, 40.0, "dmid"),
    ("SD1.x D=320 pure_inner 256", "bf16", "pure_inner", 7, 4, 256, 256, 320, None, None, None),
    ("f32 SD1.x D=320 fused_outer 4096", "f32", "fused_outer", 7, 1, 4096, 4096, 320, None, 40.0, "dmid"),
    ("f32 SD1.x D=320 self 4096", "f32", "self", 7, 1, 4096, 4096, 320, None, 40.0, "dmid"),
    ("f16 SD1.x D=320 fused_outer 4096", "f16", "fused_outer", 7, 1, 4096, 4096, 320, None, 40.0, "dmid"),
    # one head a level (640 / 1280 over 32^2 / 16^2 / 8^2 tokens): the wide kernels; own KV under
    # FLASH_MIN_KV (the 1280-wide levels) exact, and f32 past the JAX wrapper's 1024 (it raises there)
    ("SD1.x D=640 fused_outer 1024", "bf16", "fused_outer", 7, 1, 1024, 1024, 640, None, 40.0, "dwide"),
    ("SD1.x D=640 pure_inner 1024", "bf16", "pure_inner", 7, 1, 1024, 1024, 640, None, 40.0, "dwide"),
    ("SD1.x D=640 self 1024", "bf16", "self", 7, 1, 1024, 1024, 640, None, None, None),
    ("SD1.x D=1280 fused_outer 256", "bf16", "fused_outer", 7, 1, 256, 256, 1280, None, None, None),
    ("SD1.x D=2048 fused_outer 1024", "bf16", "fused_outer", 7, 1, 1024, 1024, 2048, None, 40.0, "dwide"),
    ("f32 SD1.x D=640 fused_outer 1024", "f32", "fused_outer", 7, 1, 1024, 1024, 640, None, 40.0, "dwide"),
    ("f32 SD1.x D=1024 fused_inner 1024", "f32", "fused_inner", 7, 1, 1024, 1024, 1024, None, 40.0, "dwide"),
    ("f32 SD1.x D=1280 fused_outer 1024", "f32", "fused_outer", 7, 1, 1024, 1024, 1280, None, 40.0, "dwide"),
    ("f16 SD1.x D=640 fused_outer 1024", "f16", "fused_outer", 7, 1, 1024, 1024, 640, None, 40.0, "dwide"),
    # the VAE mid block (one head at D = 512, self mode): a 1024px frame, 7 512px frames, the tiled decode's
    # ragged tile; the D=512 self kernels
    ("VAE f32 self 16384", "f32", "self", 1, 1, 16384, 16384, 512, None, 40.0, "d512"),
    ("VAE f32 self 4096 x7", "f32", "self", 7, 1, 4096, 4096, 512, None, 40.0, "d512"),
    ("VAE f32 self 4000 (tile)", "f32", "self", 1, 1, 4000, 4000, 512, None, 40.0, "d512"),
    ("VAE bf16 self 16384", "bf16", "self", 1, 1, 16384, 16384, 512, None, 40.0, "d512"),
    ("VAE bf16 self 4096 x7", "bf16", "self", 7, 1, 4096, 4096, 512, None, 40.0, "d512"),
    ("VAE f16 self 16384", "f16", "self", 1, 1, 16384, 16384, 512, None, 40.0, "d512"),
]


def _shaped(dtype, *shape):
    return torch.zeros((), dtype=dtype).expand(*shape)  # shapes only: the resolution reads no element


@pytest.mark.parametrize("label,dtype,mode,B,H,Sq,Lk,D,endpoints,jax_shift,route", CLASSES,
                         ids=[c[0] for c in CLASSES])
def test_auto_resolves_each_call_class(monkeypatch, label, dtype, mode, B, H, Sq, Lk, D, endpoints, jax_shift,
                                       route):
    """Each published call class through dispatch_attention on the kernel
    route (``use_kernel`` made true, the launch captured: the interpolating
    kernels' and the D=512 self kernels'): the JAX model path's choice (own
    KV under FLASH_MIN_KV exact; one-pass self exact; the rest C = 40), then
    the port's exact classes (f16; f32 past a head dim of 1024, where the JAX
    wrapper raises; a class the card measured slower, STATIC_SHIFT_SLOWER,
    the wide kernels' keyed by their instance's padded head dim). Derived by
    hand from aid_tpu/ops/flash_attention.py:806-816, 863-891 and the
    shapes, not from the resolution itself."""
    dt = {"bf16": torch.bfloat16, "f32": torch.float32, "f16": torch.float16}[dtype]
    seen = []

    def launch(wrapper, q, *args, static_smax=None, **kwargs):
        seen.append(static_smax)
        return q

    def d512_launch(q, k, v, scale=None, static_smax=None):
        seen.append(static_smax)
        return q, lambda: None

    monkeypatch.setattr(fa, "use_kernel", lambda *t: True)
    monkeypatch.setattr(fa, "_launch_counted", launch)
    monkeypatch.setattr(fa, "d512_launch", d512_launch)
    for wrapper in (fa.flash_self_attention_f32, fa.flash_self_attention_bf16, fa.flash_self_attention_f16):
        monkeypatch.setattr(wrapper, "launches", 0)
        monkeypatch.setattr(wrapper, "launches_static", 0)
    q, k = _shaped(dt, B, H, Sq, D), _shaped(dt, B, H, Lk, D)
    eps = {}
    if endpoints == "per_row":
        eps = {n: _shaped(dt, B, H, Lk, D) for n in ("k_begin", "v_begin", "k_end", "v_end")}
    dispatch_attention(q, k, k, torch.zeros(B), mode, **eps)
    want = jax_shift
    Dk = fa.dwide_tiles(D, dt)[0] if route == "dwide" else D
    if dt == torch.float16 or (dt == torch.float32 and D > 1024) or (route, dtype, Dk, mode) in fa.STATIC_SHIFT_SLOWER:
        want = None
    assert seen == [want]
    if Lk >= port_attn.FLASH_MIN_KV:  # the JAX wrapper's own choice (shorter calls are exact by the gate)
        assert fa.jax_static_smax(tuple(q.shape), dt, Lk, mode, Lk, split_capable=endpoints is None) == jax_shift
    if want is not None:
        assert fa.static_route(D, Sq, Lk, Lk, mode, dt) == route


@pytest.mark.parametrize("mode", ["fused_outer", "pure_outer", "fused_inner"])
def test_auto_for_rows_all_forced_vanilla_is_the_self_calls(monkeypatch, mode):
    """force_vanilla True (every row vanilla: the fused loop's late steps)
    resolves "auto" as the self call the rows compute, so the fused loop
    launches split's softmax: exact at SDXL's 1024 tokens (one-pass self),
    C = 40 at 4096; False, or a row vector, keeps the mode's choice."""
    seen = []

    def launch(wrapper, q, *args, static_smax=None, **kwargs):
        seen.append(static_smax)
        return q

    monkeypatch.setattr(fa, "use_kernel", lambda *t: True)
    monkeypatch.setattr(fa, "_launch_counted", launch)
    for S, H in ((1024, 20), (4096, 10)):
        q = _shaped(torch.bfloat16, 7, H, S, 64)
        for force in (True, False, torch.ones(7, dtype=torch.bool)):
            seen.clear()
            dispatch_attention(q, q, q, torch.zeros(7), mode, force_vanilla=force)
            if force is True:
                want = None if S == 1024 else STATIC_SHIFT_C
            else:
                want = STATIC_SHIFT_C
            assert seen == [want] * len(seen) and seen, (S, force, seen)


def test_auto_keeps_the_plain_route_and_wide_heads_exact(monkeypatch):
    """Without the kernel route (CPU tensors) "auto" is exact; on it, head
    dims up to 512 take the JAX wrapper's C (the D=161-512 kernels' and the
    D=512 self kernels' static instances), and past 512 too where the JAX
    wrapper runs its kernels (the wide kernels' static instances: bf16 to
    2048, f32 to 1024); f32 past 1024, where the JAX wrapper raises, and f16
    are exact."""
    q = _shaped(torch.bfloat16, 7, 10, 4096, 64)
    assert resolve_static_smax(q, q, "self") is None
    monkeypatch.setattr(fa, "use_kernel", lambda *t: True)
    assert resolve_static_smax(q, q, "self") == STATIC_SHIFT_C
    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        for D in (192, 320, 512, 640, 1024, 1032, 1280, 2048):
            w = _shaped(dtype, 7, 1, 4096, D)
            assert fa.jax_static_smax(tuple(w.shape), dtype, 4096, "fused_outer") == STATIC_SHIFT_C
            shifted = dtype == torch.bfloat16 or (dtype == torch.float32 and D <= 1024)
            assert resolve_static_smax(w, w, "fused_outer") == (STATIC_SHIFT_C if shifted else None), (dtype, D)
        vae = _shaped(dtype, 1, 1, 16384, 512)
        assert resolve_static_smax(vae, vae, "self") == (None if dtype == torch.float16 else STATIC_SHIFT_C)
    assert resolve_static_smax(q, q, "self", static_smax=None) is None
    assert resolve_static_smax(q, q, "self", static_smax=12.5) == 12.5


# ---------------------------------------------------------------------------
# the logit-window calibration against aid_tpu/ops/attention.py's
# ---------------------------------------------------------------------------

def _jax_window(fn, *args, **kwargs):
    A = importlib.import_module("aid_tpu.ops.attention")
    acc = []
    A.LOGIT_WINDOW_RECORDER = lambda lo, hi: acc.append((float(lo), float(hi)))
    try:
        fn(A)(*args, **kwargs)
        jax.effects_barrier()
    finally:
        A.LOGIT_WINDOW_RECORDER = None
    (window,) = acc
    return window


def _port_window(monkeypatch, fn, *args, **kwargs):
    acc = []
    monkeypatch.setattr(port_attn, "LOGIT_WINDOW_RECORDER", lambda lo, hi: acc.append((float(lo), float(hi))))
    fn(*args, **kwargs)
    monkeypatch.setattr(port_attn, "LOGIT_WINDOW_RECORDER", None)
    (window,) = acc
    return window


def test_attention_logit_window_matches_jax():
    """(min, max) row max of the scaled logits, chunked over query blocks
    (8 rows here, 40 queries: a ragged last block), as the JAX helper."""
    from aid_tpu.ops.attention import attention_logit_window as jax_window

    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 2, 40, 16)).astype(np.float32)
    k = rng.normal(size=(2, 2, 48, 16)).astype(np.float32) * 3.0
    want = [float(x) for x in jax_window(jnp.asarray(q), jnp.asarray(k), q_block=8)]
    got = [float(x) for x in port_attn.attention_logit_window(torch.from_numpy(q), torch.from_numpy(k), q_block=8)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    s = (q.astype(np.float64) @ np.swapaxes(k.astype(np.float64), -1, -2)) * 16 ** -0.5
    np.testing.assert_allclose(got, [s.max(-1).min(), s.max(-1).max()], rtol=1e-5)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("variant", ["shared", "rows", "force", "skip", "per_row"])
def test_probe_logit_window_matches_jax(monkeypatch, mode, variant):
    """Every mode's per-set window (aid_tpu/ops/attention.py:163-232) on the
    same inputs: shared (H, S, D) endpoints offset from the own keys (a set
    below the other's), rows 0 / B-1 as endpoints, force_vanilla (the own-K
    set joins), a skip vector (widens the fused modes only), per-row (B, H,
    S, D) endpoints."""
    rng = np.random.default_rng(12)
    B, H, S, D = 3, 2, 16, 8
    q = rng.normal(size=(B, H, S, D)).astype(np.float32)
    k = (rng.normal(size=(B, H, S, D)) + 2.0).astype(np.float32)
    kb = (rng.normal(size=(H, S, D)) - 3.0).astype(np.float32)
    ke = rng.normal(size=(H, S, D)).astype(np.float32)
    if variant == "per_row":
        kb, ke = (np.broadcast_to(x[None], (B, H, S, D)) + rng.normal(size=(B, H, S, D)).astype(np.float32)
                  for x in (kb, ke))
    if variant == "rows":
        kb = ke = None
    kw_j, kw_t = {}, {}
    if variant == "force":
        kw_j, kw_t = {"force_vanilla": jnp.asarray(True)}, {"force_vanilla": torch.tensor(True)}
    if variant == "skip":
        kw_j, kw_t = {"skip_endpoints": jnp.zeros((B,), bool)}, {"skip_endpoints": torch.zeros(B, dtype=torch.bool)}

    def j(x):
        return None if x is None else jnp.asarray(x)

    def t(x):
        return None if x is None else torch.from_numpy(np.ascontiguousarray(x))

    want = _jax_window(lambda A: A._probe_logit_window, jnp.asarray(q), jnp.asarray(k), None, mode, j(kb), j(ke),
                       D ** -0.5, **kw_j)
    got = _port_window(monkeypatch, port_attn._probe_logit_window, t(q), t(k), None, mode, t(kb), t(ke),
                       D ** -0.5, **kw_t)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_dispatch_attention_reports_each_call(monkeypatch):
    """With LOGIT_WINDOW_RECORDER set, dispatch_attention reports each call's
    window once, the probe's, before computing (plain tensors, no callback
    machinery), and its result is unchanged."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(3, 2, 20, 16)).astype(np.float32)) for _ in range(3))
    coef = torch.tensor([0.0, 0.5, 1.0])
    plain = dispatch_attention(q, k, v, coef, "fused_outer")
    got = _port_window(monkeypatch, port_attn._probe_logit_window, q, k, v, "fused_outer", None, None, 0.25)
    acc = []
    monkeypatch.setattr(port_attn, "LOGIT_WINDOW_RECORDER", lambda lo, hi: acc.append((float(lo), float(hi))))
    out = dispatch_attention(q, k, v, coef, "fused_outer")
    assert acc == [got] and torch.equal(out, plain)


# ---------------------------------------------------------------------------
# a tiny pipeline through the shifted softmax, against the JAX one
# ---------------------------------------------------------------------------

def test_tiny_pipeline_under_auto_matches_jax(monkeypatch):
    """The JAX tiny SD pipeline with its Pallas kernels forced on
    (resolve_backend "flash", FLASH_MIN_KV 1, interpret mode; its model
    path's "auto" shifts every call but one-pass self ones), against the
    port's under "auto" with FLASH_MIN_KV 1 and its plain route made to apply
    the JAX wrapper's choice (a test-only monkeypatch of the port's
    resolution): uint8 frames within one step. Both runs shift some calls
    and keep others exact."""
    from test_torch_pipeline_sd import _both, _latents, sd_pipes

    jattn = importlib.import_module("aid_tpu.ops.attention")
    jfa = importlib.import_module("aid_tpu.ops.flash_attention")
    jax_pipe, pipe = sd_pipes()
    (ja, jb), (ta, tb) = _both(*_latents(70))
    kw = dict(prompt_start="a red cat", prompt_end="a blue dog", num_inference_steps=2)

    jax_seen = []
    real = jfa.flash_interpolated_attention

    def counting(*a, **k):
        jax_seen.append(k.get("static_smax"))
        return real(*a, **k)

    monkeypatch.setattr(jattn, "resolve_backend", lambda b="auto": "flash")
    monkeypatch.setattr(jattn, "FLASH_MIN_KV", 1)
    monkeypatch.setattr(jattn, "FLASH_KERNEL_OVERRIDES", {"interpret": True})
    monkeypatch.setattr(jfa, "flash_interpolated_attention", counting)
    jax.clear_caches()
    try:
        want = jax_pipe.interpolate_single(0.5, ja, jb, **kw)
    finally:
        jax.clear_caches()
    assert jax_seen and all(s == "auto" for s in jax_seen)

    port_seen = []

    def jax_choice(q, k, mode="self", k_begin=None, k_end=None, v_begin=None, v_end=None, static_smax="auto", **_):
        shift = static_smax
        if static_smax == "auto":
            eps = [e for e in (k_begin, v_begin, k_end, v_end) if e is not None]
            shift = fa.jax_static_smax(tuple(q.shape), q.dtype, k.shape[-2], mode,
                                       k.shape[-2] if k_begin is None else k_begin.shape[-2],
                                       split_capable=all(e.dim() == 3 for e in eps))
        port_seen.append(shift)
        return shift

    monkeypatch.setattr(port_attn, "FLASH_MIN_KV", 1)
    monkeypatch.setattr(fa, "resolve_static_smax", jax_choice)
    got = pipe.interpolate_single(0.5, ta, tb, **kw)
    assert STATIC_SHIFT_C in port_seen and None in port_seen
    want = np.asarray(want)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert np.unique(got).size > 2
