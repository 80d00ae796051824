"""The port in float16 against aid_tpu in float16, on the CPU.

The same seeded numpy draws, rounded once to f16, go through both packages.
Where the JAX function reaches a Pallas kernel it runs in interpret mode, as
tests/test_torch_ops.py runs it in f32; on the CPU the port's wrappers take
their plain versions, which are the yardstick the f16 CUDA kernels are held
to on the card (tests/test_torch_cuda_kernels.py, chip_smoke.py phases 3 and
20). The f16 kernels' own data movement (TMA boxes, the 128-byte swizzle,
wgmma descriptors, P rounded to f16) is replayed here from the wrappers' C
arguments with test_torch_ops.py's replays, which follow the operands' dtype.
UNets carry the JAX parameters across through the converters, cast to f16 on
both sides from the same f32 draw: the JAX modules compute in f16 from f32
parameters (flax casts each at use), the port's hold them in f16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_dmid as dmid_tests
import test_torch_ops as ops_tests
import torch_helpers as th
from aid_tpu.models import UNet2DCondition as JaxUNet
from aid_tpu.models.layers import AidContext as JaxAidContext
from aid_tpu.models.layers import AidMode as JaxAidMode
from aid_tpu.ops.conv import conv3x3_gnsilu as jax_conv3x3_gnsilu
from aid_tpu.ops.conv import conv3x3_same as jax_conv3x3_same
from aid_tpu.ops.flash_attention import flash_interpolated_attention as jax_flash
from aid_tpu_torch.models import configs
from aid_tpu_torch.models.layers import AidContext, AidMode
from aid_tpu_torch.models.params import (
    clip_text_state_dict_from_flax,
    unet_state_dict_from_flax,
    vae_state_dict_from_flax,
)
from aid_tpu_torch.ops.attention import AttnMode, _softmax_attn
from aid_tpu_torch.ops.conv import conv3x3_gnsilu, conv3x3_gnsilu_f16, conv3x3_same, conv3x3_same_f16
from aid_tpu_torch.ops.flash_attention import (
    KERNEL_HEAD_DIMS,
    d512_operands,
    flash_interpolated_attention,
    flash_interpolated_attention_f16,
    flash_interpolated_attention_plain,
    flash_self_attention_f16,
    kernel_operands,
    padded_head_dim,
)

F16 = np.float16
MODES = [m.value for m in AttnMode]

# f16 attention on both sides: f32 logits and softmax, P rounded to f16 (the
# Pallas kernel unnormalised per key tile, the plain version normalised) and
# the output rounded once to f16, each ~2^-11 relative. Measured at most
# 9.5e-4 of max |ref| over every head dim, mode and segment here; 5e-3 (the
# card's F16_ATTN_RTOL) leaves 5x, while a wrong segment, scale, blend or
# skip row is tens of percent.
F16_ATTN_TOL = 5e-3
# f16 conv, f32 accumulation on both sides (the Pallas kernel and oneDNN), one
# rounding of the output (and, with the prologue, of silu's output) to f16:
# measured 1.4e-4 to 3.3e-4 of max |ref| (3.9e-4 to 4.8e-4 with the
# prologue); 2.5e-3 as on the card. A wrong tap, halo or channel is O(1).
F16_CONV_TOL = 2.5e-3
# Whole tiny UNets in f16: every layer rounds to f16 (2^-11), at other places
# in XLA and in torch (GEMM and conv accumulations, GroupNorm and LayerNorm
# statistics), and the ~40 layers carry that along: measured 2.7e-3 to
# 3.0e-3 of max |ref| (fused_outer and pure_inner, both configs). 1e-2 is
# 3.3x the largest; fused_outer computed as self reads 1.3e-1 / 4.9e-1
# (test_unet_f16_bound_sees_a_mode_fault).
F16_UNET_TOL = 1e-2
# The tiny SD pipeline's final latents in f16 after 2 DDIM steps of 2 UNet
# passes each: the per-forward f16 difference above, amplified by the
# guidance (x7.5) on the difference of the two passes. Measured 9.3e-3 /
# 1.01e-2 of max |ref| (AID / PAID); 3e-2 is 3x that. A wrong coefficient,
# embed row or step moves these latents by tens of percent.
F16_SLICE_TOL = 3e-2
# The f16 kernels' replays against the plain version in f32: only P's and
# the output's f16 roundings differ (~2^-11 each): measured 1.9e-4 to
# 4.2e-4 of max |ref|; a wrong box, swizzle, descriptor or exchange is O(1).
F16_REPLAY_TOL = 2.5e-3


def _rel(got, want) -> float:
    return th.max_rel_err(np.asarray(got, np.float32), np.asarray(want, np.float32))


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# the ops: the flash attention at every head dim and mode, D=512 self, conv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", list(KERNEL_HEAD_DIMS))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("segments", ["text77", "ip16"])
def test_f16_flash_matches_pallas_interpret(D, mode, segments):
    """The f16 wrapper's CPU route against the Pallas kernel in interpret
    mode, both in f16: text77 is a cross-attention-like call (64 queries
    over 77 own keys, rows 0 / B-1 as the endpoints), ip16 an IP-Adapter-like
    one (16 own image tokens and shared (H, 16, D) endpoints of their own);
    the coef-0/1 end rows are skip rows (dropped in fused modes)."""
    B, H, S = 3, 2, 64
    L = 77 if segments == "text77" else 16
    q, k, v = (th.normal(100 + D + i, shape).astype(F16) for i, shape in
               enumerate([(B, H, S, D), (B, H, L, D), (B, H, L, D)]))
    names = ("k_begin", "v_begin", "k_end", "v_end")
    eps = {} if segments == "text77" else {n: th.normal(110 + D + i, (H, 16, D)).astype(F16)
                                           for i, n in enumerate(names)}
    coef = np.array([0.0, 0.35, 1.0], np.float32)
    skip = np.array([True, False, True])
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(coef), mode,
                     skip_endpoints=jnp.asarray(skip), block_q=64, block_k=64, interpret=True,
                     **{n: jnp.asarray(e) for n, e in eps.items()})
    before = flash_interpolated_attention_f16.launches
    got = flash_interpolated_attention(_t(q), _t(k), _t(v), _t(coef), mode, skip_endpoints=_t(skip),
                                       **{n: _t(e) for n, e in eps.items()})
    assert want.dtype == jnp.float16 and got.dtype == torch.float16
    assert flash_interpolated_attention_f16.launches == before  # the CPU takes the plain version
    assert _rel(got.numpy(), want) < F16_ATTN_TOL


@pytest.mark.parametrize("Sq,Lk", [(40, 33), (65, 77)])
def test_f16_d512_self_matches_pallas_interpret(Sq, Lk):
    """The VAE mid block's D=512 self attention in f16: the port's f16 route
    (flash_self_attention_f16, plain on the CPU) against the Pallas kernel
    in interpret mode in f16."""
    q = th.normal(120, (1, 1, Sq, 512)).astype(F16)
    k, v = th.normal(121, (1, 1, Lk, 512)).astype(F16), th.normal(122, (1, 1, Lk, 512)).astype(F16)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, "self", interpret=True)
    got = flash_self_attention_f16(_t(q), _t(k), _t(v))
    assert want.dtype == jnp.float16 and got.dtype == torch.float16
    assert _rel(got.numpy(), want) < F16_ATTN_TOL
    # the routed call, as the VAE makes it, is the same function
    assert torch.equal(flash_interpolated_attention(_t(q), _t(k), _t(v)), got)


@pytest.mark.parametrize("hw,cin,cout", [(16, 32, 24), (8, 64, 64)])
@pytest.mark.parametrize("packed", [False, True])
def test_f16_conv_matches_pallas_interpret(hw, cin, cout, packed):
    """conv3x3_same in f16 (both TPU contracts) against the Pallas kernels in
    interpret mode in f16."""
    x = th.normal(130, (2, hw, hw, cin)).astype(F16)
    w = th.normal(131, (3, 3, cin, cout), scale=cin ** -0.5).astype(F16)  # HWIO
    b = th.normal(132, (cout,)).astype(F16)
    want = jax_conv3x3_same(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), block_rows=8, interpret=True,
                            packed=packed)
    got = conv3x3_same(th.nhwc_to_nchw(x), _t(w.transpose(3, 2, 0, 1)), _t(b), packed=packed)
    assert want.dtype == jnp.float16 and got.dtype == torch.float16
    assert _rel(th.nchw_to_nhwc(got.float()), want) < F16_CONV_TOL


@pytest.mark.parametrize("hw,cin,cout,groups", [(16, 64, 48, 8), (8, 32, 32, 32)])
def test_f16_conv_gnsilu_matches_pallas_interpret(hw, cin, cout, groups):
    """conv3x3_gnsilu in f16: the same one-pass statistics, silu in f32
    rounded once to f16, the halo zero after the prologue; an input far from
    zero mean and unit scale, per-channel gamma / beta."""
    x = (th.normal(140, (2, hw, hw, cin), scale=3.0) + 1.5).astype(F16)
    w = th.normal(141, (3, 3, cin, cout), scale=cin ** -0.5).astype(F16)
    b = th.normal(142, (cout,)).astype(F16)
    gamma, beta = 1.0 + th.normal(143, (cin,), scale=0.3), th.normal(144, (cin,), scale=0.5)
    want = jax_conv3x3_gnsilu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jnp.asarray(gamma),
                              jnp.asarray(beta), num_groups=groups, block_rows=8, interpret=True)
    got = conv3x3_gnsilu(th.nhwc_to_nchw(x), _t(w.transpose(3, 2, 0, 1)), _t(b), _t(gamma), _t(beta), groups)
    assert want.dtype == jnp.float16 and got.dtype == torch.float16
    assert _rel(th.nchw_to_nhwc(got.float()), want) < F16_CONV_TOL


def test_f16_routes_and_what_still_raises():
    """f16 operands take the f16 C entries (kernel_operands, d512_operands,
    with no device), the f16 wrappers route CPU tensors to their plain
    versions and count nothing; a head dim of 200 takes the f16 D=161-512
    entry at the caller's D (no padded copy) in every mode, self mode
    through its instance with no endpoint set, and the replay from its C
    arguments matches the plain version; float64 and head dims over 2048
    still raise."""
    g = torch.Generator().manual_seed(150)
    q = torch.randn(3, 2, 40, 80, generator=g).half()
    coef = torch.tensor([0.0, 0.5, 1.0])
    ops = kernel_operands(q, q, q, coef, "fused_inner")
    assert ops["entry"] == "aid_flash_attn_f16" and all(x.dtype == torch.float16 for x in ops["tensors"])
    # the lerped inner endpoint: made in f32, stored once in f16
    want = ((1 - coef.reshape(3, 1, 1, 1)) * q[0].float() + coef.reshape(3, 1, 1, 1) * q[-1].float()).half()
    assert torch.equal(ops["tensors"][3], want)
    q512 = torch.randn(1, 1, 20, 512, generator=g).half()
    ops = d512_operands(q512, q512, q512)
    assert ops["entry"] == "aid_flash_attn_f16_d512" and ops["tensors"][3].dtype == torch.float16
    assert ops["tensors"][3].transpose(1, 2).is_contiguous()  # a (B, Sq, H, 512) buffer, as the bf16 kernel writes
    with pytest.raises(NotImplementedError):
        kernel_operands(q.double(), q.double(), q.double())
    with pytest.raises(NotImplementedError):
        d512_operands(q512.double(), q512.double(), q512.double())
    assert padded_head_dim(200, "fused_outer") == 200 == padded_head_dim(200, "self")
    assert padded_head_dim(512, "self") == 512
    q200 = torch.randn(3, 1, 64, 200, generator=g).half()
    ops = kernel_operands(q200, q200, q200, coef, "fused_outer")
    assert ops["entry"] == "aid_flash_attn_f16_dmid" and ops["dims"][5] == 200
    assert ops["tensors"][0].data_ptr() == q200.data_ptr()  # the caller's tensor, no padded copy
    got = dmid_tests._emulate_dmid16(ops)
    want = flash_interpolated_attention_plain(q200.float(), q200.float(), q200.float(), coef, "fused_outer")
    assert th.max_rel_err(got.float().numpy(), want.numpy()) < 1e-2
    ops = kernel_operands(q200, q200, q200)
    assert ops["entry"] == "aid_flash_attn_f16_dmid" and ops["n_sets"] == 0 and ops["tensors"][0] is q200
    got = dmid_tests._emulate_dmid16(ops)
    want = flash_interpolated_attention_plain(q200.float(), q200.float(), q200.float())
    assert th.max_rel_err(got.float().numpy(), want.numpy()) < 1e-2
    with pytest.raises(NotImplementedError):
        padded_head_dim(2056, "fused_outer")
    with pytest.raises(NotImplementedError):
        padded_head_dim(2056, "self")
    counts = (flash_interpolated_attention_f16.launches, flash_self_attention_f16.launches,
              conv3x3_same_f16.launches, conv3x3_gnsilu_f16.launches)
    flash_interpolated_attention(q, q, q, coef, "fused_outer")
    flash_interpolated_attention(q512, q512, q512)
    x, w = torch.randn(1, 16, 6, 6, generator=g).half(), torch.randn(8, 16, 3, 3, generator=g).half()
    conv3x3_same(x, w, torch.zeros(8).half())
    conv3x3_gnsilu(x, w, torch.zeros(8).half(), torch.ones(16), torch.zeros(16), 4)
    assert (flash_interpolated_attention_f16.launches, flash_self_attention_f16.launches,
            conv3x3_same_f16.launches, conv3x3_gnsilu_f16.launches) == counts


# ---------------------------------------------------------------------------
# the f16 kernels' data movement, replayed from their C arguments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", list(KERNEL_HEAD_DIMS))
@pytest.mark.parametrize("mode,endpoints", [("self", None), ("fused_outer", 3), ("pure_outer", 4),
                                            ("fused_inner", None), ("pure_inner", 3)])
def test_f16_flash_kernel_data_movement_replayed(D, mode, endpoints):
    """aid_flash_attn_f16's tensor-map boxes, 128-byte swizzle and wgmma
    descriptors, replayed from kernel_operands at f16 (the bf16 design's
    layout at 2-byte elements, P and the output rounded to f16), compute the
    attention on (B, S, H*D) views with skip rows, q tails and 129 / 77-key
    segments."""
    g = torch.Generator().manual_seed(160 + D)
    B, H, S, L, Le = 3, 2, 150, 129, 77

    def heads(n):
        return torch.randn(B, n, H * D, generator=g).half().view(B, n, H, D).transpose(1, 2)

    q, k, v = heads(S), heads(L), heads(L)
    coef, skip = torch.tensor([0.0, 0.4, 1.0]), torch.tensor([True, False, True])
    eps = {}
    if endpoints is not None:
        shape = (H, Le, D) if endpoints == 3 else (B, H, Le, D)
        eps = {n: torch.randn(shape, generator=g).half() for n in ("k_begin", "v_begin", "k_end", "v_end")}
    # the streaming kernel's layout: the route sends these short streams to the short-stream kernel
    ops = kernel_operands(q, k, v, coef, mode, skip_endpoints=skip, onepass=False, **eps)
    assert ops["entry"] == "aid_flash_attn_f16"
    got = ops_tests._emulate_flash_kernel(ops)
    want = flash_interpolated_attention_plain(q.float(), k.float(), v.float(), coef, mode, skip_endpoints=skip,
                                              **{n: e.float() for n, e in eps.items()})
    assert got.dtype == torch.float16 and got.shape == want.shape
    assert _rel(got.float().numpy(), want.numpy()) < F16_REPLAY_TOL


@pytest.mark.parametrize("Sq,Lk", [(63, 33), (65, 31)])
def test_f16_d512_kernel_data_movement_replayed(Sq, Lk):
    """aid_flash_attn_f16_d512, replayed from d512_operands at f16: its boxes,
    the D split across two warpgroups and their partial-score exchange,
    ragged Sq and Lk against the 64-row and 32-key tiles."""
    g = torch.Generator().manual_seed(170 + Sq)
    B, H, D = 2, 2, 512

    def heads(n):
        return torch.randn(B, n, H * D, generator=g).half().view(B, n, H, D).transpose(1, 2)

    q, k, v = heads(Sq), heads(Lk), heads(Lk)
    ops = d512_operands(q, k, v)
    assert ops["entry"] == "aid_flash_attn_f16_d512"
    got = ops_tests._emulate_flash_bf16_d512_kernel(ops)
    want = _softmax_attn(q.float(), k.float(), v.float(), D ** -0.5)
    assert got.dtype == torch.float16
    assert _rel(got.float().numpy(), want.numpy()) < F16_REPLAY_TOL


@pytest.mark.parametrize("prologue", [False, True])
def test_f16_conv_kernel_layouts_replayed(prologue):
    """aid_conv3x3_f16 / aid_conv3x3_gnsilu_f16: the f16 operands through
    kernel_operands' layouts (8 channels a 16-byte block, as in bf16), the
    TMA window, the weight chunk's bulk copy and the no-swizzle descriptors,
    with the prologue rounding silu once to f16, compute the conv."""
    from aid_tpu_torch.ops.conv import conv3x3_same_plain, gn_scale_shift

    g = torch.Generator().manual_seed(180)
    B, Cin, Cout, H, W = 1, 40, 24, 13, 7
    x = (torch.randn(B, Cin, H, W, generator=g) * 2 + 1).half()
    w = (torch.randn(Cout, Cin, 3, 3, generator=g) * (9 * Cin) ** -0.5).half()
    b = torch.randn(Cout, generator=g)
    if prologue:
        gamma, beta = 1 + 0.3 * torch.randn(Cin, generator=g), 0.5 * torch.randn(Cin, generator=g)
        scale, shift = gn_scale_shift(x, gamma, beta, 8, 1e-5)
        got = ops_tests._emulate_conv_kernel(x, w, b, (scale, shift))
        act = torch.nn.functional.silu(x.float() * scale[:, :, None, None] + shift[:, :, None, None])
        want = conv3x3_same_plain(act.half().float(), w.float(), b)
    else:
        got = ops_tests._emulate_conv_kernel(x, w, b)
        want = conv3x3_same_plain(x.float(), w.float(), b)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


# ---------------------------------------------------------------------------
# the converters' dtype, whole UNets, the SD pipeline
# ---------------------------------------------------------------------------

def test_flax_converters_cast_once():
    """unet/vae/clip_text_state_dict_from_flax(tree, dtype): each leaf in
    dtype, rounded once from the tree's f32 value (bit-equal to converting
    in f32 and casting), under the same names; port_unet(..., f16) holds
    every parameter in f16."""
    from helpers import tiny_pipeline

    base = tiny_pipeline()
    for convert, tree in ((unet_state_dict_from_flax, base.unet_params),
                          (vae_state_dict_from_flax, base.vae_params),
                          (clip_text_state_dict_from_flax, base.text_params)):
        f32, f16 = convert(tree), convert(tree, torch.float16)
        assert list(f32) == list(f16)
        for name, t in f32.items():
            assert t.dtype == torch.float32 and f16[name].dtype == torch.float16
            assert torch.equal(f16[name], t.half()), name
    unet = th.port_unet(configs.TINY_UNET, base.unet_params, torch.float16)
    assert {p.dtype for p in unet.parameters()} == {torch.float16}


@pytest.fixture(scope="module", params=["TINY_UNET", "TINY_SDXL_UNET"])
def unets_f16(request):
    """(cfg, JAX UNet computing in f16, its f32 params, the port's f16 UNet)."""
    cfg = getattr(configs, request.param)
    _, params = th.jax_unet_and_params(cfg, seed=0)
    return cfg, JaxUNet(cfg, dtype=jnp.float16), params, th.port_unet(cfg, params, torch.float16)


def _unet_inputs(cfg, B=3):
    s = cfg.sample_size
    return (th.normal(190, (B, s, s, cfg.in_channels)), th.normal(191, (B, 77, cfg.cross_attention_dim)),
            th.sdxl_added_cond(cfg, B, 192), np.array([0.0, 0.4, 1.0], np.float32))


def _forwards(cfg, jax_model, params, unet, mode, port_mode=None):
    """(port, JAX) outputs of one f16 forward in ``mode`` (the port's in
    ``port_mode`` if given), NHWC float32 numpy."""
    x, ehs, added, coef = _unet_inputs(cfg)

    def jax_forward(p, x, t, e, c, a):
        return jax_model.apply(p, x, t, e, JaxAidContext(coef=c, mode=JaxAidMode.from_name(mode)), a)

    want = jax.jit(jax_forward)(th.to_jnp(params), jnp.asarray(x, jnp.float16), jnp.array(321.0),
                                jnp.asarray(ehs, jnp.float16), jnp.asarray(coef),
                                None if added is None else th.to_jnp(added))
    pm = port_mode or mode
    aid = None if pm == "self" else AidContext(coef=_t(coef), mode=AidMode.from_name(pm))
    with torch.no_grad():
        got = unet(th.nhwc_to_nchw(x).half(), torch.tensor(321.0), _t(ehs).half(), aid, th.to_torch(added))
    assert want.dtype == jnp.float16 and got.dtype == torch.float16
    return th.nchw_to_nhwc(got.float()), np.asarray(want, np.float32)


@pytest.mark.parametrize("mode", ["fused_outer", "pure_inner"])
def test_unet_f16_forward_matches_jax(unets_f16, mode):
    """TINY_UNET / TINY_SDXL_UNET forwards in f16 (every attention through
    the f16 flash route, every conv and norm in f16) against the JAX UNet
    with dtype=float16 from the same f32 draw."""
    got, want = _forwards(*unets_f16, mode)
    assert np.isfinite(got).all()
    assert _rel(got, want) < F16_UNET_TOL


def test_unet_f16_bound_sees_a_mode_fault(unets_f16):
    """The bound above sees a fault: the port's forward in self mode against
    the JAX fused_outer one lands far over F16_UNET_TOL."""
    got, want = _forwards(*unets_f16, "fused_outer", port_mode="self")
    assert _rel(got, want) > 3 * F16_UNET_TOL


@pytest.fixture(scope="module")
def sd_pipes_f16():
    """The tiny SD pipelines of test_torch_pipeline_sd.py with the UNet in
    f16 on both sides (the text encoder and VAE f32, as the loader places
    them): the JAX module cloned with dtype=float16 over the same params,
    the port's UNet converted in f16."""
    import test_torch_pipeline_sd as sd_tests

    jax_pipe, pipe = sd_tests.sd_pipes()
    jax_pipe = dataclasses.replace(jax_pipe, unet=jax_pipe.unet.clone(dtype=jnp.float16))
    unet = th.port_unet(configs.TINY_UNET, jax.tree_util.tree_map(np.asarray, jax_pipe.unet_params), torch.float16)
    return jax_pipe, dataclasses.replace(pipe, unet=unet)


@pytest.mark.parametrize("guide", [None, "a small bird"], ids=["aid", "paid"])
def test_interpolate_f16_matches_jax(sd_pipes_f16, guide):
    """InterpolationPipeline.interpolate with an f16 UNet (4 frames, 2 DDIM
    steps) against the JAX pipeline with an f16 UNet: the final latents."""
    jax_pipe, pipe = sd_pipes_f16
    s, c = configs.TINY_UNET.sample_size, configs.TINY_UNET.in_channels
    a, b = th.normal(200, (1, s, s, c)), th.normal(201, (1, s, s, c))
    kw = dict(prompt_start="a red cat", prompt_end="a blue dog", guide_prompt=guide, size=4,
              num_inference_steps=2, output_type="latent")
    want = jax_pipe.interpolate(jnp.asarray(a), jnp.asarray(b), **kw)
    got = pipe.interpolate(th.nhwc_to_nchw(a), th.nhwc_to_nchw(b), **kw)
    assert {p.dtype for p in pipe.unet.parameters()} == {torch.float16}
    assert tuple(got.shape) == (4, c, s, s) and torch.isfinite(got).all()
    assert _rel(th.nchw_to_nhwc(got.float()), want) < F16_SLICE_TOL
