"""The port's UNet against aid_tpu's: parameter round trip and forward parity.

Tiny configs (TINY_SDXL_UNET, TINY_UNET), f32 on the CPU, same weights on
both sides. On the CPU the port runs every op's plain version, so this pins
the model code (layouts, names, epsilons, GEGLU's tanh gelu, SDXL added
conditioning, skip concat, endpoint selection) independently of the kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_helpers as th
from aid_tpu.models import configs as jax_configs
from aid_tpu.models.layers import AidContext as JaxAidContext
from aid_tpu.models.layers import AidMode as JaxAidMode
from aid_tpu.models.params import convert_unet_state_dict
from aid_tpu_torch.models import configs
from aid_tpu_torch.models.layers import AidContext, AidMode

CONFIGS = {"tiny_sdxl": configs.TINY_SDXL_UNET, "tiny": configs.TINY_UNET}

# f32 on both sides; the two frameworks order their sums differently (conv,
# GroupNorm statistics, matmul blocking), which over ~40 layers leaves a few
# 1e-6 of max |ref|. 1e-4 leaves room and still catches any real fault (a
# wrong epsilon, transposed weight or exact-vs-tanh gelu is >= 1e-3).
FWD_TOL = 1e-4


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def models(request):
    cfg = CONFIGS[request.param]
    jax_model, params = th.jax_unet_and_params(cfg, seed=0)
    return cfg, jax_model, params, th.port_unet(cfg, params)


def test_configs_match_jax_presets():
    for name in ("SDXL_UNET", "TINY_SDXL_UNET", "TINY_UNET", "SD15_UNET", "SD21_UNET"):
        assert getattr(configs, name).__dict__ == getattr(jax_configs, name).__dict__, name


def test_state_dict_round_trip(models):
    """convert_unet_state_dict(port.state_dict()) is the JAX tree, leaf for
    leaf; loading the converted tree back was strict (in the fixture)."""
    cfg, _, params, unet = models
    back = convert_unet_state_dict(unet.state_dict())
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        assert path in got, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(np.asarray(got[path]), leaf, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("mode", ["self", "fused_outer"])
def test_unet_forward_matches_jax(models, mode):
    cfg, jax_model, params, unet = models
    B, s = 3, cfg.sample_size
    x = th.normal(1, (B, s, s, cfg.in_channels))
    ehs = th.normal(2, (B, 77, cfg.cross_attention_dim))
    added = th.sdxl_added_cond(cfg, B, 3)
    coef = np.array([0.0, 0.4, 1.0], np.float32)
    t = 321.0

    def jax_forward(p, x, t, e, c, a):
        aid = None if mode == "self" else JaxAidContext(coef=c, mode=JaxAidMode.from_name(mode))
        return jax_model.apply(p, x, t, e, aid, a)

    want = jax.jit(jax_forward)(
        th.to_jnp(params), jnp.asarray(x), jnp.array(t), jnp.asarray(ehs), jnp.asarray(coef),
        None if added is None else th.to_jnp(added))

    aid = None if mode == "self" else AidContext(coef=torch.from_numpy(coef), mode=AidMode.from_name(mode))
    with torch.no_grad():
        got = unet(th.nhwc_to_nchw(x), torch.tensor(t), torch.from_numpy(ehs), aid, th.to_torch(added))
    assert tuple(got.shape) == (B, cfg.out_channels, s, s)
    assert th.max_rel_err(th.nchw_to_nhwc(got), np.asarray(want)) < FWD_TOL


def test_unet_forward_batched_cfg_matches_jax(models):
    """cfg_split: one 2N batch [N cond; N uncond]; cond rows take endpoints
    from cond rows 0 / N-1 (per-row 4D endpoints), uncond rows their own."""
    cfg, jax_model, params, unet = models
    N, s = 3, cfg.sample_size
    x = np.concatenate([th.normal(7, (N, s, s, cfg.in_channels))] * 2)
    ehs = th.normal(8, (2 * N, 77, cfg.cross_attention_dim))
    added = th.sdxl_added_cond(cfg, 2 * N, 9)
    coef = np.tile(np.array([0.0, 0.6, 1.0], np.float32), 2)
    mode = "fused_outer"

    def jax_forward(p, x, t, e, c, a):
        aid = JaxAidContext(coef=c, mode=JaxAidMode(text=JaxAidMode.from_name(mode).text, cfg_split=N))
        return jax_model.apply(p, x, t, e, aid, a)

    want = jax.jit(jax_forward)(
        th.to_jnp(params), jnp.asarray(x), jnp.array(77.0), jnp.asarray(ehs), jnp.asarray(coef),
        None if added is None else th.to_jnp(added))
    aid = AidContext(coef=torch.from_numpy(coef), mode=AidMode(text=AidMode.from_name(mode).text, cfg_split=N))
    with torch.no_grad():
        got = unet(th.nhwc_to_nchw(x), torch.tensor(77.0), torch.from_numpy(ehs), aid, th.to_torch(added))
    assert th.max_rel_err(th.nchw_to_nhwc(got), np.asarray(want)) < FWD_TOL


@pytest.mark.parametrize("layer", ["resnet", "transformer"])
def test_norm_layers_match_jax_at_small_scale(layer):
    """Activations of ~1e-3 make the GroupNorm/LayerNorm epsilons (1e-5 in
    resnets, 1e-6 in Transformer2D) dominate the variance, so a wrong
    epsilon shows as an O(1) error here while the UNet tests cannot see it."""
    from aid_tpu.models import layers as jl

    from aid_tpu_torch.models import layers as tl
    from aid_tpu_torch.models.params import unet_state_dict_from_flax

    B, s, C, groups = 2, 4, 32, 8
    x = th.normal(20, (B, s, s, C), scale=1e-3)
    if layer == "resnet":
        temb = th.normal(21, (B, 16))
        jmod, args = jl.ResnetBlock2D(C, groups), (jnp.asarray(x), jnp.asarray(temb))
        tmod = tl.ResnetBlock2D(C, C, 16, groups)
        targs = (th.nhwc_to_nchw(x), torch.from_numpy(temb))
    else:
        ehs = th.normal(22, (B, 7, 24))
        jmod = jl.Transformer2D(2, C // 2, 1, groups, use_linear_projection=True)
        args = (jnp.asarray(x), jnp.asarray(ehs))
        tmod = tl.Transformer2D(C, 2, C // 2, 1, 24, groups, use_linear_projection=True)
        targs = (th.nhwc_to_nchw(x), torch.from_numpy(ehs))
    params = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(3), *args))
    tmod.load_state_dict(unet_state_dict_from_flax(params), strict=True)
    want = jmod.apply(th.to_jnp(params), *args)
    with torch.no_grad():
        got = tmod(*targs)
    assert th.max_rel_err(th.nchw_to_nhwc(got), np.asarray(want)) < FWD_TOL


def test_aid_changes_only_interior_frames(models):
    """fused_outer with coef 0/1 endpoints leaves frames 0 and N-1 exactly
    vanilla (the skip rows) and moves the interior frame."""
    cfg, _, _, unet = models
    B, s = 3, cfg.sample_size
    x = torch.from_numpy(th.normal(4, (B, cfg.in_channels, s, s)))
    ehs = torch.from_numpy(th.normal(5, (B, 77, cfg.cross_attention_dim)))
    added = th.to_torch(th.sdxl_added_cond(cfg, B, 6))
    coef = torch.tensor([0.0, 0.5, 1.0])
    with torch.no_grad():
        van = unet(x, torch.tensor(500.0), ehs, None, added)
        aid = unet(x, torch.tensor(500.0), ehs, AidContext(coef, AidMode.from_name("fused_outer")), added)
    assert th.max_rel_err(aid[[0, 2]].numpy(), van[[0, 2]].numpy()) < FWD_TOL
    assert th.max_rel_err(aid[1].numpy(), van[1].numpy()) > 1e-3


def test_resnet_fused_gn_conv_matches_jax(monkeypatch):
    """ResnetBlock2D with the fused GN+SiLU prologue switched on in both
    packages, at a class the rule fuses (cin 320 at 32x32): the port runs
    its conv3x3_gnsilu plain version, the JAX package its inline prologue
    (layers.py:239-245). The parameters, and so the state_dict keys, are
    those of the unfused branch."""
    from aid_tpu.models import layers as jl

    from aid_tpu_torch.models import layers as tl
    from aid_tpu_torch.models.params import unet_state_dict_from_flax

    B, s, C, cout, groups, temb_dim = 2, 32, 320, 320, 32, 16
    x = th.normal(30, (B, s, s, C), scale=2.0) + 0.5
    temb = th.normal(31, (B, temb_dim))
    jmod = jl.ResnetBlock2D(cout, groups)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(4), jnp.asarray(x), jnp.asarray(temb)))
    noise = th.rng(32)
    params = jax.tree_util.tree_map(
        lambda a: a + (noise.standard_normal(a.shape) * 0.05).astype(np.float32), params)
    tmod = tl.ResnetBlock2D(C, cout, temb_dim, groups)
    tmod.load_state_dict(unet_state_dict_from_flax(params), strict=True)
    unfused_keys = list(tmod.state_dict())
    with torch.no_grad():
        unfused = tmod(th.nhwc_to_nchw(x), torch.from_numpy(temb))

    monkeypatch.setattr(jl, "_FUSED_GN_CONV", True)
    monkeypatch.setattr(tl, "_FUSED_GN_CONV", True)
    fused_params = jmod.init(jax.random.PRNGKey(4), jnp.asarray(x), jnp.asarray(temb))
    assert jax.tree_util.tree_structure(fused_params) == jax.tree_util.tree_structure(params)
    want = jmod.apply(th.to_jnp(params), jnp.asarray(x), jnp.asarray(temb))
    with torch.no_grad():
        got = tmod(th.nhwc_to_nchw(x), torch.from_numpy(temb))
    assert list(tl.ResnetBlock2D(C, cout, temb_dim, groups).state_dict()) == unfused_keys
    assert th.max_rel_err(th.nchw_to_nhwc(got), np.asarray(want)) < FWD_TOL
    # the fused branch really ran: the one-pass statistics round differently
    assert not torch.equal(got, unfused)
    assert th.max_rel_err(got.numpy(), unfused.numpy()) < FWD_TOL


@pytest.mark.parametrize("shape,threshold", [((2, 8, 8, 4), 1), ((2, 7, 9, 3), 1), ((1, 16, 12, 2), 3)])
def test_fourier_filter_matches_jax(shape, threshold):
    """FreeU's low-pass rescale: the half-open 2t x 2t block around the
    shifted spectrum's centre, even and odd sizes; f32 FFTs on both sides
    (pocketfft on the CPU in both frameworks, ~1e-7 of max |ref|)."""
    from aid_tpu.models.freeu import fourier_filter as jax_fourier_filter
    from aid_tpu_torch.models.freeu import fourier_filter

    x = th.normal(20, shape)
    want = jax_fourier_filter(jnp.asarray(x), threshold, 0.3)
    got = fourier_filter(th.nhwc_to_nchw(x), threshold, 0.3)
    assert got.dtype == torch.float32
    assert th.max_rel_err(th.nchw_to_nhwc(got), np.asarray(want)) < 1e-5
    # the block is scaled and nothing else: scale 1 is the identity
    torch.testing.assert_close(fourier_filter(th.nhwc_to_nchw(x), threshold, 1.0), th.nhwc_to_nchw(x),
                               rtol=0, atol=1e-5)


def test_unet_forward_with_freeu_matches_jax(models):
    """A UNet forward with FreeU on both up stages, against the JAX UNet's
    ``freeu`` argument; FreeU moves the output, so the check is not vacuous."""
    from aid_tpu.models.freeu import FreeUConfig as JaxFreeUConfig
    from aid_tpu_torch.models.freeu import FreeUConfig

    cfg, jax_model, params, unet = models
    B, s = 2, cfg.sample_size
    x = th.normal(4, (B, s, s, cfg.in_channels))
    ehs = th.normal(5, (B, 77, cfg.cross_attention_dim))
    added = th.sdxl_added_cond(cfg, B, 6)
    freeu = dict(s1=0.6, s2=0.4, b1=1.1, b2=1.2)
    want = jax_model.apply(th.to_jnp(params), jnp.asarray(x), jnp.array(321.0), jnp.asarray(ehs), None,
                           None if added is None else th.to_jnp(added), JaxFreeUConfig(**freeu))
    with torch.no_grad():
        args = (th.nhwc_to_nchw(x), torch.tensor(321.0), torch.from_numpy(ehs), None, th.to_torch(added))
        got = unet(*args, freeu=FreeUConfig(**freeu))
        base = unet(*args)
    assert th.max_rel_err(th.nchw_to_nhwc(got), np.asarray(want)) < FWD_TOL
    assert th.max_rel_err(got, base) > 1e-3
