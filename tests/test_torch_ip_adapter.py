"""The port's IP-Adapter against aid_tpu's, on the CPU at tiny size.

Every checkpoint here is an h94-format dict (``image_proj``: the
projection's own names; ``ip_adapter``: ``<idx>.to_{k,v}_ip.weight``) made
with numpy from a seed. Each package loads it its own way: the port's
modules take ``image_proj`` as their ``state_dict``, the JAX package
converts it (``convert_torch_state_dict`` / ``convert_resampler_state_dict``
/ ``convert_ip_adapter_state_dict``). The UNets (TINY_UNET_IP, and the tiny
SDXL UNet with IP tokens) hold the same perturbed weights on both sides, as
in tests/test_torch_models.py. f32; on the CPU the port's attention is the
plain version, so these tests hold the model code; the kernels' IP shapes
are held on the card (tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_helpers as th
from aid_tpu.models.clip import CLIPVisionModel as JaxVision
from aid_tpu.models.ip_adapter import ImageProjection as JaxImageProjection
from aid_tpu.models.ip_adapter import Resampler as JaxResampler
from aid_tpu.models.layers import AidContext as JaxAidContext
from aid_tpu.models.layers import AidMode as JaxAidMode
from aid_tpu.models.params import convert_clip_vision_state_dict, convert_resampler_state_dict
from aid_tpu.models.params import convert_torch_state_dict
from aid_tpu.models.params import convert_unet_state_dict
from aid_tpu.models.params import unet_attention_order as jax_attention_order
from aid_tpu_torch.models import configs
from aid_tpu_torch.models.clip import CLIPVisionModel
from aid_tpu_torch.models.ip_adapter import ImageProjection, Resampler, image_projection_from_state_dict
from aid_tpu_torch.models.layers import AidContext, AidMode
from aid_tpu_torch.models.params import _unfold, ip_adapter_state_dict, unet_attention_order
from aid_tpu_torch.models.unet import UNet2DCondition
from aid_tpu_torch.utils.safetensors import save_safetensors

# One projection in f32 on both sides: a Linear and a LayerNorm, or a few
# perceiver layers; the frameworks order their sums differently, ~1e-7 of
# max |ref|. 1e-5 leaves room; exact gelu in place of the tanh one, a
# sqrt(dim_head) scale or to_kv's halves swapped are >= 1e-3.
PROJ_TOL = 1e-5
# As tests/test_torch_models.py::FWD_TOL: a UNet forward, f32, ~1e-6 of max |ref|.
FWD_TOL = 1e-4
# As tests/test_torch_pipeline_sd.py::SLICE_TOL: a few steps of CFG in f32.
SLICE_TOL = 1e-4
STEPS = 2
IP_SCALE = 0.7

UNET_IP = configs.TINY_UNET_IP
EMBED_DIM = UNET_IP.ip_hidden_dim  # the CLIP image embeds' width a standard adapter takes


def _lin(r, o, i):
    return (r.standard_normal((o, i)) / np.sqrt(i)).astype(np.float32)


def _vec(r, n, base=0.0):
    return (base + 0.1 * r.standard_normal(n)).astype(np.float32)


def image_proj_dict(seed, cross, tokens, plus=False, embed_dim=EMBED_DIM, hidden=16, depth=2):
    """A random h94-format ``image_proj``: the standard adapter's (proj,
    norm) or a Plus resampler's (``heads = max(1, hidden // 64)`` of 64)."""
    r = th.rng(seed)
    if not plus:
        return {"proj.weight": _lin(r, tokens * cross, embed_dim), "proj.bias": _vec(r, tokens * cross),
                "norm.weight": _vec(r, cross, 1.0), "norm.bias": _vec(r, cross)}
    inner = max(1, hidden // 64) * 64
    sd = {"latents": r.standard_normal((1, tokens, hidden)).astype(np.float32) * 0.5,
          "proj_in.weight": _lin(r, hidden, embed_dim), "proj_in.bias": _vec(r, hidden),
          "proj_out.weight": _lin(r, cross, hidden), "proj_out.bias": _vec(r, cross),
          "norm_out.weight": _vec(r, cross, 1.0), "norm_out.bias": _vec(r, cross)}
    for i in range(depth):
        for ln in ("norm1", "norm2"):
            sd[f"layers.{i}.0.{ln}.weight"] = _vec(r, hidden, 1.0)
            sd[f"layers.{i}.0.{ln}.bias"] = _vec(r, hidden)
        sd[f"layers.{i}.0.to_q.weight"] = _lin(r, inner, hidden)
        sd[f"layers.{i}.0.to_kv.weight"] = _lin(r, 2 * inner, hidden)
        sd[f"layers.{i}.0.to_out.weight"] = _lin(r, hidden, inner)
        sd[f"layers.{i}.1.0.weight"] = _vec(r, hidden, 1.0)
        sd[f"layers.{i}.1.0.bias"] = _vec(r, hidden)
        sd[f"layers.{i}.1.1.weight"] = _lin(r, 4 * hidden, hidden)
        sd[f"layers.{i}.1.3.weight"] = _lin(r, hidden, 4 * hidden)
    return sd


def checkpoint(cfg, seed, plus=False):
    """A whole h94-format checkpoint for a UNet of ``cfg``: ``ip_adapter``
    numbered 1, 3, 5, ... in the UNet's attention-processor order, each
    layer's widths read off the port's UNet built on the meta device; the
    projection takes ``cfg.ip_hidden_dim``-wide image embeds."""
    unet = UNet2DCondition(cfg, device="meta")
    r = th.rng(seed + 100)
    ip = {}
    for li, name in enumerate(unet_attention_order(cfg)):
        attn = unet.get_submodule(name)
        for proj in ("to_k_ip", "to_v_ip"):
            o, i = getattr(attn, proj).weight.shape
            ip[f"{2 * li + 1}.{proj}.weight"] = _lin(r, o, i)
    image_proj = image_proj_dict(seed, cfg.cross_attention_dim, cfg.ip_num_tokens, plus, embed_dim=cfg.ip_hidden_dim)
    return {"image_proj": image_proj, "ip_adapter": ip}


def test_image_projection_matches_jax():
    cross, tokens = 32, 4
    sd = image_proj_dict(1, cross, tokens)
    proj = image_projection_from_state_dict(sd, cross, tokens)
    assert isinstance(proj, ImageProjection)
    embeds = th.normal(2, (3, EMBED_DIM))
    want = JaxImageProjection(cross_attention_dim=cross, num_tokens=tokens).apply(
        th.to_jnp(convert_torch_state_dict(sd)), jnp.asarray(embeds))
    with torch.no_grad():
        got = proj(torch.from_numpy(embeds))
    assert tuple(got.shape) == (3, tokens, cross)
    assert th.max_rel_err(got.numpy(), np.asarray(want)) < PROJ_TOL


@pytest.mark.parametrize("hidden,depth,embed_dim", [(16, 2, 16), (128, 1, 24)])
def test_resampler_matches_jax(hidden, depth, embed_dim):
    """IP-Adapter-Plus: one head of 64 at hidden 16, two at 128 (heads =
    max(1, hidden // 64)); depth and widths read off the dict."""
    cross, tokens = 32, 4
    sd = image_proj_dict(3, cross, tokens, plus=True, embed_dim=embed_dim, hidden=hidden, depth=depth)
    proj = image_projection_from_state_dict(sd, cross, tokens)
    assert isinstance(proj, Resampler) and len(proj.layers) == depth
    hs = th.normal(4, (2, 5, embed_dim))
    want = JaxResampler(cross_attention_dim=cross, embed_dim=embed_dim, hidden_dim=hidden, depth=depth,
                        heads=max(1, hidden // 64), num_queries=tokens).apply(
        th.to_jnp(convert_resampler_state_dict(sd)), jnp.asarray(hs))
    with torch.no_grad():
        got = proj(torch.from_numpy(hs))
    assert tuple(got.shape) == (2, tokens, cross)
    assert th.max_rel_err(got.numpy(), np.asarray(want)) < PROJ_TOL
    # the trap the JAX package keeps: the feed-forward's tanh gelu; the exact one is another function
    exact = copy.deepcopy(proj)
    for _, ff in exact.layers:
        ff[2].approximate = "none"
    with torch.no_grad():
        assert th.max_rel_err(exact(torch.from_numpy(hs)).numpy(), np.asarray(want)) > PROJ_TOL


def test_plus_query_count_must_match_the_unet():
    sd = image_proj_dict(5, 32, 4, plus=True)
    with pytest.raises(ValueError, match="ip_num_tokens"):
        image_projection_from_state_dict(sd, 32, 16)


@pytest.mark.parametrize("name", ["TINY_UNET_IP", "TINY_SDXL_UNET", "SD15_UNET", "SD21_UNET", "SDXL_UNET"])
def test_unet_attention_order_matches_jax(name):
    """Down, up, then the mid block last, as the checkpoints number them."""
    cfg = getattr(configs, name)
    want = [".".join(_unfold(part) for part in path) for path in jax_attention_order(cfg)]
    assert unet_attention_order(cfg) == want
    if name == "SD15_UNET":
        assert len(want) == 16 and want[-1].startswith("mid_block")


@pytest.fixture(scope="module")
def unets():
    jax_model, params = th.jax_unet_and_params(UNET_IP, seed=0)
    return jax_model, params, th.port_unet(UNET_IP, params)


def test_ip_unet_state_dict_round_trip(unets):
    """The IP UNet's to_k_ip / to_v_ip reach the port through
    unet_state_dict_from_flax (strict, in the fixture) and back, leaf for leaf."""
    _, params, unet = unets
    ip_keys = [k for k in unet.state_dict() if "_ip." in k]
    assert len(ip_keys) == 2 * len(unet_attention_order(UNET_IP)) and all(".attn2." in k for k in ip_keys)
    back = dict(jax.tree_util.tree_flatten_with_path(convert_unet_state_dict(unet.state_dict()))[0])
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(back) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(back[path]), leaf, err_msg=jax.tree_util.keystr(path))


def test_ip_adapter_state_dict_names_and_count():
    sd = checkpoint(UNET_IP, 6)
    mapped = ip_adapter_state_dict(sd, UNET_IP)
    order = unet_attention_order(UNET_IP)
    assert list(mapped) == [f"{n}.{p}.weight" for n in order for p in ("to_k_ip", "to_v_ip")]
    short = {"image_proj": sd["image_proj"], "ip_adapter": {k: v for k, v in sd["ip_adapter"].items()
                                                            if not k.startswith("1.")}}
    with pytest.raises(ValueError, match="cross-attention entries"):
        ip_adapter_state_dict(short, UNET_IP)


# (name, JAX AidMode, port AidMode, batched CFG, force_vanilla)
UNET_CASES = {
    "own": (JaxAidMode.vanilla(has_ip=True), AidMode.vanilla(has_ip=True), False, None),
    **{m: (JaxAidMode.from_name(m, has_ip=True), AidMode.from_name(m, has_ip=True), False, None)
       for m in ("pure_outer", "fused_outer", "pure_inner", "fused_inner")},
    "scale_control": (JaxAidMode.from_name("scale_control"), AidMode.from_name("scale_control"), False, None),
    "batched_fused_outer": (JaxAidMode.from_name("fused_outer", has_ip=True),
                            AidMode.from_name("fused_outer", has_ip=True), True, None),
    "batched_pure_inner": (JaxAidMode.from_name("pure_inner", has_ip=True),
                           AidMode.from_name("pure_inner", has_ip=True), True, None),
    "batched_scale_control": (JaxAidMode.from_name("scale_control"), AidMode.from_name("scale_control"), True,
                              None),
    "fused_outer_forced": (JaxAidMode.from_name("fused_outer", has_ip=True),
                           AidMode.from_name("fused_outer", has_ip=True), False, True),
    "pure_outer_forced": (JaxAidMode.from_name("pure_outer", has_ip=True),
                          AidMode.from_name("pure_outer", has_ip=True), False, True),
}


@pytest.mark.parametrize("case", list(UNET_CASES))
def test_unet_forward_with_ip_matches_jax(unets, case):
    """The UNet forward with IP tokens in every IP mode: "own" beside
    vanilla text attention, the four interpolating modes on both branches,
    scale control (text fused_outer, IP "own" weighted by the coefficient),
    batched CFG (cond rows' IP endpoints per row, uncond rows their own),
    and force_vanilla through a fused and a pure mode."""
    jax_model, params, unet = unets
    jmode, mode, batched, force = UNET_CASES[case]
    B, s, T = 3, UNET_IP.sample_size, UNET_IP.ip_num_tokens
    coef = np.array([0.0, 0.4, 1.0], np.float32)
    if batched:
        B, coef = 6, np.concatenate([coef, coef])
        jmode, mode = dataclasses.replace(jmode, cfg_split=3), dataclasses.replace(mode, cfg_split=3)
    x = th.normal(1, (B, s, s, UNET_IP.in_channels))
    ehs = th.normal(2, (B, 77, UNET_IP.cross_attention_dim))
    ip = th.normal(3, (B, T, UNET_IP.cross_attention_dim))

    def jax_forward(p, x, e, c, ip):
        aid = JaxAidContext(coef=c, mode=jmode, ip_hidden_states=ip, ip_scale=IP_SCALE,
                            force_vanilla=None if force is None else jnp.asarray(force))
        return jax_model.apply(p, x, jnp.array(321.0), e, aid)

    want = jax.jit(jax_forward)(th.to_jnp(params), jnp.asarray(x), jnp.asarray(ehs), jnp.asarray(coef),
                                jnp.asarray(ip))
    aid = AidContext(coef=torch.from_numpy(coef), mode=mode, force_vanilla=force,
                     ip_hidden_states=torch.from_numpy(ip), ip_scale=IP_SCALE)
    with torch.no_grad():
        got = unet(th.nhwc_to_nchw(x), torch.tensor(321.0), torch.from_numpy(ehs), aid)
        no_ip = unet(th.nhwc_to_nchw(x), torch.tensor(321.0), torch.from_numpy(ehs),
                     dataclasses.replace(aid, ip_hidden_states=None))
    assert th.max_rel_err(th.nchw_to_nhwc(got), np.asarray(want)) < FWD_TOL
    assert th.max_rel_err(th.nchw_to_nhwc(no_ip), np.asarray(want)) > 100 * FWD_TOL  # the branch is there


# --- the pipelines -------------------------------------------------------


@pytest.fixture(scope="module")
def sd_ip_pipes():
    from test_torch_pipeline_sd import sd_pipes

    return sd_pipes(UNET_IP)


def _fresh(pipes):
    """Copies of both pipelines whose UNet weights an adapter may overwrite."""
    jax_pipe, pipe = pipes
    return dataclasses.replace(jax_pipe), dataclasses.replace(pipe, unet=copy.deepcopy(pipe.unet))


def _latents(seed=40, cfg=UNET_IP):
    s, c = cfg.sample_size, cfg.in_channels
    return th.normal(seed, (1, s, s, c)), th.normal(seed + 1, (1, s, s, c))


def _flat(sd):
    """An h94 checkpoint as one flat safetensors dict (``image_proj.*``, ``ip_adapter.*``)."""
    return {f"{group}.{k}": torch.from_numpy(np.ascontiguousarray(v)) for group in ("image_proj", "ip_adapter")
            for k, v in sd[group].items()}


def _embeds(plus, seed=50, n_seq=5):
    shape = (1, n_seq, EMBED_DIM) if plus else (1, EMBED_DIM)
    return th.normal(seed, shape), th.normal(seed + 1, shape), th.normal(seed + 2, shape)


def _interpolate_single(jax_pipe, pipe, cfg=UNET_IP, **kw):
    """Both pipelines' interpolate_single latents from the same inputs;
    numpy image embeds go to both, and a (JAX, port) pair splits into each
    side's value."""
    a, b = _latents(cfg=cfg)
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v[0] if isinstance(v, tuple) else v
           for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v[1] if isinstance(v, tuple) else v
           for k, v in kw.items()}
    common = dict(prompt_start="a red cat", prompt_end="a blue dog", num_inference_steps=STEPS,
                  output_type="latent")
    want = jax_pipe.interpolate_single(0.4, jnp.asarray(a), jnp.asarray(b), **common, **jkw)
    got = pipe.interpolate_single(0.4, th.nhwc_to_nchw(a), th.nhwc_to_nchw(b), **common, **tkw)
    assert torch.isfinite(got).all()
    return got, want


@pytest.mark.parametrize("source", ["dict", "safetensors"])
@pytest.mark.parametrize("kind", ["standard", "plus"])
def test_load_aid_ip_adapter_matches_jax(sd_ip_pipes, tmp_path, kind, source):
    """load_aid_ip_adapter from an h94 dict and from one .safetensors file,
    standard and Plus: the same weights land in both UNets and projections,
    and interpolate_single with image embeds agrees."""
    plus = kind == "plus"
    jax_pipe, pipe = _fresh(sd_ip_pipes)
    sd = checkpoint(UNET_IP, 7, plus=plus)
    if source == "safetensors":
        path = str(tmp_path / "ip_adapter.safetensors")
        save_safetensors(_flat(sd), path)
        jax_pipe.load_aid_ip_adapter(path, scale=IP_SCALE)
        pipe.load_aid_ip_adapter(path, scale=IP_SCALE)
    else:
        jax_pipe.load_aid_ip_adapter(sd, scale=IP_SCALE)
        pipe.load_aid_ip_adapter(sd, scale=IP_SCALE)
    assert pipe.has_ip and pipe.ip_plus == plus and isinstance(pipe.ip_proj, Resampler if plus else ImageProjection)
    params = dict(pipe.unet.named_parameters())
    for name, w in ip_adapter_state_dict(sd, UNET_IP).items():
        np.testing.assert_array_equal(params[name].detach().numpy(), w.numpy())
    e0, e1, _ = _embeds(plus)
    with torch.no_grad():
        got_tokens = pipe._project_ip(torch.from_numpy(e0))
    want_tokens = jax_pipe._project_ip(jnp.asarray(e0))
    assert th.max_rel_err(got_tokens.numpy(), np.asarray(want_tokens)) < PROJ_TOL
    got, want = _interpolate_single(jax_pipe, pipe, image_embeds_start=e0, image_embeds_end=e1)
    assert th.max_rel_err(th.nchw_to_nhwc(got), np.asarray(want)) < SLICE_TOL


def test_load_aid_ip_adapter_needs_ip_tokens():
    """A UNet built without IP tokens has no projections to load into: the
    JAX package's precondition, stated as an error that names the field."""
    from test_torch_pipeline_sd import sd_pipes

    _, pipe = sd_pipes()
    with pytest.raises(ValueError, match="ip_num_tokens"):
        pipe.load_aid_ip_adapter(checkpoint(UNET_IP, 8))
    with pytest.raises(ValueError, match="load_aid_ip_adapter"):
        pipe.interpolate_single(0.5, image_embeds_end=torch.zeros(1, EMBED_DIM), num_inference_steps=1)
    with pytest.raises(ValueError, match="load_aid_ip_adapter"):
        pipe.interpolate_single(0.5, early="scale_control", num_inference_steps=1)


# (early, late, scale control, cfg_mode, with the start embeds, with negative embeds)
SINGLE_CASES = {
    "fused_outer": ("fused_outer", "self", False, "sequential", True, True),
    "pure_inner": ("pure_inner", "self", False, "sequential", True, False),
    "fused_inner_slerp": ("fused_inner", "self", False, "sequential", True, True),
    "pure_outer_batched": ("pure_outer", "self", False, "batched", True, True),
    "scale_control_default": ("fused_outer", "self", True, "sequential", False, False),
    "scale_control_batched": ("fused_outer", "self", True, "batched", False, True),
}


@pytest.mark.parametrize("case", list(SINGLE_CASES))
def test_interpolate_single_with_image_embeds_matches_jax(sd_ip_pipes, case):
    """interpolate_single with image embeds in several early modes (the
    inner ones, which the reference crashes on, as the JAX package
    implements them), a slerped IP point, batched CFG, and scale control:
    only the end embeds, the start taken from the negative embeds, which
    default to zeros."""
    early, late, scale_control, cfg_mode, with_start, with_negative = SINGLE_CASES[case]
    jax_pipe, pipe = _fresh(sd_ip_pipes)
    sd = checkpoint(UNET_IP, 9)
    # the JAX pipeline takes scale control at load time, the port per call
    jax_pipe.load_aid_ip_adapter(sd, scale=IP_SCALE, early="scale_control" if scale_control else early)
    pipe.load_aid_ip_adapter(sd, scale=IP_SCALE)
    if scale_control:  # its late steps are vanilla, so it takes no other late mode
        with pytest.raises(ValueError, match="late"):
            pipe._aid_modes("scale_control", "fused_outer")
    jax_pipe.cfg_mode = pipe.cfg_mode = cfg_mode
    e0, e1, neg = _embeds(False, seed=60)
    kw = dict(late=late, image_embeds_end=e1, init="slerp" if case.endswith("slerp") else "linear",
              early=(early, "scale_control" if scale_control else early))
    if with_start:
        kw["image_embeds_start"] = e0
    if with_negative:
        kw["negative_image_embeds"] = neg
    got, want = _interpolate_single(jax_pipe, pipe, **kw)
    assert th.max_rel_err(th.nchw_to_nhwc(got), np.asarray(want)) < SLICE_TOL


@pytest.mark.parametrize("kind", ["standard", "plus"])
def test_encode_image_matches_jax(sd_ip_pipes, kind):
    """encode_image: the attached CLIP vision tower's projected pooled
    embeds for a standard adapter, its penultimate hidden states for Plus
    (the same seeded tower on both sides)."""
    plus = kind == "plus"
    cfg = dataclasses.replace(configs.TINY_CLIP_VISION, projection_dim=EMBED_DIM, hidden_size=EMBED_DIM,
                              intermediate_size=2 * EMBED_DIM)
    from aid_tpu.models import configs as jax_configs

    jcfg = jax_configs.CLIPVisionConfig(**dataclasses.asdict(cfg))
    encoder = th.seed_module(CLIPVisionModel(cfg), 11)
    enc_params = th.to_jnp(convert_clip_vision_state_dict(th.numpy_state_dict(encoder)))
    jax_pipe, pipe = _fresh(sd_ip_pipes)
    sd = checkpoint(UNET_IP, 10, plus=plus)
    jax_pipe.load_aid_ip_adapter(sd, image_encoder=JaxVision(jcfg), image_encoder_params=enc_params)
    pipe.load_aid_ip_adapter(sd, image_encoder=encoder)
    frames = th.rng(12).integers(0, 256, (2, 40, 40, 3)).astype(np.uint8)
    want = np.asarray(jax_pipe.encode_image(jnp.asarray(frames)))
    got = pipe.encode_image(frames)
    n_tokens = (cfg.image_size // cfg.patch_size) ** 2 + 1
    assert tuple(got.shape) == ((2, n_tokens, cfg.hidden_size) if plus else (2, cfg.projection_dim))
    assert th.max_rel_err(got.numpy(), want) < PROJ_TOL
    # the embeds drive the pipeline: start and end from the two frames
    got_l, want_l = _interpolate_single(jax_pipe, pipe, image_embeds_start=got[:1].numpy(),
                                        image_embeds_end=got[1:].numpy())
    assert th.max_rel_err(th.nchw_to_nhwc(got_l), np.asarray(want_l)) < SLICE_TOL


@pytest.mark.parametrize("case", ["plus", "scale_control"])
def test_xl_interpolate_single_with_image_embeds_matches_jax(case):
    """The XL pipeline's interpolate_single with a Plus adapter, and in
    scale control with only the end embeds."""
    from test_torch_pipeline_sdxl import UNET_CFG, xl_pipes

    cfg = dataclasses.replace(UNET_CFG, ip_num_tokens=4, ip_hidden_dim=EMBED_DIM)
    jax_pipe, pipe = xl_pipes(cfg)
    plus = case == "plus"
    sd = checkpoint(cfg, 13, plus=plus)
    early = "scale_control" if case == "scale_control" else "fused_outer"
    jax_pipe.load_aid_ip_adapter(sd, scale=IP_SCALE, early=early)
    pipe.load_aid_ip_adapter(sd, scale=IP_SCALE)
    e0, e1, _ = _embeds(plus, seed=70)
    kw = dict(image_embeds_end=e1) if case == "scale_control" else dict(image_embeds_start=e0, image_embeds_end=e1)
    kw["early"] = ("fused_outer", early)
    got, want = _interpolate_single(jax_pipe, pipe, cfg=cfg, **kw)
    assert th.max_rel_err(th.nchw_to_nhwc(got), np.asarray(want)) < SLICE_TOL


def test_beta_prior_runs_with_image_embeds(sd_ip_pipes):
    """The Beta-prior selection forwards image embeds to interpolate_single
    (prior/beta.py): they are not batchable, so batch_k 4 explores one
    frame a run, and every explored frame is that run's middle; the first
    (t = 0.5) agrees with the JAX pipeline's to one uint8 step."""
    from aid_tpu_torch.prior.beta import BetaPriorPipeline

    jax_pipe, pipe = _fresh(sd_ip_pipes)
    sd = checkpoint(UNET_IP, 16)
    jax_pipe.load_aid_ip_adapter(sd, scale=IP_SCALE)
    pipe.load_aid_ip_adapter(sd, scale=IP_SCALE)
    e0, e1, _ = _embeds(False, seed=95)
    a, b = _latents(96)
    ta, tb = th.nhwc_to_nchw(a), th.nhwc_to_nchw(b)
    kw = dict(prompt_start="a red cat", prompt_end="a blue dog", num_inference_steps=STEPS,
              image_embeds_start=torch.from_numpy(e0), image_embeds_end=torch.from_numpy(e1))
    runs = []

    class Recording(BetaPriorPipeline):
        def _gen(self, t, **k):
            runs.append(t)
            return super()._gen(t, **k)

    bp = Recording(pipe, lambda ims: np.asarray(ims, np.float64).reshape(len(ims), -1))
    with pytest.warns(UserWarning, match="falling back to sequential exploration"):
        frames = bp.generate_interpolation(latent_start=ta, latent_end=tb, exploration_size=4, interpolation_size=3,
                                           batch_k=4, **kw)
    # t = 0.5, then one run per further interior point
    assert len(frames) == 3 and len(bp.xs) == 4 and runs[0] == 0.5 and sorted(runs) == bp.xs[1:-1]
    for t in runs:
        i = bp.xs.index(t)
        np.testing.assert_array_equal(bp.images[i], pipe.interpolate_single(t, ta, tb, **kw)[1])
    want = np.asarray(jax_pipe.interpolate_single(
        0.5, jnp.asarray(a), jnp.asarray(b), prompt_start="a red cat", prompt_end="a blue dog",
        num_inference_steps=STEPS, image_embeds_start=jnp.asarray(e0), image_embeds_end=jnp.asarray(e1)))
    assert np.abs(bp.images[bp.xs.index(0.5)].astype(int) - want[1].astype(int)).max() <= 1


# --- the engine ------------------------------------------------------------


# (early, loop_mode, cfg_mode, with uncond tokens)
ENGINE_CASES = {
    "fused_outer_split": ("fused_outer", "split", "sequential", True),
    "fused_outer_fused_loop": ("fused_outer", "fused", "sequential", True),
    "fused_inner_fused_loop_batched": ("fused_inner", "fused", "batched", True),
    "pure_outer_batched_zero_uncond": ("pure_outer", "split", "batched", False),
    "scale_control_fused_loop": ("scale_control", "fused", "sequential", True),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_denoise_sequence_with_ip_matches_jax(unets, case):
    """denoise_sequence with IP tokens, 4 DDIM steps (2 warmup): the split
    and the fused loop (the late steps' IP endpoints dropped by
    force_vanilla), sequential and batched CFG (uncond tokens given, or
    zeros by default), against the JAX engine in the same mode."""
    from aid_tpu.schedulers.ddim import DDIMScheduler as JaxDDIM
    from aid_tpu.pipelines import engine as jax_engine
    from aid_tpu_torch.pipelines import engine
    from aid_tpu_torch.schedulers.ddim import DDIMScheduler

    early, loop_mode, cfg_mode, with_uncond = ENGINE_CASES[case]
    jax_model, params, unet = unets
    frames, steps, s, T = 3, 4, UNET_IP.sample_size, UNET_IP.ip_num_tokens
    latents = th.normal(20, (frames, s, s, UNET_IP.in_channels))
    embs, uncond = (th.normal(21 + i, (frames, 77, UNET_IP.cross_attention_dim)) for i in range(2))
    ip, ip_un = (th.normal(23 + i, (frames, T, UNET_IP.cross_attention_dim)) for i in range(2))
    coef = np.array([0.0, 0.4, 1.0], np.float32)
    if early == "scale_control":
        jmodes = (JaxAidMode.from_name("scale_control"), JaxAidMode.vanilla(scale_control=True))
        modes = (AidMode.from_name("scale_control"), AidMode.vanilla(scale_control=True))
    else:
        jmodes = (JaxAidMode.from_name(early, has_ip=True), JaxAidMode.vanilla(has_ip=True))
        modes = (AidMode.from_name(early, has_ip=True), AidMode.vanilla(has_ip=True))
    jsched, sched = JaxDDIM(), DDIMScheduler()
    want = jax_engine.denoise_sequence(
        jax_model, jsched, th.to_jnp(params), jnp.asarray(latents), jnp.asarray(embs), jnp.asarray(uncond),
        jnp.asarray(coef), jsched.init(steps), jnp.float32(7.5), early=jmodes[0], late=jmodes[1], num_steps=steps,
        warmup_steps=2, ip_embeds=jnp.asarray(ip), ip_uncond_embeds=jnp.asarray(ip_un) if with_uncond else None,
        ip_scale=IP_SCALE, cfg_mode=cfg_mode, loop_mode=loop_mode)
    got = engine.denoise_sequence(
        unet, sched, th.nhwc_to_nchw(latents), torch.from_numpy(embs), torch.from_numpy(uncond),
        torch.from_numpy(coef), sched.init(steps), 7.5, early=modes[0], late=modes[1], num_steps=steps,
        warmup_steps=2, ip_embeds=torch.from_numpy(ip), ip_uncond_embeds=torch.from_numpy(ip_un) if with_uncond
        else None, ip_scale=IP_SCALE, cfg_mode=cfg_mode, loop_mode=loop_mode)
    assert torch.isfinite(got).all()
    assert th.max_rel_err(th.nchw_to_nhwc(got), np.asarray(want)) < SLICE_TOL


def test_denoise_range_with_ip_tokens(unets):
    """denoise_range with IP tokens is the vanilla IP-Adapter: every frame
    attends its own tokens, as the JAX engine's steps in vanilla(has_ip)
    mode; without tokens it is the vanilla loop it was."""
    from aid_tpu.schedulers.ddim import DDIMScheduler as JaxDDIM
    from aid_tpu.pipelines import engine as jax_engine
    from aid_tpu_torch.pipelines import engine
    from aid_tpu_torch.schedulers.ddim import DDIMScheduler

    jax_model, params, unet = unets
    frames, steps, s, T = 2, 3, UNET_IP.sample_size, UNET_IP.ip_num_tokens
    latents = th.normal(30, (frames, s, s, UNET_IP.in_channels))
    embs, uncond = (th.normal(31 + i, (frames, 77, UNET_IP.cross_attention_dim)) for i in range(2))
    ip, ip_un = (th.normal(33 + i, (frames, T, UNET_IP.cross_attention_dim)) for i in range(2))
    jsched, sched = JaxDDIM(), DDIMScheduler()
    vanilla = JaxAidMode.vanilla(has_ip=True)
    want, _ = jax_engine.denoise_steps(
        jax_model, jsched, th.to_jnp(params), jnp.asarray(latents), jnp.asarray(embs), jnp.asarray(uncond),
        jnp.zeros(frames), jsched.init(steps), jnp.float32(7.5), early=vanilla, late=vanilla, start=0, end=steps,
        warmup_steps=0, ip_embeds=jnp.asarray(ip), ip_uncond_embeds=jnp.asarray(ip_un), ip_scale=IP_SCALE)
    args = (unet, sched, th.nhwc_to_nchw(latents), torch.from_numpy(embs), torch.from_numpy(uncond))
    got, _ = engine.denoise_range(*args, sched.init(steps), 7.5, start=0, end=steps, ip_embeds=torch.from_numpy(ip),
                                  ip_uncond_embeds=torch.from_numpy(ip_un), ip_scale=IP_SCALE)
    assert th.max_rel_err(th.nchw_to_nhwc(got), np.asarray(want)) < SLICE_TOL
    plain, _ = engine.denoise_range(*args, sched.init(steps), 7.5, start=0, end=steps)
    assert th.max_rel_err(th.nchw_to_nhwc(plain), np.asarray(want)) > 100 * SLICE_TOL
