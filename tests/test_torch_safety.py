"""The port's CLIP vision tower, CLIP preprocessing and safety checker
against aid_tpu's.

Weights are the port modules' own, drawn from numpy with a seed
(``torch_helpers.seed_module``); the JAX side gets the same values through
its converters (``convert_clip_vision_state_dict``,
``convert_safety_checker_state_dict``). Inputs are seeded numpy arrays,
NCHW for the port and NHWC for JAX. f32 on the CPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_helpers as th
from aid_tpu.models import configs as jcfg
from aid_tpu.models.clip import CLIPVisionModel as JaxVision
from aid_tpu.models.params import convert_clip_vision_state_dict
from aid_tpu.models.safety import SafetyChecker as JaxChecker
from aid_tpu.models.safety import convert_safety_checker_state_dict
from aid_tpu.models.safety import run_safety_checker as jax_run_safety_checker
from aid_tpu.prior.clip_scorer import preprocess as jax_preprocess
from aid_tpu_torch.models import configs
from aid_tpu_torch.models.clip import CLIPVisionModel
from aid_tpu_torch.models.safety import SafetyChecker, _cos, run_safety_checker
from aid_tpu_torch.prior.clip_scorer import make_clip_feature_fn, preprocess

CFG = configs.TINY_CLIP_VISION
JCFG = jcfg.TINY_CLIP_VISION
# f32 on both sides over 2 layers of 17 tokens: summation order only (~1e-7
# of the output scale), as the text tower's CLIP_TOL (test_torch_clip.py);
# a wrong activation, epsilon, class token or patch order moves it by >= 1e-3.
CLIP_TOL = 1e-5
# The resize: torch's antialiased bilinear against jax.image.resize, 1e-5 of
# max |x| (measured 2-4e-7 downsampling, 2e-6 upsampling); without the
# antialias the 512 -> 224 frames differ by half the value range.
RESIZE_TOL = 1e-5
# A flag is a sign decision on a score: each score must sit farther than
# this from 0 for the two packages' flags to be comparable (the embeddings
# agree to ~1e-6, so cosines do to ~1e-6).
SCORE_MARGIN = 1e-4


def _pixels(seed, n=3, size=CFG.image_size):
    return th.normal(seed, (n, size, size, 3))


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_clip_vision_matches_jax(act):
    cfg = dataclasses.replace(CFG, hidden_act=act)
    model = th.seed_module(CLIPVisionModel(cfg), 1)
    params = convert_clip_vision_state_dict(th.numpy_state_dict(model))
    px = _pixels(2)
    want_embeds, want_hidden = JaxVision(dataclasses.replace(JCFG, hidden_act=act)).apply(
        th.to_jnp(params), jnp.asarray(px))
    with torch.no_grad():
        embeds, hidden = model(th.nhwc_to_nchw(px))
    assert tuple(embeds.shape) == (3, CFG.projection_dim)
    assert tuple(hidden.shape) == (3, (CFG.image_size // CFG.patch_size) ** 2 + 1, CFG.hidden_size)
    assert th.max_rel_err(embeds.numpy(), np.asarray(want_embeds)) < CLIP_TOL
    assert th.max_rel_err(hidden.numpy(), np.asarray(want_hidden)) < CLIP_TOL


@pytest.mark.parametrize("size", [512, 768, 64])
@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_preprocess_matches_jax(size, kind):
    """512 and 768 -> 224 downsample (JAX antialiases), 64 -> 224 upsamples."""
    r = th.rng(size)
    frames = (r.integers(0, 256, (2, size, size, 3)).astype(np.uint8) if kind == "uint8"
              else r.random((2, size, size, 3)).astype(np.float32))
    want = np.asarray(jax_preprocess(jnp.asarray(frames), 224))
    got = preprocess(frames, 224)
    assert tuple(got.shape) == (2, 3, 224, 224) and got.dtype == torch.float32
    assert th.max_rel_err(th.nchw_to_nhwc(got), want) < RESIZE_TOL
    plain = torch.nn.functional.interpolate(preprocess(frames, size), size=(224, 224), mode="bilinear")
    if size > 224:  # the trap: the resize without antialias is far off
        assert th.max_rel_err(th.nchw_to_nhwc(plain), want) > 0.1


def test_clip_feature_fn_is_one_batched_forward():
    model = th.seed_module(CLIPVisionModel(CFG), 3)
    calls = []
    model.register_forward_hook(lambda m, i, o: calls.append(i[0].shape[0]))
    frames = th.rng(4).integers(0, 256, (5, 48, 48, 3)).astype(np.uint8)
    feats = make_clip_feature_fn(model)(frames)
    assert calls == [5] and feats.shape == (5, CFG.projection_dim) and feats.dtype == np.float32
    params = convert_clip_vision_state_dict(th.numpy_state_dict(model))
    want, _ = JaxVision(JCFG).apply(th.to_jnp(params), jax_preprocess(jnp.asarray(frames), CFG.image_size))
    assert th.max_rel_err(feats, np.asarray(want)) < CLIP_TOL


def _checker(seed=5):
    checker = th.seed_module(SafetyChecker(CFG), seed)
    r = th.rng(seed + 1)
    with torch.no_grad():
        checker.concept_embeds.copy_(torch.from_numpy(r.standard_normal((17, CFG.projection_dim)).astype(np.float32)))
        checker.special_care_embeds.copy_(
            torch.from_numpy(r.standard_normal((3, CFG.projection_dim)).astype(np.float32)))
    return checker


def _thresholds(scores, above):
    """Per column j, a threshold halfway between two neighbouring sorted
    values with ``above[j]`` rows over it (0: 0.05 over the largest)."""
    s = np.sort(scores, axis=0)[::-1]
    out = s[0] + 0.05
    for j, k in enumerate(above):
        if k:
            out[j] = (s[k - 1, j] + s[k, j]) / 2
    return out


def _rig(checker, concept=None, special=None):
    with torch.no_grad():
        if concept is not None:
            checker.concept_embeds_weights.copy_(torch.as_tensor(concept, dtype=torch.float32))
        if special is not None:
            checker.special_care_embeds_weights.copy_(torch.as_tensor(special, dtype=torch.float32))
    return checker


def test_safety_checker_flags_match_jax():
    """Thresholds set between the frames' own cosines, so some frames are
    flagged and one triggers special care, and every score clears
    SCORE_MARGIN; then the flags of both packages equal each other and the
    float64 formula's."""
    checker = _checker()
    px = _pixels(6, n=6)
    with torch.no_grad():
        pooled, _ = checker.vision_model.vision_model(th.nhwc_to_nchw(px))
        embeds = checker.visual_projection(pooled)
        cos_c = _cos(embeds, checker.concept_embeds).double().numpy()
        cos_s = _cos(embeds, checker.special_care_embeds).double().numpy()
    s_thresh = _thresholds(cos_s, [1, 0, 0])
    special = cos_s - s_thresh
    adj = np.where((special > 0).any(axis=1), 0.01, 0.0)[:, None]
    c_thresh = _thresholds(cos_c + adj, [1, 1, 2])
    concept = cos_c - c_thresh + adj
    assert np.abs(special).min() > SCORE_MARGIN and np.abs(concept).min() > SCORE_MARGIN
    want = (concept > 0).any(axis=1)
    assert (special > 0).any(axis=1).sum() == 1 and 0 < want.sum() < 6
    _rig(checker, c_thresh, s_thresh)
    with torch.no_grad():
        got = checker(th.nhwc_to_nchw(px)).numpy()
    params = convert_safety_checker_state_dict(th.numpy_state_dict(checker))
    jax_flags = np.asarray(JaxChecker(JCFG).apply(th.to_jnp(params), jnp.asarray(px)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jax_flags, want)
    # adjustment moves only the special-care scores: a large negative one
    # clears special care, so the 0.01 stricter concept threshold goes too
    assert np.abs(cos_c - c_thresh).min() > SCORE_MARGIN
    with torch.no_grad():
        relaxed = checker(th.nhwc_to_nchw(px), adjustment=-10.0).numpy()
    np.testing.assert_array_equal(relaxed, ((cos_c - c_thresh) > 0).any(axis=1))


@pytest.mark.parametrize("thresh,flagged", [(-10.0, True), (10.0, False)], ids=["all", "none"])
def test_rigged_thresholds_flag_all_or_none(thresh, flagged):
    checker = _rig(_checker(), np.full(17, thresh), np.full(3, thresh))
    with torch.no_grad():
        flags = checker(th.nhwc_to_nchw(_pixels(7, n=4))).numpy()
    assert flags.dtype == np.bool_ and (flags == flagged).all()


def test_run_safety_checker_zeroes_exactly_the_flagged_frames():
    """uint8 frames at 48px (resized to the tower's 32): the flagged frames
    come out 0, the others untouched, as the JAX run_safety_checker."""
    frames = th.rng(8).integers(1, 256, (6, 48, 48, 3)).astype(np.uint8)
    checker = _checker()
    with torch.no_grad():
        pooled, _ = checker.vision_model.vision_model(preprocess(frames, CFG.image_size))
        cos_c = _cos(checker.visual_projection(pooled), checker.concept_embeds).double().numpy()
    c_thresh = _thresholds(cos_c, [1, 2])
    assert np.abs(cos_c - c_thresh).min() > SCORE_MARGIN
    _rig(checker, c_thresh, np.full(3, 10.0))  # no special care
    out, flags = run_safety_checker(frames, checker)
    assert 0 < flags.sum() < 6
    assert (out[flags] == 0).all()
    np.testing.assert_array_equal(out[~flags], frames[~flags])
    params = convert_safety_checker_state_dict(th.numpy_state_dict(checker))
    jax_out, jax_flags = jax_run_safety_checker(frames, JaxChecker(JCFG), th.to_jnp(params))
    np.testing.assert_array_equal(flags, jax_flags)
    np.testing.assert_array_equal(out, jax_out)
