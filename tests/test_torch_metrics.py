"""The port's metrics (LPIPS, the Gini smoothness) and invisible watermark
against aid_tpu's.

LPIPS runs at VGG16's full widths on 32x32 frames; its weights are the
port module's own, drawn from numpy with a seed, and reach JAX through
``convert_lpips_state_dict``. f32 on the CPU.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_helpers as th
from aid_tpu.metrics import gini as jax_gini
from aid_tpu.metrics.lpips import LPIPS as JaxLPIPS
from aid_tpu.metrics.lpips import compute_lpips as jax_compute_lpips
from aid_tpu.models.params import convert_lpips_state_dict
from aid_tpu.utils.watermark import InvisibleWatermark as JaxWatermark
from aid_tpu_torch.metrics import gini
from aid_tpu_torch.metrics.lpips import LPIPS, compute_lpips
from aid_tpu_torch.utils.watermark import WATERMARK_BITS, InvisibleWatermark

# f32 on both sides through 13 convs and five heads: summation order only
# (~1e-6 of the distances); a wrong normalisation order, norm epsilon, pool
# or head moves them by >= 1e-2.
LPIPS_TOL = 1e-4


@pytest.fixture(scope="module")
def lpips_pair():
    model = th.seed_module(LPIPS(), 11)
    return model, th.to_jnp(convert_lpips_state_dict(th.numpy_state_dict(model)))


def test_lpips_names_are_the_lpips_packages():
    """lpips.LPIPS(net='vgg')'s keys: torchvision's global VGG16 indices in
    five slices, the heads' conv at model.1, the scaling layer's buffers."""
    keys = set(LPIPS().state_dict())
    convs = {1: (0, 2), 2: (5, 7), 3: (10, 12, 14), 4: (17, 19, 21), 5: (24, 26, 28)}
    want = {f"net.slice{s}.{i}.{leaf}" for s, idx in convs.items() for i in idx for leaf in ("weight", "bias")}
    want |= {f"lin{i}.model.1.weight" for i in range(5)} | {"scaling_layer.shift", "scaling_layer.scale"}
    assert keys == want


def test_lpips_matches_jax(lpips_pair):
    model, params = lpips_pair
    x0, x1 = th.normal(12, (3, 32, 32, 3)), th.normal(13, (3, 32, 32, 3))
    want = np.asarray(JaxLPIPS().apply(params, jnp.asarray(x0), jnp.asarray(x1)))
    with torch.no_grad():
        got = model(th.nhwc_to_nchw(x0), th.nhwc_to_nchw(x1)).numpy()
    assert got.shape == (3,)
    assert th.max_rel_err(got, want) < LPIPS_TOL
    with torch.no_grad():
        same = model(th.nhwc_to_nchw(x0), th.nhwc_to_nchw(x0)).numpy()
    np.testing.assert_array_equal(same, 0.0)


@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_compute_lpips_matches_jax(lpips_pair, kind):
    """Adjacent pairs of a 4-frame sequence in one batched call, ImageNet's
    normalisation first, as the JAX compute_lpips."""
    model, params = lpips_pair
    r = th.rng(14)
    frames = (r.integers(0, 256, (4, 32, 32, 3)).astype(np.uint8) if kind == "uint8"
              else r.random((4, 32, 32, 3)).astype(np.float32))
    calls = []
    model.register_forward_hook(lambda m, i, o: calls.append(i[0].shape[0]))
    got = compute_lpips(frames, model)
    want = jax_compute_lpips(frames, functools.partial(JaxLPIPS().apply, params))
    assert calls == [3] and got.shape == (3,) and got.dtype == np.float32
    assert th.max_rel_err(got, want) < LPIPS_TOL


@pytest.mark.parametrize("case", ["random", "tied", "zeros", "one", "mixed_zero"])
def test_gini_and_smoothness_match_jax(case):
    d = {"random": th.rng(15).uniform(0.0, 1.0, 11), "tied": np.array([0.3, 0.3, 0.7, 0.7, 0.3]),
         "zeros": np.zeros(4), "one": np.array([0.4]), "mixed_zero": np.array([0.0, 0.0, 0.5])}[case]
    assert abs(gini.compute_gini(d) - jax_gini.compute_gini(d)) < 1e-12
    got = gini.compute_smoothness_and_consistency(d)
    want = jax_gini.compute_smoothness_and_consistency(d)
    assert all(abs(g - w) < 1e-12 for g, w in zip(got, want))
    if case == "random":  # the reference's O(n^2) double loop
        tot = sum(abs(a - b) for a in d for b in d)
        assert abs(gini.compute_gini(d) - tot / (2 * d.size ** 2 * d.mean())) < 1e-12
    if case == "zeros":
        assert gini.compute_gini(d) == 0.0 and got == (1.0, 0.0, 0.0)


def test_separate_source_and_interpolated_images():
    frames = np.arange(5 * 2 * 2 * 3).reshape(5, 2, 2, 3)
    src, mid = gini.separate_source_and_interpolated_images(frames)
    want_src, want_mid = jax_gini.separate_source_and_interpolated_images(frames)
    np.testing.assert_array_equal(src, want_src)
    np.testing.assert_array_equal(mid, want_mid)
    with pytest.raises(ValueError):
        gini.separate_source_and_interpolated_images(frames[:1])


def _smooth_frames(seed, n=2, size=128):
    r = th.rng(seed)
    base = r.integers(40, 216, size=(n, size // 8, size // 8, 3)).astype(np.float64)
    return np.clip(np.kron(base, np.ones((1, 8, 8, 1))) + r.normal(0, 6, (n, size, size, 3)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("bits", [None, [1, 0, 1, 1, 0, 0, 1, 0]], ids=["diffusers", "custom"])
def test_watermark_is_byte_identical_to_jax(bits):
    """Random uint8 frames (pure noise and smooth ones) come out byte for
    byte as the JAX watermark's, and decode gives the bits back."""
    noise = th.rng(16).integers(0, 256, (2, 64, 96, 3)).astype(np.uint8)
    for frames in (noise, _smooth_frames(17)):
        got = InvisibleWatermark(bits=bits).apply(frames)
        np.testing.assert_array_equal(got, JaxWatermark(bits=bits).apply(frames))
    want_bits = WATERMARK_BITS if bits is None else bits
    np.testing.assert_array_equal(InvisibleWatermark(bits=bits).decode(got[0]), want_bits)
    np.testing.assert_array_equal(InvisibleWatermark(bits=bits).decode(got[0]),
                                  JaxWatermark(bits=bits).decode(got[0]))


def test_sdxl_decode_applies_the_watermarker():
    """InterpolationXLPipeline._decode marks every frame when a watermarker
    is set, and leaves them when it is None (the default)."""
    import dataclasses

    from aid_tpu_torch.models import configs
    from aid_tpu_torch.models.vae import AutoencoderKL
    from aid_tpu_torch.pipelines.sdxl import InterpolationXLPipeline

    fields = {f.name: f for f in dataclasses.fields(InterpolationXLPipeline)}
    assert fields["watermarker"].default is None
    vae = th.seed_module(AutoencoderKL(configs.TINY_VAE), 18)
    pipe = InterpolationXLPipeline(unet=None, vae=vae, text_encoder=None, tokenizer=None, vae_scale_factor=2)
    latents = torch.from_numpy(th.normal(19, (2, 4, 32, 32)))
    with torch.no_grad():
        plain = pipe._decode(latents, per_frame=True)
        wm = InvisibleWatermark()
        marked = dataclasses.replace(pipe, watermarker=wm)._decode(latents, per_frame=True)
    assert plain.shape == (2, 64, 64, 3)
    np.testing.assert_array_equal(marked, wm.apply(plain))
    assert (marked != plain).any()
