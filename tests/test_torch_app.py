"""The port's Gradio app, on the CPU (gradio is not installed here).

Mirrors tests/test_app.py: the examples, defaults and plot data against the
JAX app's, and ``build_app`` wired through a stub gradio module. The wired
``generate`` runs a tiny CPU pipeline and must give the images of one
direct ``interpolate`` call.
"""

import sys
import types

import numpy as np
import pytest
import torch

from aid_tpu.apps import gradio_app as jax_app
from aid_tpu_torch.apps import gradio_app as app
from aid_tpu_torch.apps.gradio_app import EARLY_CHOICES, LATE_CHOICES, beta_plot_data, get_examples, model_defaults


class TestAppData:
    def test_examples_match_the_jax_app(self):
        """The reference gallery's 4 examples (2 SD PAID, 2 SDXL AID), the
        choices and the per-model defaults, as the JAX app has them."""
        ex = get_examples()
        assert ex == jax_app.get_examples()
        assert (EARLY_CHOICES, LATE_CHOICES) == (jax_app.EARLY_CHOICES, jax_app.LATE_CHOICES)
        assert app.MODEL_DEFAULTS == jax_app.MODEL_DEFAULTS
        for row in ex:
            (p1, p2, guide, neg, model, size, alpha, beta, warmup, guidance, steps, early, late, seed,
             same_latent) = row
            assert isinstance(p1, str) and isinstance(p2, str)
            assert model in ("sd15", "sd21", "sdxl") and 3 <= size <= 15
            assert early in EARLY_CHOICES and late in LATE_CHOICES and 0.0 <= warmup <= 1.0
        assert ex[0][2] is not None and ex[2][2] is None  # PAID guide prompt; plain AID

    def test_model_defaults(self):
        assert model_defaults("sd15")["guidance"] == 10.0
        assert model_defaults("sdxl")["steps"] == 28
        assert model_defaults("unknown") == model_defaults("sd15")

    @pytest.mark.parametrize("size,alpha,beta", [(7, 25, 25), (3, 6.0, 3.0), (15, 530.0, 602.0)])
    def test_beta_plot_matches_the_jax_app(self, size, alpha, beta):
        d = beta_plot_data(size, alpha, beta)
        want = jax_app.beta_plot_data(size, alpha, beta)
        assert d["x"] == want["x"]
        np.testing.assert_allclose(d["y"], want["y"], rtol=0, atol=1e-12)
        assert d["y"][0] == 0.0 and d["y"][-1] == 1.0
        assert all(b >= a for a, b in zip(d["y"], d["y"][1:]))


def _stub_gradio():
    """A minimal gradio stand-in recording the component wiring (as
    tests/test_app.py's)."""
    g = types.ModuleType("gradio")
    registry = {"clicks": [], "changes": [], "examples": []}

    class _Component:
        def __init__(self, *args, **kwargs):
            self.args, self.kwargs = args, kwargs

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def change(self, fn, inputs, outputs):
            registry["changes"].append((fn, inputs, outputs))

        def click(self, fn, inputs, outputs):
            registry["clicks"].append((fn, inputs, outputs))

    class Blocks(_Component):
        def launch(self, **kwargs):
            raise AssertionError("launch() must not be called in tests")

    class Examples(_Component):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            registry["examples"].append(kwargs)

    for name in ("Markdown", "Dropdown", "Textbox", "Row", "Slider", "Number", "Checkbox", "LinePlot", "Gallery",
                 "Button"):
        setattr(g, name, type(name, (_Component,), {}))
    g.Blocks, g.Examples = Blocks, Examples
    g.update = lambda **kwargs: kwargs
    g._registry = registry
    return g


def test_build_app_without_gradio_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)  # import gradio -> ImportError
    with pytest.raises(ImportError, match="gradio is not installed"):
        app.build_app(lambda name: None)


def test_component_tree_wires_generate_to_interpolate(monkeypatch):
    """build_app builds the Blocks tree and wires the Generate button to a
    function that draws the latents from seeded generators on the
    pipeline's device and makes ONE interpolate() call."""
    g = _stub_gradio()
    monkeypatch.setitem(sys.modules, "gradio", g)
    calls = {"latents": [], "models": []}

    class FakePipe:
        device = torch.device("cpu")

        def generate_latent(self, generator):
            calls["latents"].append(generator.initial_seed())
            return torch.zeros((1, 4, 4, 4))

        def interpolate(self, l0, l1, p1, p2, **kw):
            calls["interpolate"] = dict(p1=p1, p2=p2, **kw)
            return np.zeros((kw["size"], 8, 8, 3), np.uint8)

    def factory(name):
        calls["models"].append(name)
        return FakePipe()

    demo = app.build_app(factory)
    assert isinstance(demo, g.Blocks)
    assert len(g._registry["clicks"]) == 1  # the Generate button
    fn, inputs, gallery = g._registry["clicks"][0]
    assert len(inputs) == 15  # model + 14 controls, the reference's arity
    assert g._registry["examples"] and len(g._registry["examples"][0]["examples"]) == 4
    assert len(g._registry["changes"]) >= 4  # beta plot (3) + model switch

    out = fn("sd15", "a cat", "a dog", "", "", 5, 25.0, 25.0, 0.5, 10.0, 25, "fused_outer", "self", 0, False)
    assert calls["interpolate"]["size"] == 5 and calls["interpolate"]["guide_prompt"] is None  # "" -> None
    assert calls["latents"] == [0, 1] and len(out) == 5
    fn("sd15", "a", "b", "g", "", 3, 1.0, 1.0, 0.5, 7.5, 10, "fused_outer", "self", 4, True)
    assert calls["latents"][2:] == [4]  # same_latent: one latent drawn
    assert calls["interpolate"]["guide_prompt"] == "g"
    assert calls["models"] == ["sd15"]  # the pipeline is kept while the model stays


def _tiny_pipeline():
    from aid_tpu_torch.models import configs
    from aid_tpu_torch.models.clip import CLIPTextModel
    from aid_tpu_torch.models.unet import UNet2DCondition
    from aid_tpu_torch.models.vae import AutoencoderKL
    from aid_tpu_torch.pipelines.interpolation import InterpolationPipeline
    from aid_tpu_torch.utils.tokenizer import HashTokenizer

    torch.manual_seed(0)
    return InterpolationPipeline(
        unet=UNet2DCondition(configs.TINY_UNET).eval(), vae=AutoencoderKL(configs.TINY_VAE).eval(),
        text_encoder=CLIPTextModel(configs.TINY_CLIP_TEXT).eval(),
        tokenizer=HashTokenizer(configs.TINY_CLIP_TEXT.vocab_size), vae_scale_factor=2)


def test_generate_is_one_interpolate_call_on_a_tiny_pipeline(monkeypatch):
    """The wired generate() on a tiny CPU pipeline returns the frames of
    interpolate() called directly with the same seeded latents and
    controls, bit for bit."""
    g = _stub_gradio()
    monkeypatch.setitem(sys.modules, "gradio", g)
    pipe = _tiny_pipeline()
    app.build_app(lambda name: pipe)
    fn = g._registry["clicks"][0][0]
    frames = fn("sd15", "a cat", "a dog", "", "", 3, 2.0, 2.0, 0.5, 7.5, 2, "fused_outer", "self", 0, False)
    want = pipe.interpolate(app.seeded_latent(pipe, 0), app.seeded_latent(pipe, 1), "a cat", "a dog",
                            guide_prompt=None, negative_prompt="", size=3, num_inference_steps=2, warmup_ratio=0.5,
                            early="fused_outer", late="self", alpha=2.0, beta=2.0, guidance_scale=7.5)
    assert len(frames) == 3 and frames[0].size == (16, 16)  # PIL (w, h)
    np.testing.assert_array_equal(np.stack([np.asarray(f) for f in frames]), want)


@pytest.mark.parametrize("cpu", [False, True])
def test_pipeline_factory_places_by_the_cpu_switch(monkeypatch, cpu):
    """Every model loads on the card by default; ENABLE_CPU_OFFLOAD=1 is the
    user asking for the CPU (device "cpu", f32). SD models load with UniPC at
    guidance 10, SDXL with its checkpoint's scheduler."""
    from aid_tpu_torch.models import loader

    seen = []
    monkeypatch.setattr(loader, "load_interpolation_pipeline", lambda root, **kw: seen.append(("sd", root, kw)))
    monkeypatch.setattr(loader, "load_interpolation_xl_pipeline", lambda root, **kw: seen.append(("xl", root, kw)))
    factory = app.pipeline_factory("/ckpt", cpu=cpu)
    factory("sd21"), factory("sdxl")
    place = dict(device="cpu", dtype=torch.float32) if cpu else {}
    assert seen == [("sd", "/ckpt", dict(scheduler_name="unipc", guidance_scale=10.0, **place)),
                    ("xl", "/ckpt", dict(scheduler_name="auto", **place))]
