"""The port's entry point, ``models/loader.py``, and its safetensors reader,
against the JAX package's loader.

A tiny SD 2.x-like diffusers directory is written the way a checkpoint ships
(``safetensors.numpy.save_file``, diffusers / transformers names, config.json
files): a UNet with linear projections and a list ``attention_head_dim``
(the legacy head-count naming), a VAE, a gelu text encoder, a byte-level
tokenizer padding with "!", and a DDIM scheduler config with
v-prediction. Weights are the JAX modules' init plus seeded noise. Both
loaders read that directory; the config readers must agree field by field,
the weights bit for bit (the VAE through the one-level seam of
tests/test_torch_vae.py), and ``interpolate(output_type="latent")`` with
UniPC within the stated tolerance. f32 on the CPU.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

import torch_helpers as th
from aid_tpu.models import configs as jcfg
from aid_tpu.models import loader as jloader
from aid_tpu.models.clip import CLIPTextModel as JaxCLIP
from aid_tpu.models.params import convert_vae_state_dict
from aid_tpu.models.vae import AutoencoderKL as JaxVAE
from aid_tpu_torch.models import loader
from aid_tpu_torch.models.params import clip_text_state_dict_from_flax, unet_state_dict_from_flax
from aid_tpu_torch.models.params import vae_state_dict_from_flax
from aid_tpu_torch.utils.safetensors import load_safetensors, save_safetensors
from aid_tpu_torch.utils.tokenizer import write_byte_level_tokenizer

UNET_CFG = dataclasses.replace(jcfg.TINY_UNET, use_linear_projection=True)
TEXT_CFG = dataclasses.replace(jcfg.TINY_CLIP_TEXT, hidden_act="gelu", eos_token_id=2)
VAE_CFG = jcfg.TINY_VAE
# UniPC over 3 steps x 2 UNet passes at guidance 10, f32 on both sides from
# the same weights: the per-forward ~1e-6 relative difference
# (test_torch_models.py) grows through the text encoder, the guidance and
# the multistep history; 1e-4 of max |ref| holds that with margin, while a
# wrong prediction type, timestep, pad id or weight moves the latents by
# >= 1e-2.
LATENT_TOL = 1e-4


def _numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _write_sd2_dir(root):
    """Write a tiny SD 2.x diffusers directory under ``root``."""
    _, unet_p = th.jax_unet_and_params(UNET_CFG, seed=3)
    s = UNET_CFG.sample_size
    noise = th.rng(31)

    def perturbed(params):
        return jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32) + (noise.standard_normal(a.shape) * 0.05).astype(np.float32), params)

    vae_p = perturbed(JaxVAE(VAE_CFG).init(jax.random.PRNGKey(4), jnp.zeros((1, 2 * s, 2 * s, 3))))
    text_p = perturbed(JaxCLIP(TEXT_CFG).init(jax.random.PRNGKey(5), jnp.zeros((1, 77), jnp.int32)))
    dirs = {n: os.path.join(root, n) for n in ("unet", "vae", "text_encoder", "tokenizer", "scheduler")}
    for d in dirs.values():
        os.makedirs(d)
    save_file(_numpy(unet_state_dict_from_flax(unet_p)), os.path.join(dirs["unet"], "diffusion_pytorch_model.safetensors"))
    save_file(_numpy(vae_state_dict_from_flax(vae_p)), os.path.join(dirs["vae"], "diffusion_pytorch_model.safetensors"))
    text_sd = _numpy(clip_text_state_dict_from_flax(text_p))
    text_sd["text_model.embeddings.position_ids"] = np.arange(77, dtype=np.int64)[None]  # as older exports carry
    save_file(text_sd, os.path.join(dirs["text_encoder"], "model.safetensors"))
    configs = {
        "unet": {"_class_name": "UNet2DConditionModel", "sample_size": s, "in_channels": 4, "out_channels": 4,
                 "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"],
                 "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D"],
                 "block_out_channels": list(UNET_CFG.block_out_channels), "layers_per_block": 1,
                 "attention_head_dim": list(UNET_CFG.num_attention_heads), "use_linear_projection": True,
                 "cross_attention_dim": UNET_CFG.cross_attention_dim, "norm_num_groups": UNET_CFG.norm_num_groups,
                 "flip_sin_to_cos": True, "freq_shift": 0},
        "vae": {"_class_name": "AutoencoderKL", "block_out_channels": list(VAE_CFG.block_out_channels),
                "layers_per_block": 1, "norm_num_groups": VAE_CFG.norm_num_groups, "latent_channels": 4,
                "scaling_factor": 0.18215},
        "text_encoder": {"architectures": ["CLIPTextModel"], "vocab_size": TEXT_CFG.vocab_size,
                         "hidden_size": TEXT_CFG.hidden_size, "intermediate_size": TEXT_CFG.intermediate_size,
                         "num_hidden_layers": TEXT_CFG.num_hidden_layers,
                         "num_attention_heads": TEXT_CFG.num_attention_heads, "max_position_embeddings": 77,
                         "hidden_act": "gelu", "eos_token_id": 2, "bos_token_id": 0},
    }
    for name, cfg in configs.items():
        with open(os.path.join(dirs[name], "config.json"), "w") as f:
            json.dump(cfg, f)
    write_byte_level_tokenizer(dirs["tokenizer"])
    with open(os.path.join(dirs["scheduler"], "scheduler_config.json"), "w") as f:
        json.dump({"_class_name": "DDIMScheduler", "prediction_type": "v_prediction",
                   "beta_schedule": "scaled_linear", "beta_start": 0.00085, "beta_end": 0.012,
                   "steps_offset": 1, "set_alpha_to_one": False, "clip_sample": False}, f)


@pytest.fixture(scope="module")
def sd2_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sd2"))
    _write_sd2_dir(root)
    return root


def test_config_readers_match_jax(sd2_dir):
    root = sd2_dir
    for sub, port_fn, jax_fn in (
            ("unet", loader.unet_config_from_diffusers, jloader.unet_config_from_diffusers),
            ("vae", loader.vae_config_from_diffusers, jloader.vae_config_from_diffusers),
            ("text_encoder", loader.clip_text_config_from_transformers, jloader.clip_text_config_from_transformers)):
        cfg = loader._read_config(os.path.join(root, sub))
        assert cfg == jloader._read_config(os.path.join(root, sub))
        assert dataclasses.asdict(port_fn(cfg)) == dataclasses.asdict(jax_fn(cfg)), sub
    unet_cfg = loader.unet_config_from_diffusers(loader._read_config(os.path.join(root, "unet")))
    assert unet_cfg.num_attention_heads == (2, 2) and unet_cfg.use_linear_projection
    # SD 2.1's published config: the legacy list is the head count, 64 channels a head
    sd21 = loader.unet_config_from_diffusers({"down_block_types": ["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"],
                                              "block_out_channels": [320, 640, 1280, 1280],
                                              "attention_head_dim": [5, 10, 20, 20], "sample_size": 96,
                                              "cross_attention_dim": 1024, "use_linear_projection": True})
    assert dataclasses.asdict(sd21) == dataclasses.asdict(jcfg.SD21_UNET)
    assert [c // h for c, h in zip(sd21.block_out_channels, sd21.num_attention_heads)] == [64] * 4


@pytest.mark.parametrize("force_upcast,want", [(True, torch.float32), (False, torch.bfloat16)])
def test_vae_decode_dtype_follows_force_upcast(force_upcast, want):
    cfg = loader.vae_config_from_diffusers({"block_out_channels": [16, 32], "force_upcast": force_upcast})
    assert loader.vae_decode_dtype(cfg) == want
    assert (jloader.vae_decode_dtype(jloader.vae_config_from_diffusers(
        {"block_out_channels": [16, 32], "force_upcast": force_upcast})) == jnp.float32) == (want == torch.float32)


def test_modules_load_the_jax_loaders_weights(sd2_dir):
    """Every module's state_dict is the JAX loader's tree, leaf for leaf:
    the UNet and the text encoder through the port's flax converters (the
    text encoder's position_ids buffer aside), the
    VAE through the JAX converter with its extra sampler level dropped (the
    seam of test_vae_state_dict_round_trip)."""
    root = sd2_dir
    pipe = loader.load_interpolation_pipeline(root, device="cpu", dtype=torch.float32)
    jpipe = jloader.load_interpolation_pipeline(root, dtype=jnp.float32)
    for port_module, jax_params, to_sd in ((pipe.unet, jpipe.unet_params, unet_state_dict_from_flax),
                                           (pipe.text_encoder, jpipe.text_params, clip_text_state_dict_from_flax)):
        want = to_sd(jax.tree_util.tree_map(np.asarray, jax_params))
        # the JAX tree keeps transformers' position_ids buffer as an unread
        # leaf; the port's loader drops it
        want.pop("position_ids", None)
        got = port_module.state_dict()
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
    back = convert_vae_state_dict(pipe.vae.state_dict())
    want = jax.tree_util.tree_map(np.asarray, jpipe.vae_params)
    for tree in (back, want):
        for part in ("encoder", "decoder"):
            for name, node in tree["params"][part].items():
                if name.endswith(("_upsamplers_0", "_downsamplers_0")) and "conv" in node:
                    tree["params"][part][name] = node["conv"]
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[path]), leaf, err_msg=jax.tree_util.keystr(path))


def test_loader_defaults_and_device(sd2_dir):
    """The JAX loader's defaults: UNet bf16, text encoder f32, VAE f32 (its
    config leaves force_upcast on), guidance 7.5, DDIM; scheduler and
    guidance as the app passes them; every module on the device asked for;
    the tokenizer pads with the directory's "!"."""
    from aid_tpu_torch.schedulers import DDIMScheduler, UniPCScheduler

    root = sd2_dir
    pipe = loader.load_interpolation_pipeline(root, device="cpu")
    assert {p.dtype for p in pipe.unet.parameters()} == {torch.bfloat16}
    assert {p.dtype for p in pipe.text_encoder.parameters()} == {torch.float32}
    assert {p.dtype for p in pipe.vae.parameters()} == {torch.float32}
    assert isinstance(pipe.scheduler, DDIMScheduler) and pipe.guidance_scale == 7.5
    assert pipe.scheduler.config.prediction_type == "v_prediction" and pipe.scheduler.config.steps_offset == 1
    assert pipe.tokenizer.pad_id == 0
    for m in (pipe.unet, pipe.vae, pipe.text_encoder):
        assert {p.device.type for p in m.parameters()} == {"cpu"}
    app = loader.load_interpolation_pipeline(root, scheduler_name="unipc", guidance_scale=10.0, device="cpu")
    assert isinstance(app.scheduler, UniPCScheduler) and app.guidance_scale == 10.0
    assert app.scheduler.config.prediction_type == "v_prediction"


def test_loader_defaults_to_the_card():
    """With no device argument the loader targets "cuda" (no silent move to
    the CPU): on a machine without one, building a module there fails."""
    import inspect

    for fn in (loader.load_interpolation_pipeline, loader.load_interpolation_xl_pipeline, loader.load_unet,
               loader.load_vae, loader.load_text_encoder, loader.load_safety_checker):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__


@pytest.mark.parametrize("name", ["unipc", "pndm", "ddim"])
def test_loaded_pipeline_latents_match_jax(sd2_dir, name):
    """``interpolate(output_type="latent")`` of both loaded pipelines from
    the same latents, v-prediction, guidance 10 (the app's SD 2.1 call)."""
    root = sd2_dir
    pipe = loader.load_interpolation_pipeline(root, scheduler_name=name, dtype=torch.float32, guidance_scale=10.0,
                                              device="cpu")
    jpipe = jloader.load_interpolation_pipeline(root, scheduler_name=name, dtype=jnp.float32, guidance_scale=10.0)
    s = UNET_CFG.sample_size
    a, b = th.normal(41, (1, s, s, 4)), th.normal(42, (1, s, s, 4))
    kw = dict(size=3, num_inference_steps=3, output_type="latent")
    got = pipe.interpolate(th.nhwc_to_nchw(a), th.nhwc_to_nchw(b), "a red cat", "a blue dog", **kw)
    want = jpipe.interpolate(jnp.asarray(a), jnp.asarray(b), "a red cat", "a blue dog", **kw)
    assert torch.isfinite(got).all()
    assert th.max_rel_err(th.nchw_to_nhwc(got), np.asarray(want)) < LATENT_TOL


def test_chunked_multistep_state_carries_over(sd2_dir):
    """UniPC's and PNDM's history goes through denoise_steps chunks and
    step callbacks: chunked and per-step runs equal the one-go run."""
    root = sd2_dir
    s = UNET_CFG.sample_size
    a, b = th.nhwc_to_nchw(th.normal(43, (1, s, s, 4))), th.nhwc_to_nchw(th.normal(44, (1, s, s, 4)))
    for name in ("unipc", "pndm"):
        pipe = loader.load_interpolation_pipeline(root, scheduler_name=name, dtype=torch.float32, device="cpu")
        kw = dict(size=3, num_inference_steps=4, output_type="latent")
        whole = pipe.interpolate(a, b, "x", "y", **kw)
        pipe.denoise_chunk_size = 2
        chunked = pipe.interpolate(a, b, "x", "y", **kw)
        pipe.denoise_chunk_size = None
        seen = []
        stepped = pipe.interpolate(a, b, "x", "y", callback_on_step_end=lambda p, i, t, d: seen.append(i), **kw)
        torch.testing.assert_close(chunked, whole, rtol=0, atol=0)
        torch.testing.assert_close(stepped, whole, rtol=0, atol=0)
        assert seen == list(range(5 if name == "pndm" else 4))


def test_scheduler_dispatch_matches_jax(tmp_path):
    """load_scheduler's auto table and the per-class parameters it reads:
    EDM sigmas, Euler's Karras flag, PNDM's skip_prk_steps."""
    sched_dir = tmp_path / "scheduler"
    sched_dir.mkdir()
    cases = [
        ({"_class_name": "PNDMScheduler", "skip_prk_steps": True}, "PNDMScheduler"),
        ({"_class_name": "UniPCMultistepScheduler"}, "UniPCScheduler"),
        ({"_class_name": "DPMSolverMultistepScheduler"}, "UniPCScheduler"),
        ({"_class_name": "EulerDiscreteScheduler", "use_karras_sigmas": True, "timestep_spacing": "trailing"},
         "EulerDiscreteScheduler"),
        ({"_class_name": "EDMDPMSolverMultistepScheduler", "sigma_min": 0.01, "sigma_max": 50.0,
          "sigma_data": 0.5, "prediction_type": "v_prediction"}, "EDMDPMSolverScheduler"),
        ({"_class_name": "SomethingElse"}, "DDIMScheduler"),
    ]
    for cfg, cls in cases:
        (sched_dir / "scheduler_config.json").write_text(json.dumps(cfg))
        got, want = loader.load_scheduler(str(tmp_path)), jloader.load_scheduler(str(tmp_path))
        assert type(got).__name__ == type(want).__name__ == cls
        fields = {f.name for f in dataclasses.fields(got)} - {"config"}
        for f in fields:
            assert getattr(got, f) == getattr(want, f), (cls, f)
        if hasattr(got, "config"):
            assert dataclasses.asdict(got.config) == dataclasses.asdict(want.config)
    assert type(loader.load_scheduler(str(tmp_path), "euler")).__name__ == "EulerDiscreteScheduler"


def _write_safety_checker(root, seed=9):
    """A tiny diffusers ``safety_checker/`` (CLIPConfig with a nested
    vision_config, diffusers names, the position_ids buffer transformers
    exports carry) under ``root``; returns the weights written."""
    from aid_tpu_torch.models.configs import TINY_CLIP_VISION as V
    from aid_tpu_torch.models.safety import SafetyChecker

    sub = os.path.join(root, "safety_checker")
    os.makedirs(sub)
    sd = th.numpy_state_dict(th.seed_module(SafetyChecker(V), seed))
    tokens = (V.image_size // V.patch_size) ** 2 + 1
    save_file({**sd, "vision_model.vision_model.embeddings.position_ids": np.arange(tokens, dtype=np.int64)[None]},
              os.path.join(sub, "model.safetensors"))
    with open(os.path.join(sub, "config.json"), "w") as f:
        json.dump({"_class_name": "StableDiffusionSafetyChecker", "projection_dim": V.projection_dim,
                   "vision_config": {"hidden_size": V.hidden_size, "intermediate_size": V.intermediate_size,
                                     "num_hidden_layers": V.num_hidden_layers,
                                     "num_attention_heads": V.num_attention_heads, "patch_size": V.patch_size,
                                     "image_size": V.image_size, "hidden_act": V.hidden_act}}, f)
    return sd


def test_safety_checker_directory_raises(sd2_dir, tmp_path):
    """A directory with a ``safety_checker/`` loads it (config read as the
    JAX loader reads it, weights bit for bit, f32 on the device asked for)
    and the pipeline's decode runs it: thresholds rigged to -10 black out
    every frame, rigged to +10 leave the frames of the pipeline without a
    checker. A checker directory without weights raises."""
    import shutil

    from aid_tpu.models.safety import convert_safety_checker_state_dict
    from aid_tpu_torch.models.safety import SafetyChecker

    root = str(tmp_path / "sd2")
    shutil.copytree(sd2_dir, root)
    written = _write_safety_checker(root)
    pipe = loader.load_interpolation_pipeline(root, dtype=torch.float32, device="cpu")
    checker = pipe.safety_checker
    assert isinstance(checker, SafetyChecker)
    sub = os.path.join(root, "safety_checker")
    want_cfg = jloader.clip_vision_config_from_transformers(jloader._read_config(sub))
    assert dataclasses.asdict(checker.config) == dataclasses.asdict(want_cfg)
    assert {(p.device.type, p.dtype) for p in checker.parameters()} == {("cpu", torch.float32)}
    got = checker.state_dict()
    assert got.keys() == written.keys()
    for k, v in written.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    _, jparams = jloader.load_safety_checker(sub)
    # the JAX tree keeps the position_ids buffer as an unread leaf; the port's loader drops it
    flat_want = [(path, leaf) for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]
                 if "position_ids" not in jax.tree_util.keystr(path)]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(convert_safety_checker_state_dict(got))[0])
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[path]), np.asarray(leaf))

    s = UNET_CFG.sample_size
    a, b = th.nhwc_to_nchw(th.normal(45, (1, s, s, 4))), th.nhwc_to_nchw(th.normal(46, (1, s, s, 4)))
    kw = dict(size=3, num_inference_steps=2)
    plain = dataclasses.replace(pipe, safety_checker=None).interpolate(a, b, "a red cat", "a blue dog", **kw)
    assert plain.shape == (3, 2 * s, 2 * s, 3) and plain.max() > 0
    for thresh, black in ((-10.0, True), (10.0, False)):
        with torch.no_grad():
            checker.concept_embeds_weights.fill_(thresh)
            checker.special_care_embeds_weights.fill_(thresh)
        out = pipe.interpolate(a, b, "a red cat", "a blue dog", **kw)
        if black:
            assert (out == 0).all()
        else:
            np.testing.assert_array_equal(out, plain)

    os.remove(os.path.join(sub, "model.safetensors"))
    with pytest.raises(FileNotFoundError, match="no safety-checker weights"):
        loader.load_interpolation_pipeline(root, device="cpu")


def test_sdxl_directory_goes_to_the_xl_loader(tmp_path, monkeypatch):
    (tmp_path / "text_encoder_2").mkdir()
    seen = {}

    def fake_xl(repo_path, scheduler_name="auto", dtype=None, guidance_scale=None, device="cuda"):
        seen.update(path=repo_path, sched=scheduler_name, device=device)
        return "xl"

    monkeypatch.setattr(loader, "load_interpolation_xl_pipeline", fake_xl)
    assert loader.load_interpolation_pipeline(str(tmp_path), device="cpu") == "xl"
    assert seen == {"path": str(tmp_path), "sched": "auto", "device": "cpu"}


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_safetensors_reader_bit_exact(tmp_path, dtype):
    """The port's reader against safetensors.numpy: the same bits, shapes
    and dtypes, metadata skipped; a directory reads every file in sorted
    order, a later file's key replacing an earlier one's."""
    r = np.random.default_rng(0)
    first = {"a": r.standard_normal((3, 5)).astype(dtype), "b": r.standard_normal((7,)).astype(dtype),
             "empty": np.zeros((0, 4), dtype), "ids": np.arange(9, dtype=np.int64).reshape(1, 9)}
    second = {"b": r.standard_normal((2, 2)).astype(dtype)}
    save_file(first, str(tmp_path / "model.safetensors"), metadata={"format": "pt"})
    save_file(second, str(tmp_path / "model.fp16.safetensors"))
    from safetensors.numpy import load_file

    got = load_safetensors(str(tmp_path / "model.safetensors"))
    want = load_file(str(tmp_path / "model.safetensors"))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].numpy().dtype == v.dtype and np.array_equal(got[k].numpy(), v), k
    merged = load_safetensors(str(tmp_path))
    want_merged = jloader.load_safetensors(str(tmp_path))
    assert merged.keys() == want_merged.keys()
    for k, v in want_merged.items():
        assert np.array_equal(merged[k].numpy(), v), k
    # "model.fp16.safetensors" sorts before "model.safetensors": the latter's "b" wins
    assert merged["b"].shape == (7,)
    cast = load_safetensors(str(tmp_path / "model.safetensors"), dtype=torch.bfloat16)
    assert cast["a"].dtype == torch.bfloat16 and cast["ids"].dtype == torch.int64
    assert torch.equal(cast["a"], torch.from_numpy(first["a"]).to(torch.bfloat16))


def test_safetensors_bf16_and_writer_round_trip(tmp_path):
    """BF16 (which numpy cannot hold) against safetensors.torch, and the
    port's writer read back by safetensors' own reader."""
    from safetensors.torch import load_file, save_file as torch_save

    g = torch.Generator().manual_seed(0)
    tensors = {"w": torch.randn(4, 6, generator=g).bfloat16(), "h": torch.randn(3, generator=g).half(),
               "f": torch.randn(2, 3, generator=g), "z": torch.zeros(0)}
    torch_save(tensors, str(tmp_path / "a.safetensors"))
    got = load_safetensors(str(tmp_path / "a.safetensors"))
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    save_safetensors(tensors, str(tmp_path / "b.safetensors"))
    back = load_file(str(tmp_path / "b.safetensors"))
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def test_safetensors_reader_imports_no_safetensors():
    import ast
    from pathlib import Path

    from aid_tpu_torch.utils import safetensors as reader

    tree = ast.parse(Path(reader.__file__).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert not [m for m in names if m.split(".")[0] == "safetensors"]


# A tiny SD 1.x-like UNet whose heads are wider than the D <= 160 kernels:
# widths (192, 384) with the legacy list attention_head_dim [1, 2], which
# both loaders read as head counts, so every attention (both levels and the
# mid block) runs at D = 192; on the card the D=512 instances take it.
WIDE_HEAD_UNET_CFG = dataclasses.replace(jcfg.TINY_UNET, block_out_channels=(192, 384), num_attention_heads=(1, 2),
                                         cross_attention_levels=(True, True))
# f32 forwards on both sides from the same weights, as test_torch_models.py's FWD_TOL
WIDE_HEAD_FWD_TOL = 1e-4


def test_wide_heads_load_and_run_as_jax(tmp_path):
    """A diffusers UNet directory with a list ``attention_head_dim`` whose
    heads come out 192 wide: both loaders read the same UNetConfig (head
    counts (1, 2)) and the same weights bit for bit, and the loaded UNets'
    fused_outer and pure_inner forwards agree (f32, the port's plain
    versions on the CPU)."""
    cfg = WIDE_HEAD_UNET_CFG
    _, params = th.jax_unet_and_params(cfg, seed=8)
    path = tmp_path / "unet"
    path.mkdir()
    save_file(_numpy(unet_state_dict_from_flax(params)), str(path / "diffusion_pytorch_model.safetensors"))
    with open(path / "config.json", "w") as f:
        json.dump({"_class_name": "UNet2DConditionModel", "sample_size": cfg.sample_size,
                   "down_block_types": ["CrossAttnDownBlock2D"] * 2, "up_block_types": ["CrossAttnUpBlock2D"] * 2,
                   "block_out_channels": list(cfg.block_out_channels), "layers_per_block": cfg.layers_per_block,
                   "attention_head_dim": [1, 2], "cross_attention_dim": cfg.cross_attention_dim,
                   "norm_num_groups": cfg.norm_num_groups}, f)
    raw = loader._read_config(str(path))
    port_cfg = loader.unet_config_from_diffusers(raw)
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jloader.unet_config_from_diffusers(raw))
    assert port_cfg.num_attention_heads == (1, 2)
    assert [c // h for c, h in zip(port_cfg.block_out_channels, port_cfg.num_attention_heads)] == [192, 192]
    unet = loader.load_unet(str(path), dtype=torch.float32, device="cpu")
    jax_model, jax_params = jloader.load_unet(str(path), dtype=jnp.float32)
    want_sd = unet_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jax_params))
    got_sd = unet.state_dict()
    assert got_sd.keys() == want_sd.keys()
    for k in want_sd:
        assert torch.equal(got_sd[k], want_sd[k]), k

    from aid_tpu.models.layers import AidContext as JaxAidContext
    from aid_tpu.models.layers import AidMode as JaxAidMode
    from aid_tpu_torch.models.layers import AidContext, AidMode

    B, s = 3, cfg.sample_size
    x, ehs = th.normal(81, (B, s, s, cfg.in_channels)), th.normal(82, (B, 77, cfg.cross_attention_dim))
    coef = np.array([0.0, 0.4, 1.0], np.float32)
    for mode in ("fused_outer", "pure_inner"):
        want = jax.jit(lambda p, x, e, c: jax_model.apply(
            p, x, jnp.array(321.0), e, JaxAidContext(coef=c, mode=JaxAidMode.from_name(mode)), None))(
            jax_params, jnp.asarray(x), jnp.asarray(ehs), jnp.asarray(coef))
        with torch.no_grad():
            got = unet(th.nhwc_to_nchw(x), torch.tensor(321.0), torch.from_numpy(ehs),
                       AidContext(coef=torch.from_numpy(coef), mode=AidMode.from_name(mode)))
        assert th.max_rel_err(th.nchw_to_nhwc(got), np.asarray(want)) < WIDE_HEAD_FWD_TOL, mode
