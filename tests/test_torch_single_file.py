"""The port's single-file (original LDM) checkpoint loading against aid_tpu's.

LDM-layout state dicts are built from the JAX package's tiny trees (its
init plus seeded noise) by the inverse maps of tests/test_single_file.py,
which are written from the LDM layout and not from either package's map.
The port's converters must give, bit for bit, both the JAX converters'
diffusers / transformers dicts on the same input and the port's
``*_state_dict_from_flax`` of the trees the file was made from: UNet (SD
1.x, 2.x, XL), VAE, CLIP and the OpenCLIP tower with its last resblock
dropped. Then both ``load_single_file_pipeline``s read one tiny file
(``.safetensors``, and a ``.ckpt`` carrying ``global_step``), with each
package's full-size presets patched to the tiny configs in the test only,
and ``interpolate_single(output_type="latent")`` must agree at SLICE_TOL.
The latents, not the images: the JAX converter keeps the VAE's
``upsamplers.0.conv`` level, which its own decoder cannot apply (ROADMAP
Queue 3), so the VAE dicts are held to each other separately. f32 on the
CPU.
"""

import dataclasses
import functools
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

import torch_helpers as th
from aid_tpu.models import configs as jcfg
from aid_tpu.models import loader as jloader
from aid_tpu.models import params as jparams
from aid_tpu.models.clip import CLIPTextModel as JaxCLIP
from aid_tpu.models.vae import AutoencoderKL as JaxVAE
from aid_tpu_torch.models import configs, loader, params
from aid_tpu_torch.utils.tokenizer import write_byte_level_tokenizer
from test_single_file import _openclip_inverse, _unet_diffusers_to_ldm, _vae_diffusers_to_ldm

# f32 over 2 DDIM / UniPC steps x 2 UNet passes, both loaders on one file:
# the per-forward ~1e-6 relative difference (test_torch_models.py) grows
# through the text encoder and the guidance; 1e-4 of max |ref| holds that,
# while a wrong weight, activation, pad id or prediction type moves the
# latents by >= 1e-2 (tests/test_torch_loader.py).
SLICE_TOL = 1e-4

# Tiny configs with the full-size presets' LDM numbering: both loaders call
# the converters with their defaults, 2 resnets a level and 4 VAE levels.
VAE4 = configs.VAEConfig(block_out_channels=(16, 16, 32, 32), layers_per_block=1, norm_num_groups=4)
SD1_UNET = dataclasses.replace(configs.TINY_UNET, layers_per_block=2, cross_attention_dim=64)
SD2_UNET = dataclasses.replace(configs.TINY_UNET, layers_per_block=2, cross_attention_dim=1024,
                               use_linear_projection=True)
XL_UNET = dataclasses.replace(configs.TINY_SDXL_UNET, layers_per_block=2, cross_attention_dim=128,
                              projection_class_embeddings_input_dim=16 * 6 + 64)
# text towers as the loaders infer them: 64 channels a head, a 4x MLP, the
# byte-level tokenizer's 514 ids inside the vocabulary
SD1_TEXT = configs.CLIPTextConfig(vocab_size=520, hidden_size=64, intermediate_size=256, num_hidden_layers=2,
                                  num_attention_heads=1)
SD2_TEXT = dataclasses.replace(SD1_TEXT, hidden_size=1024, intermediate_size=4096, num_attention_heads=16,
                               hidden_act="gelu")
XL_TEXT_2 = dataclasses.replace(SD1_TEXT, hidden_act="gelu", projection_dim=64)


def _jax_cfg(cfg):
    """The JAX package's namesake of a port config dataclass."""
    return getattr(jcfg, type(cfg).__name__)(**dataclasses.asdict(cfg))


def _perturbed(params_tree, seed):
    noise = th.rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + (noise.standard_normal(a.shape) * 0.05).astype(np.float32),
        params_tree)


def _trees(unet_cfg, text_cfgs, seed=0):
    """JAX params (numpy leaves) of a UNet, VAE4 and the text towers."""
    _, unet = th.jax_unet_and_params(_jax_cfg(unet_cfg), seed=seed)
    vae = _perturbed(JaxVAE(_jax_cfg(VAE4)).init(jax.random.PRNGKey(seed + 1), jnp.zeros((1, 64, 64, 3))), seed + 2)
    texts = [_perturbed(JaxCLIP(_jax_cfg(c)).init(jax.random.PRNGKey(seed + 3 + i), jnp.zeros((1, 77), jnp.int32)),
                        seed + 10 + i) for i, c in enumerate(text_cfgs)]
    return unet, vae, texts


def _numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _ldm_unet(sd, cfg):
    out = {}
    for k, v in sd.items():
        if k.startswith("add_embedding.linear_"):
            n, rest = k[len("add_embedding.linear_"):].split(".", 1)
            nk = f"label_emb.0.{2 * (int(n) - 1)}.{rest}"
        else:
            nk = _unet_diffusers_to_ldm(k, cfg)
        out["model.diffusion_model." + nk] = v
    return out


def _ldm_vae(sd):
    out = {}
    for k, v in sd.items():
        nk, attn = _vae_diffusers_to_ldm(k, len(VAE4.block_out_channels))
        out["first_stage_model." + nk] = v.reshape(*v.shape, 1, 1) if attn and v.ndim == 2 else v
    return out


def _open_clip(sd, extra_layer_seed=None):
    """transformers names -> OpenCLIP (tests/test_single_file.py's inverse);
    with ``extra_layer_seed`` one more resblock, a text_projection and a
    logit_scale, as SD 2.x files carry."""
    def short(k):  # the JAX test's names: no text_model. / embeddings. / encoder. levels
        for pre in ("text_model.", "embeddings.", "encoder."):
            k = k[len(pre):] if k.startswith(pre) else k
        return k

    oc = _openclip_inverse({short(k): v for k, v in sd.items()})
    if extra_layer_seed is not None:
        r = th.rng(extra_layer_seed)
        n = 1 + max(int(k.split(".")[2]) for k in oc if k.startswith("transformer.resblocks."))
        for k in [k for k in oc if k.startswith("transformer.resblocks.0.")]:
            oc[k.replace(".0.", f".{n}.", 1)] = r.standard_normal(oc[k].shape).astype(np.float32)
        width = oc["ln_final.weight"].shape[0]
        oc["text_projection"] = r.standard_normal((width, width)).astype(np.float32)
        oc["logit_scale"] = np.float32(4.6)
    return oc


@functools.lru_cache(maxsize=None)
def _sd_file(unet_cfg, text_cfg, seed=0):
    """(LDM dict, (unet, vae, text) trees) of an SD 1.x (CLIP in
    transformers naming, with its position_ids buffer) or SD 2.x (OpenCLIP
    tower with an extra last resblock) single file."""
    unet, vae, (text,) = _trees(unet_cfg, [text_cfg], seed)
    ldm = {**_ldm_unet(_numpy(params.unet_state_dict_from_flax(unet)), unet_cfg),
           **_ldm_vae(_numpy(params.vae_state_dict_from_flax(vae))), "model_ema.decay": np.float32(0.999)}
    text_sd = _numpy(params.clip_text_state_dict_from_flax(text))
    if unet_cfg.cross_attention_dim == 1024:
        ldm.update({"cond_stage_model.model." + k: v for k, v in _open_clip(text_sd, seed + 50).items()})
    else:
        ldm.update({"cond_stage_model.transformer." + k: v for k, v in text_sd.items()})
        ldm["cond_stage_model.transformer.text_model.embeddings.position_ids"] = np.arange(77, dtype=np.int64)[None]
    return ldm, (unet, vae, text)


@functools.lru_cache(maxsize=None)
def _xl_file(seed=0):
    unet, vae, (text, text2) = _trees(XL_UNET, [SD1_TEXT, XL_TEXT_2], seed)
    ldm = {**_ldm_unet(_numpy(params.unet_state_dict_from_flax(unet)), XL_UNET),
           **_ldm_vae(_numpy(params.vae_state_dict_from_flax(vae)))}
    ldm.update({"conditioner.embedders.0.transformer." + k: v
                for k, v in _numpy(params.clip_text_state_dict_from_flax(text)).items()})
    ldm.update({"conditioner.embedders.1.model." + k: v
                for k, v in _open_clip(_numpy(params.clip_text_state_dict_from_flax(text2))).items()})
    ldm["conditioner.embedders.1.model.logit_scale"] = np.float32(4.6)
    return ldm, (unet, vae, text, text2)


def _bit_equal(got, want, skip=()):
    """got (torch) and want (torch or numpy) dicts: the same keys and every
    value bit for bit."""
    want = {k: v for k, v in want.items() if k not in skip}
    assert set(got) - set(skip) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("preset", ["SD15_UNET", "SD21_UNET", "SDXL_UNET"])
def test_ldm_key_maps_match_jax(preset):
    """The port's copies of the LDM key maps against the JAX package's on
    every key of the full-size UNet and VAE (built on the meta device,
    mapped to LDM names by the inverse map): the same diffusers key."""
    from aid_tpu_torch.models.unet import UNet2DCondition
    from aid_tpu_torch.models.vae import AutoencoderKL

    cfg = getattr(configs, preset)
    with torch.device("meta"):
        unet_keys = list(UNet2DCondition(cfg).state_dict())
        vae_keys = list(AutoencoderKL(configs.SDXL_VAE if preset == "SDXL_UNET" else configs.SD_VAE).state_dict())
    for k in unet_keys:
        ldm = _ldm_unet({k: np.zeros(1)}, cfg).popitem()[0][len("model.diffusion_model."):]
        assert params._ldm_unet_key(ldm, cfg.layers_per_block) == jparams._ldm_unet_key(ldm, cfg.layers_per_block) == k
    for k in vae_keys:
        ldm = _vae_diffusers_to_ldm(k, 4)[0]
        assert params._ldm_vae_key(ldm, 4) == jparams._ldm_vae_key(ldm, 4) == k
    assert params._ldm_unet_key("unknown.0.weight") is None and params._ldm_vae_key("loss.logvar") is None


@pytest.mark.parametrize("unet_cfg,text_cfg,wrap", [(SD1_UNET, SD1_TEXT, False), (SD2_UNET, SD2_TEXT, True)],
                         ids=["sd1", "sd2_wrapped"])
def test_convert_ldm_checkpoint_matches_jax(unet_cfg, text_cfg, wrap):
    """SD 1.x and SD 2.x files (model_ema skipped; the SD 2.x one wrapped in
    state_dict): UNet, VAE and text dicts bit-equal to the JAX converter's
    and to the port's flax converters of the source trees. SD 2.x's
    OpenCLIP tower comes back with its last resblock and text_projection
    dropped, the 2-layer model the file was made from."""
    ldm, (unet, vae, text) = _sd_file(unet_cfg, text_cfg)
    src = {"state_dict": ldm, "global_step": 875_000} if wrap else ldm
    got = params.convert_ldm_checkpoint(src)
    want = jparams.convert_ldm_checkpoint(src)
    for g, w in zip(got, want):
        _bit_equal(g, w)
    _bit_equal(got[0], params.unet_state_dict_from_flax(unet))
    _bit_equal(got[1], params.vae_state_dict_from_flax(vae))
    _bit_equal(got[2], params.clip_text_state_dict_from_flax(text),
               skip=() if unet_cfg is SD2_UNET else ("text_model.embeddings.position_ids",))
    if unet_cfg is SD1_UNET:
        assert "text_model.embeddings.position_ids" in got[2]  # passed through; the loader drops it
    else:
        assert "text_projection.weight" not in got[2]
        assert max(int(k.split(".")[3]) for k in got[2] if ".layers." in k) == text_cfg.num_hidden_layers - 1


def test_convert_ldm_checkpoint_xl_matches_jax():
    """The SDXL layout: UNet (label_emb -> add_embedding), VAE, CLIP-L and
    the bigG tower (packed in_proj split, text_projection transposed back,
    logit_scale dropped) bit-equal to the JAX converter's and to the source
    trees."""
    ldm, trees = _xl_file()
    got = params.convert_ldm_checkpoint_xl(ldm)
    want = jparams.convert_ldm_checkpoint_xl(ldm)
    for g, w in zip(got, want):
        _bit_equal(g, w)
    for g, tree, to_sd in zip(got, trees, (params.unet_state_dict_from_flax, params.vae_state_dict_from_flax,
                                           params.clip_text_state_dict_from_flax,
                                           params.clip_text_state_dict_from_flax)):
        _bit_equal(g, to_sd(tree))
    assert any(k.startswith("add_embedding.linear_2.") for k in got[0])
    # an exported nn.Linear projection is kept as it is
    ldm2 = {k.replace("model.text_projection", "model.text_projection.weight"): (v.T if k.endswith("text_projection")
                                                                               else v) for k, v in ldm.items()}
    np.testing.assert_array_equal(params.convert_ldm_checkpoint_xl(ldm2)[3]["text_projection.weight"].numpy(),
                                  got[3]["text_projection.weight"].numpy())


def test_converters_reject_the_wrong_layout():
    """A truncated OpenCLIP tower, an SDXL file to the SD converter and an
    SD file to the SDXL converter raise, as in the JAX package."""
    with pytest.raises(ValueError, match="truncated or"):
        params.convert_ldm_checkpoint({"model.diffusion_model.x": np.zeros(2),
                                       "cond_stage_model.model.token_embedding.weight": np.zeros((4, 8), np.float32)})
    with pytest.raises(ValueError, match="SDXL"):
        params.convert_ldm_checkpoint({"conditioner.embedders.0.transformer.x": np.zeros(2)})
    with pytest.raises(ValueError, match="conditioner"):
        params.convert_ldm_checkpoint_xl({"cond_stage_model.transformer.x": np.zeros(2)})
    unet_sd, _, _ = params.convert_ldm_checkpoint({"state_dict": {"model.diffusion_model.out.0.weight": np.ones(3)}})
    assert list(unet_sd) == ["conv_norm_out.weight"]


def test_prediction_type_rules_match_jax(tmp_path):
    """infer / resolve / apply against the JAX functions: the heuristic's
    four cases; an explicit value over a pinning sidecar; a pinning sidecar
    gives None silently; a sidecar without prediction_type leaves the
    heuristic; an SD 2.x file with no global_step warns and gives epsilon,
    an SD 1.x one stays silent; the pin on both scheduler layouts."""
    from aid_tpu.schedulers.edm_dpm import EDMDPMSolverScheduler as JaxEDM
    from aid_tpu_torch.schedulers import DDIMScheduler, EDMDPMSolverScheduler, UniPCScheduler

    for cross, step in ((1024, 875_000), (1024, 220_000), (1024, None), (768, 875_000)):
        assert (loader.infer_single_file_prediction_type(cross, step)
                == jloader.infer_single_file_prediction_type(cross, step))
    assert loader.infer_single_file_prediction_type(1024, 875_000) == "v_prediction"

    d, nosuch = str(tmp_path), str(tmp_path / "nosuch")
    sched = tmp_path / "scheduler"
    sched.mkdir()
    (sched / "scheduler_config.json").write_text(json.dumps({"prediction_type": "epsilon"}))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cases = [(d, "v_prediction", 1024, None), (d, None, 1024, None), (nosuch, None, 768, None),
                 (nosuch, None, 1024, 875_000)]
        for case in cases:
            assert loader.resolve_single_file_prediction_type(*case) == jloader.resolve_single_file_prediction_type(
                *case)
        assert loader.resolve_single_file_prediction_type(d, None, 1024, None) is None
    (sched / "scheduler_config.json").write_text(json.dumps({"_class_name": "DDIMScheduler"}))
    assert loader.resolve_single_file_prediction_type(d, None, 1024, 875_000) == "v_prediction"
    with pytest.warns(UserWarning, match="v-objective"):
        assert loader.resolve_single_file_prediction_type(nosuch, None, 1024, None) == "epsilon"

    for sch in (DDIMScheduler(), UniPCScheduler()):
        pinned = loader.apply_prediction_type(sch, "v_prediction")
        assert type(pinned) is type(sch) and pinned.config.prediction_type == "v_prediction"
        assert sch.config.prediction_type == "epsilon"  # a copy: the frozen original is unchanged
    edm = loader.apply_prediction_type(EDMDPMSolverScheduler(sigma_max=50.0), "v_prediction")
    assert edm.prediction_type == "v_prediction" and edm.sigma_max == 50.0
    assert jloader.apply_prediction_type(JaxEDM(), "v_prediction").prediction_type == edm.prediction_type


def _write(ldm, path, global_step=None):
    if path.endswith(".safetensors"):
        save_file({k: np.ascontiguousarray(v) for k, v in ldm.items()}, path)
    else:
        obj = {"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in ldm.items()}}
        if global_step is not None:
            obj["global_step"] = global_step
        torch.save(obj, path)


@pytest.fixture
def tiny_presets(monkeypatch):
    """Both packages' full-size presets, which their single-file loaders
    build from, patched to the tiny configs (in this test only)."""
    for pkg in (configs, jcfg):
        conv = (lambda c: c) if pkg is configs else _jax_cfg
        monkeypatch.setattr(pkg, "SD15_UNET", conv(SD1_UNET))
        monkeypatch.setattr(pkg, "SD21_UNET", conv(SD2_UNET))
        monkeypatch.setattr(pkg, "SDXL_UNET", conv(XL_UNET))
        monkeypatch.setattr(pkg, "SDXL_VAE", conv(dataclasses.replace(VAE4, scaling_factor=0.13025)))
    monkeypatch.setattr(configs, "SD_VAE", VAE4)
    real, tiny = jcfg.VAEConfig, _jax_cfg(VAE4)
    monkeypatch.setattr(jcfg, "VAEConfig", lambda *a, **kw: real(*a, **kw) if a or kw else tiny)


@pytest.mark.parametrize("layout,ext", [("sd1", "safetensors"), ("sd2", "ckpt"), ("xl", "safetensors")])
def test_single_file_pipeline_matches_jax(tmp_path, tiny_presets, layout, ext):
    """Both load_single_file_pipelines on one tiny file: the pipeline class,
    the prediction type (the SD 2.x .ckpt's global_step 875000 gives
    v-prediction), the pad ids (SD 2.x and SDXL's tokenizer_2 pad with "!"
    over the directory's EOS), the guidance default, every module on the
    CPU; then interpolate_single(0.4, output_type="latent") from the same
    latents at SLICE_TOL."""
    from aid_tpu_torch.pipelines.sdxl import InterpolationXLPipeline

    ldm = _xl_file()[0] if layout == "xl" else _sd_file(*((SD1_UNET, SD1_TEXT) if layout == "sd1"
                                                           else (SD2_UNET, SD2_TEXT)))[0]
    path = str(tmp_path / f"model.{ext}")
    _write(ldm, path, global_step=875_000)
    tok = str(tmp_path / "tokenizer")
    write_byte_level_tokenizer(tok)
    with open(os.path.join(tok, "tokenizer_config.json"), "w") as f:
        json.dump({}, f)  # an SD 1.x tokenizer directory: EOS padding
    pipe = loader.load_single_file_pipeline(path, tok, dtype=torch.float32, device="cpu")
    jpipe = jloader.load_single_file_pipeline(path, tok, dtype=jnp.float32)
    assert type(pipe).__name__ == type(jpipe).__name__
    assert pipe.scheduler.config.prediction_type == jpipe.scheduler.config.prediction_type == (
        "v_prediction" if layout == "sd2" else "epsilon")
    assert pipe.guidance_scale == jpipe.guidance_scale == (5.0 if layout == "xl" else 7.5)
    assert pipe.tokenizer.pad_id == jpipe.tokenizer.pad_id == (0 if layout == "sd2" else 513)
    modules = [pipe.unet, pipe.vae, pipe.text_encoder]
    if isinstance(pipe, InterpolationXLPipeline):
        assert pipe.tokenizer_2.pad_id == jpipe.tokenizer_2.pad_id == 0
        assert pipe.text_encoder_2.config.projection_dim == 64
        modules.append(pipe.text_encoder_2)
    assert {(p.device.type, p.dtype) for m in modules for p in m.parameters()} == {("cpu", torch.float32)}
    s = pipe.unet.config.sample_size
    a, b = th.normal(70, (1, s, s, 4)), th.normal(71, (1, s, s, 4))
    kw = dict(prompt_start="a red cat", prompt_end="a blue dog", num_inference_steps=2, output_type="latent")
    got = pipe.interpolate_single(0.4, th.nhwc_to_nchw(a), th.nhwc_to_nchw(b), **kw)
    want = jpipe.interpolate_single(0.4, jnp.asarray(a), jnp.asarray(b), **kw)
    assert torch.isfinite(got).all()
    assert th.max_rel_err(th.nchw_to_nhwc(got), np.asarray(want)) < SLICE_TOL


def test_single_file_formats_agree(tmp_path, tiny_presets):
    """One SD 2.x draw as .safetensors and as a .ckpt with global_step: with
    the prediction type the .ckpt's step implies, the two pipelines hold
    the same tensors and give the same latents; the bare .safetensors
    warns and falls back to epsilon; the UNet takes ``dtype`` and the
    default device is the card."""
    import inspect

    ldm = _sd_file(SD2_UNET, SD2_TEXT, seed=4)[0]
    st, ck = str(tmp_path / "a.safetensors"), str(tmp_path / "b.ckpt")
    _write(ldm, st)
    _write(ldm, ck, global_step=875_000)
    tok = str(tmp_path / "tokenizer")
    write_byte_level_tokenizer(tok)
    with pytest.warns(UserWarning, match="global_step"):
        bare = loader.load_single_file_pipeline(st, tok, device="cpu")
    assert bare.scheduler.config.prediction_type == "epsilon"
    assert {p.dtype for p in bare.unet.parameters()} == {torch.bfloat16}
    pipes = [loader.load_single_file_pipeline(st, tok, scheduler_name="unipc", dtype=torch.float32,
                                              prediction_type="v_prediction", device="cpu"),
             loader.load_single_file_pipeline(ck, tok, scheduler_name="unipc", dtype=torch.float32, device="cpu")]
    assert pipes[0].scheduler == pipes[1].scheduler
    for name in ("unet", "vae", "text_encoder"):
        sa, sb = (getattr(p, name).state_dict() for p in pipes)
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    a, b = th.nhwc_to_nchw(th.normal(72, (1, 8, 8, 4))), th.nhwc_to_nchw(th.normal(73, (1, 8, 8, 4)))
    kw = dict(prompt_start="a red cat", prompt_end="a blue dog", num_inference_steps=2, output_type="latent")
    torch.testing.assert_close(pipes[0].interpolate_single(0.5, a, b, **kw),
                               pipes[1].interpolate_single(0.5, a, b, **kw), rtol=0, atol=0)
    assert inspect.signature(loader.load_single_file_pipeline).parameters["device"].default == "cuda"
