"""The port's LoRA merge and textual-inversion loading against aid_tpu's.

LoRA: the JAX package's ``merge_lora`` on its tiny UNet tree and the port's
on the same weights (``th.port_unet``), from one LoRA state dict made with
numpy: PEFT, ``lora.down/up``, kohya (underscore stems, which the port
resolves on its module tree and the JAX package on its flax tree), alpha,
a 4-D conv LoRA and 2-D factors on a 1x1 conv. The merged weights must be
bit-equal, in f32 and in bf16 (the update computed in f32, cast to the
weight's dtype, added in it), and a UNet forward of the merged models
agree at FWD_TOL. Textual inversion: the four layouts and a
``.safetensors`` path, against the JAX loader: the placeholder's ids, the
grown table bit for bit, and the encoded prompt at CLIP_TOL; the pipeline
method likewise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

import torch_helpers as th
from aid_tpu.models import configs as jcfg
from aid_tpu.models import params as jparams
from aid_tpu.models.clip import CLIPTextModel as JaxCLIP
from aid_tpu.models.layers import AidContext as JaxAidContext
from aid_tpu.models.layers import AidMode as JaxAidMode
from aid_tpu.utils import tokenizer as jtok
from aid_tpu_torch.models import configs, params
from aid_tpu_torch.models.clip import CLIPTextModel
from aid_tpu_torch.models.layers import AidContext, AidMode
from aid_tpu_torch.models.unet import UNet2DCondition
from aid_tpu_torch.utils import tokenizer as tok

# The UNet forward, f32 on both sides from bit-equal weights: the
# frameworks' ~1e-6 of max |ref| (tests/test_torch_models.py); a LoRA on the
# wrong module or transposed moves it by >= 1e-3.
FWD_TOL = 1e-4
# The text encoder (tests/test_torch_clip.py).
CLIP_TOL = 1e-5

CFG = configs.TINY_UNET
ATTN = "down_blocks.0.attentions.0.transformer_blocks.0"


@pytest.fixture(scope="module")
def unets():
    jax_model, p = th.jax_unet_and_params(CFG, seed=5)
    return jax_model, p, th.port_unet(CFG, p)


def _factors(seed, out_dim, in_dim, r=4, kernel=()):
    g = th.rng(seed)
    A = (g.standard_normal((r, in_dim, *kernel)) * 0.3).astype(np.float32)
    B = (g.standard_normal((out_dim, r, *(1 for _ in kernel))) * 0.3).astype(np.float32)
    return A, B


def _lora(case, unet):
    """(LoRA state dict, the merged weights' names) of one case."""
    w = {n: p.shape for n, p in unet.named_parameters()}
    sd, names = {}, []

    def pair(key_a, key_b, module, seed, kernel=()):
        shape = w[f"{module}.weight"]
        A, B = _factors(seed, shape[0], shape[1], kernel=kernel)
        sd[key_a], sd[key_b] = A, B
        names.append(f"{module}.weight")

    if case in ("peft", "peft_alpha"):
        for i, proj in enumerate(("attn1.to_q", "attn2.to_out.0", "ff.net.0.proj")):
            m = f"{ATTN}.{proj}"
            pair(f"unet.{m}.lora_A.weight", f"unet.{m}.lora_B.weight", m, 10 + i)
            if case == "peft_alpha":
                sd[f"unet.{m}.alpha"] = np.float32(8.0 + i)
    elif case == "lora_dot":
        m = f"{ATTN}.attn2.to_k"
        pair(f"base_model.model.{m}.lora.down.weight", f"base_model.model.{m}.lora.up.weight", m, 20)
    elif case == "kohya":
        for i, proj in enumerate(("attn1.to_v", "attn1.to_out.0", "ff.net.2")):
            m = f"{ATTN}.{proj}"
            stem = "lora_unet_" + m.replace(".", "_")
            pair(f"{stem}.lora_down.weight", f"{stem}.lora_up.weight", m, 30 + i)
            sd[f"{stem}.alpha"] = np.float32(2.0)
        # text-encoder LoRA keys are skipped, not an error
        sd["lora_te_text_model_encoder_layers_0_self_attn_q_proj.lora_down.weight"] = np.ones((4, 8), np.float32)
        sd["lora_te_text_model_encoder_layers_0_self_attn_q_proj.lora_up.weight"] = np.ones((8, 4), np.float32)
        sd["text_encoder.text_model.x.lora_A.weight"] = np.ones((4, 8), np.float32)
    elif case == "conv4d":
        m = "down_blocks.0.resnets.0.conv1"
        pair(f"lora_unet_{m.replace('.', '_')}.lora_down.weight", f"lora_unet_{m.replace('.', '_')}.lora_up.weight",
             m, 40, kernel=(3, 3))
        sd[f"lora_unet_{m.replace('.', '_')}.alpha"] = np.float32(3.0)
    elif case == "conv1x1":  # 2-D factors on a 1x1 conv (proj_in without linear projection)
        m = "down_blocks.0.attentions.0.proj_in"
        pair(f"unet.{m}.lora_A.weight", f"unet.{m}.lora_B.weight", m, 50)
    return sd, names


def _jax_merged_state_dict(tree):
    return params.unet_state_dict_from_flax(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree))


CASES = ["peft", "peft_alpha", "lora_dot", "kohya", "conv4d", "conv1x1"]


@pytest.mark.parametrize("case", CASES)
def test_merge_lora_matches_jax(unets, case):
    """f32: every weight of the merged UNet bit-equal to the JAX merge's,
    the targets changed, the rest the caller's tensors (shared) and the
    caller's UNet unchanged; a fused_outer forward of both merged models at
    FWD_TOL."""
    jax_model, p, unet = unets
    lora, names = _lora(case, unet)
    before = {k: v.clone() for k, v in unet.state_dict().items()}
    merged = params.merge_lora(unet, lora, scale=0.7)
    jmerged = jparams.merge_lora(p, lora, scale=0.7)
    got, want, base = merged.state_dict(), _jax_merged_state_dict(jmerged), unet.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(base[k], before[k]), k
        if k in names:
            assert not torch.equal(got[k], before[k]), k
        else:
            assert got[k].data_ptr() == base[k].data_ptr(), k
    assert type(merged) is UNet2DCondition and merged.config == unet.config and not merged.training

    B, s = 3, CFG.sample_size
    x, ehs = th.normal(1, (B, s, s, 4)), th.normal(2, (B, 77, CFG.cross_attention_dim))
    coef = np.array([0.0, 0.4, 1.0], np.float32)
    jout = jax_model.apply(th.to_jnp(jmerged), jnp.asarray(x), jnp.array(321.0), jnp.asarray(ehs),
                           JaxAidContext(coef=jnp.asarray(coef), mode=JaxAidMode.from_name("fused_outer")))
    with torch.no_grad():
        out = merged(th.nhwc_to_nchw(x), torch.tensor(321.0), torch.from_numpy(ehs),
                     AidContext(coef=torch.from_numpy(coef), mode=AidMode.from_name("fused_outer")))
        plain = unet(th.nhwc_to_nchw(x), torch.tensor(321.0), torch.from_numpy(ehs),
                     AidContext(coef=torch.from_numpy(coef), mode=AidMode.from_name("fused_outer")))
    assert th.max_rel_err(th.nchw_to_nhwc(out), np.asarray(jout)) < FWD_TOL
    assert th.max_rel_err(out.numpy(), plain.numpy()) > 1e-3  # the LoRA moved the output


@pytest.mark.parametrize("case", ["peft_alpha", "kohya", "conv4d"])
def test_merge_lora_bf16_bits_match_jax(unets, case):
    """bf16 weights on both sides: the f32 update cast to bf16 and added in
    bf16 gives the JAX merge's bits exactly (adding in f32 and casting
    after would not, in general)."""
    _, p, unet32 = unets
    unet = UNet2DCondition(CFG, dtype=torch.bfloat16)
    unet.load_state_dict({k: v.to(torch.bfloat16) for k, v in unet32.state_dict().items()}, strict=True)
    lora, names = _lora(case, unet)
    merged = params.merge_lora(unet, lora, scale=0.7)
    assert merged.dtype == torch.bfloat16 and {t.dtype for t in merged.state_dict().values()} == {torch.bfloat16}
    jp = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32).astype(ml_dtypes.bfloat16), p)
    want = _jax_merged_state_dict(jparams.merge_lora(jp, lora, scale=0.7))
    got = merged.state_dict()
    for k in want:
        assert torch.equal(got[k].float(), want[k]), k  # bf16 -> f32 is exact: equal f32 is equal bits
    other = {}
    for k in names:  # the update added in f32 and cast after rounds differently somewhere
        delta = torch.from_numpy(params.lora_deltas(unet, lora, 0.7)[k])
        other[k] = (unet.state_dict()[k].float() + delta).to(torch.bfloat16)
    assert any(not torch.equal(other[k], got[k]) for k in names)


def test_merge_lora_errors(unets):
    _, _, unet = unets
    with pytest.raises(KeyError, match="not found"):
        params.merge_lora(unet, {"unet.down_blocks.0.nothing.lora_A.weight": np.ones((2, 4), np.float32),
                                 "unet.down_blocks.0.nothing.lora_B.weight": np.ones((4, 2), np.float32)})
    with pytest.raises(KeyError, match="not found"):
        params.merge_lora(unet, {"lora_unet_down_blocks_0_nope.lora_down.weight": np.ones((2, 4), np.float32),
                                 "lora_unet_down_blocks_0_nope.lora_up.weight": np.ones((4, 2), np.float32)})
    # a lone factor merges nothing, and the result still holds only shared tensors
    lone = params.merge_lora(unet, {f"unet.{ATTN}.attn1.to_q.lora_A.weight": np.ones((2, 32), np.float32)})
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(lone.state_dict().values(), unet.state_dict().values()))
    assert params._resolve_underscore_path("down_blocks_0_attentions_0_transformer_blocks_0_attn1_to_out_0",
                                           unet) == f"{ATTN}.attn1.to_out.0"


# ---------------------------------------------------------------------------
# textual inversion
# ---------------------------------------------------------------------------

TEXT = configs.TINY_CLIP_TEXT  # vocab 1000 holds the byte-level tokenizer's 514 ids


@pytest.fixture(scope="module")
def text_models(tmp_path_factory):
    vocab = tmp_path_factory.mktemp("vocab")
    tok.write_byte_level_tokenizer(str(vocab))
    jtext = JaxCLIP(TEXT)
    jp = jax.tree_util.tree_map(np.asarray, jtext.init(jax.random.PRNGKey(8), jnp.zeros((1, 77), jnp.int32)))
    return str(vocab), jp


def _layouts(tmp_path, vectors):
    """(name, checkpoint, token, placeholder the loaders should register)."""
    single = str(tmp_path / "my-style.safetensors")
    save_file({"emb_params_any": vectors}, single)
    return [
        ("diffusers", {"<cat-toy>": vectors}, None, "<cat-toy>"),
        ("a1111", {"string_to_param": {"*": torch.from_numpy(vectors)}, "name": "<a1111>",
                   "string_to_token": {"*": 265}}, None, "<a1111>"),
        ("civitai", {"emb_params": vectors}, "easynegative", "easynegative"),
        ("single_file", single, None, "my-style"),
        ("token_override", {"<x>": vectors, "<y>": vectors[:1]}, "<y>", "<y>"),
    ]


@pytest.mark.parametrize("layout", range(5), ids=["diffusers", "a1111", "civitai", "single_file", "token_override"])
def test_textual_inversion_matches_jax(tmp_path, text_models, layout):
    """Each layout into the port's text encoder and tokenizer and into the
    JAX package's: the same placeholder and ids, the table grown bit for
    bit, the config's vocab_size with it, and the encoded prompt at
    CLIP_TOL; without the placeholder the encoding is as before."""
    vocab, jp = text_models
    vectors = (th.rng(60).standard_normal((2, TEXT.hidden_size)) * 0.5).astype(np.float32)
    name, ckpt, token, placeholder = _layouts(tmp_path, vectors)[layout]
    text = CLIPTextModel(TEXT)
    text.load_state_dict(params.clip_text_state_dict_from_flax(jp), strict=True)
    ours, theirs = tok.load_tokenizer(vocab), jtok.load_tokenizer(vocab)
    plain_ids = ours("a photo of a dog")
    with torch.no_grad():
        plain = text(torch.as_tensor(plain_ids))[0]
    n = params.load_textual_inversion(text, ours, ckpt, token)
    jnew, jn = jparams.load_textual_inversion(jp, theirs, ckpt, token)
    assert n == jn == (1 if name == "token_override" else 2)
    assert ours.added_tokens == theirs.added_tokens == {placeholder.lower(): list(range(1000, 1000 + n))}
    prompt = f"a photo of {placeholder} on a table"
    ids = ours(prompt)
    np.testing.assert_array_equal(ids, theirs(prompt))
    assert 1000 in ids
    assert text.config.vocab_size == 1000 + n and text.text_model.embeddings.token_embedding.num_embeddings == 1000 + n
    table = text.text_model.embeddings.token_embedding.weight
    np.testing.assert_array_equal(table.detach().numpy(), jnew["params"]["token_embedding"]["embedding"])
    jmodel = JaxCLIP(jcfg.CLIPTextConfig(**{**dataclasses.asdict(TEXT), "vocab_size": 1000 + n}))
    want = jmodel.apply(th.to_jnp(jnew), jnp.asarray(ids))[0]
    with torch.no_grad():
        got = text(torch.as_tensor(ids))[0]
        again = text(torch.as_tensor(plain_ids))[0]
    assert th.max_rel_err(got.numpy(), np.asarray(want)) < CLIP_TOL
    torch.testing.assert_close(again, plain, rtol=0, atol=0)


def test_pipeline_textual_inversion_matches_jax(tmp_path, text_models):
    """``InterpolationPipeline.load_textual_inversion`` (a .safetensors path
    named by its file) against the JAX pipeline's: encode_prompt of a
    prompt with the placeholder at CLIP_TOL; the table grew on its device,
    in its dtype."""
    from aid_tpu.pipelines import InterpolationPipeline as JaxPipeline
    from aid_tpu_torch.pipelines.interpolation import InterpolationPipeline

    vocab, jp = text_models
    path = str(tmp_path / "sks.safetensors")
    save_file({"sks": (th.rng(61).standard_normal((3, TEXT.hidden_size)) * 0.5).astype(np.float32)}, path)
    text = CLIPTextModel(TEXT)
    text.load_state_dict(params.clip_text_state_dict_from_flax(jp), strict=True)
    pipe = InterpolationPipeline(unet=UNet2DCondition(CFG), vae=None, text_encoder=text,
                                 tokenizer=tok.load_tokenizer(vocab))
    jpipe = JaxPipeline(unet=None, unet_params=None, vae=None, vae_params=None, text_encoder=JaxCLIP(TEXT),
                        text_params=th.to_jnp(jp), tokenizer=jtok.load_tokenizer(vocab))
    assert pipe.load_textual_inversion(path) is pipe
    jpipe.load_textual_inversion(path)
    table = pipe.text_encoder.text_model.embeddings.token_embedding.weight
    assert table.shape == (1003, TEXT.hidden_size) and table.dtype == torch.float32 and not table.requires_grad
    got, _ = pipe.encode_prompt("a painting in sks style")
    want, _ = jpipe.encode_prompt("a painting in sks style")
    assert th.max_rel_err(got.numpy(), np.asarray(want)) < CLIP_TOL
