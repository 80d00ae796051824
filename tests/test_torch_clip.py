"""The port's CLIP text encoder and tokenizers against aid_tpu's.

TINY_CLIP_TEXT (and a projected bigG-like variant), f32 on the CPU, the
same perturbed flax init on both sides through
``clip_text_state_dict_from_flax``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_helpers as th
from aid_tpu.models.clip import CLIPTextModel as JaxCLIP
from aid_tpu.models.params import convert_clip_text_state_dict
from aid_tpu.utils import tokenizer as jax_tok
from aid_tpu_torch.models import configs
from aid_tpu_torch.models.clip import CLIPTextModel
from aid_tpu_torch.models.params import clip_text_state_dict_from_flax
from aid_tpu_torch.utils import tokenizer as tok

# f32 on both sides over 2 layers of 77 tokens: summation order only
# (~1e-7 of the output scale); 1e-5 of max |ref| still catches a wrong
# activation (quick_gelu vs gelu is ~1e-2), mask, epsilon or pooling row.
CLIP_TOL = 1e-5


def _cfg(act: str, eos: int, proj: bool):
    return dataclasses.replace(configs.TINY_CLIP_TEXT, hidden_act=act, eos_token_id=eos,
                               projection_dim=24 if proj else None)


def _models(cfg, seed=0):
    from aid_tpu.models import configs as jax_configs

    jcfg = jax_configs.CLIPTextConfig(**dataclasses.asdict(cfg))
    jmodel = JaxCLIP(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 77), jnp.int32))
    noise = th.rng(seed + 100)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + (noise.standard_normal(a.shape) * 0.05).astype(np.float32), params)
    model = CLIPTextModel(cfg)
    model.load_state_dict(clip_text_state_dict_from_flax(params), strict=True)
    return jmodel, params, model.eval()


def _ids(cfg, seed, eos_in_row=True):
    """Two rows of ids with an EOS id in row 0 (and in row 1 when asked),
    ids above EOS in row 0 (the textual-inversion case)."""
    r = th.rng(seed)
    ids = r.integers(3, cfg.vocab_size, size=(2, 77)).astype(np.int32)
    ids[:, 0] = 1
    if cfg.eos_token_id < cfg.vocab_size:
        ids[0, 9] = cfg.eos_token_id
        ids[0, 20:] = cfg.eos_token_id
        if eos_in_row:
            ids[1, 30] = cfg.eos_token_id
    return ids


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
@pytest.mark.parametrize("eos", [2, 500])
@pytest.mark.parametrize("proj", [False, True], ids=["noproj", "proj"])
@pytest.mark.parametrize("clip_skip", [0, 1])
def test_clip_text_matches_jax(act, eos, proj, clip_skip):
    cfg = _cfg(act, eos, proj)
    jmodel, params, model = _models(cfg)
    ids = _ids(cfg, 1, eos_in_row=(clip_skip == 0))
    want_out, want_pooled, want_hs = jmodel.apply(th.to_jnp(params), jnp.asarray(ids), clip_skip=clip_skip)
    with torch.no_grad():
        out, pooled, hs = model(torch.from_numpy(ids), clip_skip=clip_skip)
    assert len(hs) == len(want_hs) == cfg.num_hidden_layers + 1
    assert th.max_rel_err(out.numpy(), np.asarray(want_out)) < CLIP_TOL
    assert th.max_rel_err(pooled.numpy(), np.asarray(want_pooled)) < CLIP_TOL
    for got_h, want_h in zip(hs, want_hs):
        assert th.max_rel_err(got_h.numpy(), np.asarray(want_h)) < CLIP_TOL
    assert pooled.shape == (2, 24 if proj else cfg.hidden_size)


def test_clip_state_dict_round_trip():
    """convert_clip_text_state_dict(port.state_dict()) is the JAX tree, leaf for leaf."""
    _, params, model = _models(_cfg("gelu", 500, True))
    back = convert_clip_text_state_dict(model.state_dict())
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf, err_msg=jax.tree_util.keystr(path))


def test_clip_configs_match_jax_presets():
    from aid_tpu.models import configs as jax_configs

    for name in ("CLIP_VIT_L_TEXT", "SDXL_TEXT_ENCODER_2", "TINY_CLIP_TEXT", "SDXL_VAE", "TINY_VAE"):
        assert getattr(configs, name).__dict__ == getattr(jax_configs, name).__dict__, name


@pytest.mark.parametrize("text", ["a cat", "A Photo of  a DOG, 4k!", "", "café naïve 東京"])
def test_hash_tokenizer_equal(text):
    np.testing.assert_array_equal(tok.HashTokenizer(1000)(text), jax_tok.HashTokenizer(1000)(text))


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    """A tiny CLIP vocabulary written here: bytes, a few merges, the specials."""
    d = tmp_path_factory.mktemp("tok")
    byte_chars = list(tok._bytes_to_unicode().values())
    vocab = byte_chars + [c + "</w>" for c in byte_chars]
    merges = ["c a", "ca t</w>", "d o", "do g</w>", "p h", "o t", "ph ot", "phot o</w>"]
    for m in merges:
        vocab.append(m.replace(" ", ""))
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    (d / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(vocab)}))
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n")
    (d / "tokenizer_config.json").write_text(json.dumps({"pad_token": "!"}))
    return d


@pytest.mark.parametrize("text", ["a cat", "a photo of a dog", "Cat's dog_2 café &amp; 東京", "x" * 200])
@pytest.mark.parametrize("pad", [None, "!"])
def test_bpe_tokenizer_equal(vocab_dir, text, pad):
    ours = tok.CLIPBPETokenizer(str(vocab_dir / "vocab.json"), str(vocab_dir / "merges.txt"), pad_token=pad)
    theirs = jax_tok.CLIPBPETokenizer(str(vocab_dir / "vocab.json"), str(vocab_dir / "merges.txt"), pad_token=pad)
    got, want = ours(text), theirs(text)
    assert got.dtype == np.int32 and got.shape == (1, 77)
    np.testing.assert_array_equal(got, want)


def test_load_tokenizer_reads_pad_token(vocab_dir):
    ours, theirs = tok.load_tokenizer(str(vocab_dir)), jax_tok.load_tokenizer(str(vocab_dir))
    assert ours.pad_id == theirs.pad_id != ours.eos_id
    np.testing.assert_array_equal(ours("a cat"), theirs("a cat"))
