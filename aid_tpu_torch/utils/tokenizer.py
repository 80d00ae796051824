"""Tokenizers. A pipeline tokenizer is any callable ``str -> (1, L) int ids``.

Copied from ``aid_tpu.utils.tokenizer`` (pure Python and numpy; the ids are
numpy int32 arrays, which the pipelines move to the text encoders' device).
``CLIPBPETokenizer`` loads a standard CLIP vocab.json + merges.txt, the
files shipped with every SD checkpoint, with no network access.
``HashTokenizer`` is a deterministic offline stand-in for tests and
random-weight runs.
"""

from __future__ import annotations

import html
import json
import os
from typing import List

import numpy as np


class HashTokenizer:
    """Deterministic word-hash tokenizer (test/bench use only)."""

    def __init__(self, vocab_size: int = 1000, max_length: int = 77):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.bos_id = 1
        self.eos_id = 2

    def __call__(self, text: str) -> np.ndarray:
        import hashlib

        words = text.lower().split()
        ids = [self.bos_id]
        for w in words[: self.max_length - 2]:
            # deterministic across processes (builtin hash() is salted)
            h = int.from_bytes(hashlib.md5(w.encode()).digest()[:4], "little")
            ids.append(3 + h % (self.vocab_size - 3))
        ids.append(self.eos_id)
        ids += [self.eos_id] * (self.max_length - len(ids))
        return np.asarray([ids], np.int32)


def _bytes_to_unicode():
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class CLIPBPETokenizer:
    """CLIP byte-pair tokenizer from local vocab.json + merges.txt.

    ``pad_token``: token used to fill positions after EOS. Defaults to EOS
    (SD 1.x/2.x CLIP tokenizers); SDXL's ``tokenizer_2`` (OpenCLIP-bigG)
    pads with ``"!"`` (id 0) instead — the pad ids feed the causal encoder
    and the per-position embeddings DO enter cross-attention, so this is a
    real numerics difference for short prompts (reference encodes via the
    HF tokenizers' own pad config, pipeline_interpolated_sdxl.py:644-730).
    """

    def __init__(self, vocab_path: str, merges_path: str, max_length: int = 77,
                 pad_token: str | None = None):
        with open(vocab_path) as f:
            self.encoder = json.load(f)
        #: placeholder tokens added by textual inversion: str -> [ids]
        self.added_tokens = {}
        with open(merges_path, encoding="utf-8") as f:
            merges = f.read().split("\n")
        # first line is a version header in HF-format merges.txt
        merges = [m for m in merges[1:] if m and len(m.split()) == 2]
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.max_length = max_length
        self.bos_id = self.encoder["<|startoftext|>"]
        self.eos_id = self.encoder["<|endoftext|>"]
        if pad_token is None:
            self.pad_id = self.eos_id
        else:
            # HF stores word-final tokens with the </w> suffix ("!" -> "!</w>")
            self.pad_id = self.encoder.get(pad_token, self.encoder.get(pad_token + "</w>"))
            if self.pad_id is None:
                raise ValueError(f"pad token {pad_token!r} not in vocab")
        self.cache = {}

    def _bpe(self, token: str) -> List[str]:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        self.cache[token] = list(word)
        return list(word)

    def add_tokens(self, token: str, ids) -> None:
        """Register a textual-inversion placeholder mapping to id(s)."""
        self.added_tokens[token.lower()] = list(ids)

    def __call__(self, text: str) -> np.ndarray:
        import re

        text = html.unescape(html.unescape(text)).strip().lower()
        if self.added_tokens:
            # split out placeholder tokens before BPE
            pattern = "(" + "|".join(re.escape(t) for t in self.added_tokens) + ")"
            segments = [seg for seg in re.split(pattern, text) if seg]
        else:
            segments = [text]
        # CLIP tokenization regex with Python-re unicode classes: [^\W\d_]+
        # == \p{L}+ (letters incl. accents/CJK), \d == \p{N}, and
        # (?:[^\s\w]|_)+ == [^\s\p{L}\p{N}]+ (symbol runs incl. underscore).
        # The regex runs on RAW text before byte-encoding, so an ASCII-only
        # form would mis-split non-ASCII prompts ('café' -> 'caf'+'é').
        pat = re.compile(r"'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|(?:[^\s\w]|_)+")
        ids = [self.bos_id]
        for seg in segments:
            if seg in self.added_tokens:
                ids.extend(self.added_tokens[seg])
                continue
            for tok in re.findall(pat, seg):
                tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
                for sub in self._bpe(tok):
                    if sub in self.encoder:
                        ids.append(self.encoder[sub])
        ids = ids[: self.max_length - 1]
        ids.append(self.eos_id)
        ids += [self.pad_id] * (self.max_length - len(ids))
        return np.asarray([ids], np.int32)


def _read_pad_token(path: str) -> str | None:
    """Pad token from the checkpoint's tokenizer_config.json /
    special_tokens_map.json (SDXL tokenizer_2 pads with "!", id 0 — not
    EOS like SD's tokenizer). Returns None (-> EOS pad) when unspecified."""
    for fname in ("tokenizer_config.json", "special_tokens_map.json"):
        fpath = os.path.join(path, fname)
        if not os.path.exists(fpath):
            continue
        with open(fpath) as f:
            cfg = json.load(f)
        tok = cfg.get("pad_token")
        if isinstance(tok, dict):
            tok = tok.get("content")
        if tok is not None:
            return tok
    return None


def load_tokenizer(path: str, max_length: int = 77,
                   pad_token: str | None = None):
    """Load a CLIP tokenizer from a checkpoint ``tokenizer/`` directory,
    honoring its configured pad token. ``pad_token`` overrides the
    directory's config — used when an SD tokenizer directory stands in
    for SDXL's ``tokenizer_2`` (whose pad is "!", id 0, not EOS)."""
    return CLIPBPETokenizer(
        os.path.join(path, "vocab.json"), os.path.join(path, "merges.txt"),
        max_length,
        pad_token=pad_token if pad_token is not None else _read_pad_token(path),
    )
