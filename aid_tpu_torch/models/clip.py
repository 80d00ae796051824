"""CLIP text encoder as a PyTorch module (transformers parameter names).

Counterpart of ``aid_tpu.models.clip.CLIPTextModel``. Parameter names are
those of transformers' ``CLIPTextModel`` / ``CLIPTextModelWithProjection``
(``text_model.embeddings.token_embedding``, ``text_model.encoder.layers.N.
self_attn.q_proj``, ``mlp.fc1``, ``text_model.final_layer_norm``,
``text_projection``), so one class serves CLIP ViT-L (SD1.x, SDXL encoder 1)
and OpenCLIP bigG with its 1280-wide projection (SDXL encoder 2). Its
attention is plain PyTorch over at most 77 tokens, as the JAX package
computes it with plain einsums (no kernel).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from aid_tpu_torch.models.configs import CLIPTextConfig


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="none")
    raise ValueError(f"unknown hidden_act {name!r}")


class CLIPAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, dim, **kw)
        self.k_proj = nn.Linear(dim, dim, **kw)
        self.v_proj = nn.Linear(dim, dim, **kw)
        self.out_proj = nn.Linear(dim, dim, **kw)

    def forward(self, x, causal_mask: torch.Tensor):
        B, S, C = x.shape
        hd = C // self.num_heads

        def heads(t):
            return t.view(B, S, self.num_heads, hd).transpose(1, 2)

        q, k, v = heads(self.q_proj(x)), heads(self.k_proj(x)), heads(self.v_proj(x))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5
        logits = logits.masked_fill(~causal_mask, torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(B, S, C)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, dim: int, hidden: int, act: str, *, device=None, dtype=torch.float32):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, device=device, dtype=dtype)
        self.fc2 = nn.Linear(hidden, dim, device=device, dtype=dtype)
        self.act = _act(act)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=1e-5, **kw)
        self.self_attn = CLIPAttention(cfg.hidden_size, cfg.num_attention_heads, **kw)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=1e-5, **kw)
        self.mlp = CLIPMLP(cfg.hidden_size, cfg.intermediate_size, cfg.hidden_act, **kw)

    def forward(self, x, causal_mask):
        x = x + self.self_attn(self.layer_norm1(x), causal_mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, **kw):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size, **kw)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, **kw):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg, **kw) for _ in range(cfg.num_hidden_layers)])


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, **kw):
        super().__init__()
        self.embeddings = _Embeddings(cfg, **kw)
        self.encoder = _Encoder(cfg, **kw)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5, **kw)


class CLIPTextModel(nn.Module):
    """``forward(input_ids, clip_skip)`` returns (last hidden state after
    ``clip_skip``, pooled, all hidden states), as the JAX model does.

    ``clip_skip = n > 0`` takes the hidden states n layers before the end and
    applies ``final_layer_norm`` to them (clip.py:97-106). Pooled is the
    final-layer-normed LAST hidden state at the EOS position, projected by
    ``text_projection`` when the config has one (clip.py:107-116): with
    ``eos_token_id == 2`` (legacy configs) the EOS position is argmax(ids),
    otherwise the first occurrence of ``eos_token_id``, and argmax(ids) for
    rows that have none. ``hidden_states`` has the embeddings and the output
    of every layer (num_hidden_layers + 1 entries).
    """

    def __init__(self, config: CLIPTextConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype)
        self.text_model = _TextTransformer(config, **kw)
        if config.projection_dim is not None:
            self.text_projection = nn.Linear(config.hidden_size, config.projection_dim, bias=False, **kw)

    def forward(self, input_ids: torch.Tensor, clip_skip: int = 0):
        cfg, tm = self.config, self.text_model
        B, S = input_ids.shape
        ids = input_ids.long()
        pos = torch.arange(S, device=ids.device)
        x = tm.embeddings.token_embedding(ids) + tm.embeddings.position_embedding(pos)[None]
        causal = torch.ones(S, S, dtype=torch.bool, device=ids.device).tril()[None, None]
        hidden_states = [x]
        for layer in tm.encoder.layers:
            x = layer(x, causal)
            hidden_states.append(x)

        final_ln = tm.final_layer_norm
        out = final_ln(hidden_states[-1 - clip_skip] if clip_skip > 0 else x)
        final_normed = final_ln(x) if clip_skip > 0 else out
        if cfg.eos_token_id == 2:
            eos_idx = ids.argmax(dim=-1)
        else:
            is_eos = ids == cfg.eos_token_id
            eos_idx = torch.where(is_eos.any(dim=-1), is_eos.int().argmax(dim=-1), ids.argmax(dim=-1))
        pooled = final_normed[torch.arange(B, device=ids.device), eos_idx]
        if cfg.projection_dim is not None:
            pooled = self.text_projection(pooled)
        return out, pooled, hidden_states
