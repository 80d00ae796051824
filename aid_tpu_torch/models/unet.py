"""UNet2DCondition (SD1.x / SD2.x / SDXL) as a PyTorch module, NCHW, config-driven.

Counterpart of ``aid_tpu.models.unet.UNet2DCondition`` with diffusers
parameter names (``down_blocks.1.attentions.0...``, ``mid_block.resnets.0``,
``time_embedding.linear_1``, ``add_embedding.linear_1``, ...). Supports the
SD1.x/2.x four-level layout and SDXL's three levels with per-level
transformer depth and ``text_time`` added conditioning (pooled text embeds +
micro-conditioning time_ids). Not yet ported: IP-Adapter K/V projections and
FreeU.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from aid_tpu_torch.models.configs import UNetConfig
from aid_tpu_torch.models.layers import (
    AidContext,
    Downsample2D,
    ResnetBlock2D,
    TimestepEmbedding,
    Transformer2D,
    Upsample2D,
    timestep_embedding,
)


class _Block(nn.Module):
    """A down/mid/up block: diffusers' ``resnets`` / ``attentions`` /
    ``downsamplers`` / ``upsamplers`` containers (run by the UNet)."""

    def __init__(self):
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList()


class UNet2DCondition(nn.Module):
    def __init__(self, config: UNetConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        cfg = config
        if cfg.ip_num_tokens:
            raise NotImplementedError("IP-Adapter projections are not yet ported")
        self.config = cfg
        self.dtype = dtype
        kw = dict(device=device, dtype=dtype)
        boc = cfg.block_out_channels
        temb = cfg.time_embed_dim
        groups = cfg.norm_num_groups

        self.time_embedding = TimestepEmbedding(boc[0], temb, **kw)
        if cfg.addition_embed_type == "text_time":
            self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim, temb, **kw)
        elif cfg.addition_embed_type is not None:
            raise NotImplementedError(f"addition_embed_type {cfg.addition_embed_type!r}")
        self.conv_in = nn.Conv2d(cfg.in_channels, boc[0], 3, padding=1, **kw)

        def transformer(level: int, channels: int) -> Transformer2D:
            heads = cfg.num_attention_heads[level]
            return Transformer2D(
                channels, heads, channels // heads, max(cfg.transformer_layers_per_block[level], 1),
                cfg.cross_attention_dim, groups, cfg.use_linear_projection, **kw)

        # down path; skip_ch tracks the channels of every skip connection
        ch = boc[0]
        skip_ch = [ch]
        self.down_blocks = nn.ModuleList()
        for level, out_ch in enumerate(boc):
            blk = _Block()
            for _ in range(cfg.layers_per_block):
                blk.resnets.append(ResnetBlock2D(ch, out_ch, temb, groups, **kw))
                ch = out_ch
                if cfg.cross_attention_levels[level]:
                    blk.attentions.append(transformer(level, out_ch))
                skip_ch.append(ch)
            if level != cfg.num_levels - 1:
                blk.downsamplers = nn.ModuleList([Downsample2D(out_ch, **kw)])
                skip_ch.append(out_ch)
            self.down_blocks.append(blk)

        # mid block (resnet -> [attn -> resnet]); attention-free configs skip the attn
        mid_ch = boc[-1]
        self.mid_block = _Block()
        self.mid_block.resnets.append(ResnetBlock2D(mid_ch, mid_ch, temb, groups, **kw))
        if any(cfg.cross_attention_levels):
            top = cfg.num_levels - 1
            mid_level = top if cfg.cross_attention_levels[top] else next(
                i for i in reversed(range(cfg.num_levels)) if cfg.cross_attention_levels[i])
            self.mid_block.attentions.append(transformer(mid_level, mid_ch))
        self.mid_block.resnets.append(ResnetBlock2D(mid_ch, mid_ch, temb, groups, **kw))

        # up path: reversed levels, layers_per_block+1 resnets over the skip concat
        self.up_blocks = nn.ModuleList()
        ch = mid_ch
        for up_idx, level in enumerate(reversed(range(cfg.num_levels))):
            out_ch = boc[level]
            blk = _Block()
            for _ in range(cfg.layers_per_block + 1):
                blk.resnets.append(ResnetBlock2D(ch + skip_ch.pop(), out_ch, temb, groups, **kw))
                ch = out_ch
                if cfg.cross_attention_levels[level]:
                    blk.attentions.append(transformer(level, out_ch))
            if up_idx != cfg.num_levels - 1:
                blk.upsamplers = nn.ModuleList([Upsample2D(out_ch, **kw)])
            self.up_blocks.append(blk)

        self.conv_norm_out = nn.GroupNorm(groups, boc[0], eps=1e-5, **kw)
        self.conv_out = nn.Conv2d(boc[0], cfg.out_channels, 3, padding=1, **kw)

    def forward(
        self,
        sample: torch.Tensor,  # (B, C, H, W) noisy latents
        timestep: torch.Tensor,  # scalar or (B,)
        encoder_hidden_states: torch.Tensor,  # (B, S, cross_attention_dim)
        aid: Optional[AidContext] = None,
        added_cond: Optional[dict] = None,  # SDXL: {"text_embeds": (B, P), "time_ids": (B, 6)}
    ) -> torch.Tensor:
        cfg = self.config
        B = sample.shape[0]
        timestep = torch.as_tensor(timestep, device=sample.device)
        if timestep.dim() == 0:
            timestep = timestep.expand(B)

        # 1. time (+ SDXL additional conditioning) embedding
        t_emb = timestep_embedding(timestep, cfg.block_out_channels[0],
                                   flip_sin_to_cos=cfg.flip_sin_to_cos, freq_shift=cfg.freq_shift)
        emb = self.time_embedding(t_emb.to(self.dtype))
        if cfg.addition_embed_type == "text_time":
            if added_cond is None:
                raise ValueError("SDXL config requires added_cond (text_embeds, time_ids)")
            time_embeds = timestep_embedding(
                added_cond["time_ids"].reshape(-1), cfg.addition_time_embed_dim,
                flip_sin_to_cos=cfg.flip_sin_to_cos, freq_shift=cfg.freq_shift).reshape(B, -1)
            add_embeds = torch.cat([added_cond["text_embeds"].float(), time_embeds], dim=-1)
            emb = emb + self.add_embedding(add_embeds.to(self.dtype))

        # 2. conv_in
        h = self.conv_in(sample.to(self.dtype))
        ehs = encoder_hidden_states.to(self.dtype)

        # 3. down path
        skips = [h]
        for blk in self.down_blocks:
            for j, resnet in enumerate(blk.resnets):
                h = resnet(h, emb)
                if len(blk.attentions):
                    h = blk.attentions[j](h, ehs, aid)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                skips.append(h)

        # 4. mid block
        h = self.mid_block.resnets[0](h, emb)
        for attn in self.mid_block.attentions:
            h = attn(h, ehs, aid)
        h = self.mid_block.resnets[1](h, emb)

        # 5. up path with skip concat
        for blk in self.up_blocks:
            for j, resnet in enumerate(blk.resnets):
                h = resnet(torch.cat([h, skips.pop()], dim=1), emb)
                if len(blk.attentions):
                    h = blk.attentions[j](h, ehs, aid)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)

        # 6. out
        h = F.silu(self.conv_norm_out(h))
        return self.conv_out(h)
