"""AutoencoderKL, decode side, as PyTorch modules (NCHW, diffusers parameter names).

Counterpart of ``aid_tpu.models.vae`` (decoder, ``post_quant_conv`` and
``AutoencoderKL.decode``). Parameter names are diffusers' (``decoder.
mid_block.attentions.0.to_q``, ``decoder.up_blocks.0.upsamplers.0.conv``,
...), so the state dict is the decode-side subset of a diffusers
``AutoencoderKL`` checkpoint. The mid-block attention is one head over
every pixel with D = the channel count; it goes through
``dispatch_attention`` with a zero coefficient in self mode, as
vae.py:57-65 does, which on CUDA at D=512 f32 is the port's f32 flash
kernel. Every conv here is ``nn.Conv2d`` (cuDNN on the card), as the JAX
package leaves the VAE convs to XLA.

Not yet ported: the encoder and ``quant_conv`` (image-conditioned
workflows) and the spatially tiled decode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from aid_tpu_torch.models.configs import VAEConfig
from aid_tpu_torch.ops.attention import AttnMode, dispatch_attention


class VAEResnetBlock(nn.Module):
    """GN-SiLU-Conv x2 (GroupNorm eps 1e-6), with a 1x1 shortcut when the width changes."""

    def __init__(self, in_channels: int, out_channels: int, norm_num_groups: int, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = nn.GroupNorm(norm_num_groups, in_channels, eps=1e-6, **kw)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1, **kw)
        self.norm2 = nn.GroupNorm(norm_num_groups, out_channels, eps=1e-6, **kw)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1, **kw)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1, **kw)
                              if in_channels != out_channels else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    """Single-head spatial self-attention of the mid block."""

    def __init__(self, channels: int, norm_num_groups: int, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.group_norm = nn.GroupNorm(norm_num_groups, channels, eps=1e-6, **kw)
        self.to_q = nn.Linear(channels, channels, **kw)
        self.to_k = nn.Linear(channels, channels, **kw)
        self.to_v = nn.Linear(channels, channels, **kw)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels, **kw)])

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        coef = torch.zeros(B, dtype=torch.float32, device=x.device)
        out = dispatch_attention(q[:, None], k[:, None], v[:, None], coef, AttnMode.SELF)[:, 0]
        out = self.to_out[0](out)
        return x + out.reshape(B, H, W, C).permute(0, 3, 1, 2)


class VAEMidBlock(nn.Module):
    def __init__(self, channels: int, norm_num_groups: int, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.resnets = nn.ModuleList([VAEResnetBlock(channels, channels, norm_num_groups, **kw) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(channels, norm_num_groups, **kw)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class VAEUpsample(nn.Module):
    """Nearest x2 upsample, then a 3x3 conv (diffusers ``upsamplers.0.conv``)."""

    def __init__(self, channels: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1, device=device, dtype=dtype)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class VAEUpBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_resnets: int, norm_num_groups: int,
                 add_upsample: bool, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.resnets = nn.ModuleList([
            VAEResnetBlock(in_channels if j == 0 else out_channels, out_channels, norm_num_groups, **kw)
            for j in range(num_resnets)])
        if add_upsample:
            self.upsamplers = nn.ModuleList([VAEUpsample(out_channels, **kw)])

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


class VAEDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        ch = list(reversed(cfg.block_out_channels))
        groups = cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.latent_channels, ch[0], 3, padding=1, **kw)
        self.mid_block = VAEMidBlock(ch[0], groups, **kw)
        self.up_blocks = nn.ModuleList()
        prev = ch[0]
        for level, out_ch in enumerate(ch):
            self.up_blocks.append(VAEUpBlock(prev, out_ch, cfg.layers_per_block + 1, groups,
                                             level != len(ch) - 1, **kw))
            prev = out_ch
        self.conv_norm_out = nn.GroupNorm(groups, ch[-1], eps=1e-6, **kw)
        self.conv_out = nn.Conv2d(ch[-1], cfg.out_channels, 3, padding=1, **kw)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            h = blk(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    """The decode side of diffusers' AutoencoderKL."""

    def __init__(self, config: VAEConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        self.config = config
        self.decoder = VAEDecoder(config, device=device, dtype=dtype)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1, device=device,
                                         dtype=dtype)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latents (B, latent_channels, h, w), already divided by the scaling
        factor -> raw decoder output (B, out_channels, f*h, f*w), about
        [-1, 1], with f = 2 ** (len(block_out_channels) - 1) (8 for SDXL)."""
        return self.decoder(self.post_quant_conv(z))
