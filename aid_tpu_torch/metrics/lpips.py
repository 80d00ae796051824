"""LPIPS perceptual distance (VGG16 trunk and linear heads) in PyTorch.

Counterpart of ``aid_tpu.metrics.lpips`` (lpips.py:34-94): VGG16 features
at relu1_2 / relu2_2 / relu3_3 / relu4_3 / relu5_3, unit-normalised over
channels (+1e-10 on the norm), squared differences, a learned 1x1 head
each, a spatial mean, summed over the five stages. Parameter names are
``lpips.LPIPS(net='vgg')``'s: ``net.slice{1..5}.<global index>.weight/bias``
(torchvision's VGG16 sequential indices) and ``lin{0..4}.model.1.weight``,
so the port's ``state_dict()`` feeds
``aid_tpu.models.params.convert_lpips_state_dict`` and an lpips checkpoint
loads as it is. The convs are ``nn.Conv2d`` (cuDNN), as the JAX package
leaves them to XLA: they never route to the port's conv kernel.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
from torch import nn

# VGG16's conv plan: (out_channels, convs) a stage, a 2x2 max pool between stages
VGG16_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# LPIPS's own input shift and scale (its ScalingLayer)
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """The VGG16 trunk as five ``nn.Sequential`` slices keyed by torchvision's
    global layer index; returns the five stages' features. NCHW."""

    def __init__(self, *, device=None, dtype=torch.float32):
        super().__init__()
        idx, cin = 0, 3
        for si, (ch, n_convs) in enumerate(VGG16_STAGES):
            stage = nn.Sequential()
            if si > 0:
                stage.add_module(str(idx), nn.MaxPool2d(2, 2))
                idx += 1
            for _ in range(n_convs):
                stage.add_module(str(idx), nn.Conv2d(cin, ch, 3, padding=1, device=device, dtype=dtype))
                stage.add_module(str(idx + 1), nn.ReLU())
                idx, cin = idx + 2, ch
            setattr(self, f"slice{si + 1}", stage)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for si in range(len(VGG16_STAGES)):
            x = getattr(self, f"slice{si + 1}")(x)
            feats.append(x)
        return feats


class _ScalingLayer(nn.Module):
    def __init__(self, **kw):
        super().__init__()
        self.register_buffer("shift", torch.tensor(LPIPS_SHIFT, **kw).reshape(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(LPIPS_SCALE, **kw).reshape(1, 3, 1, 1))


class _NetLinLayer(nn.Module):
    """lpips' 1x1 head: ``model.0`` is its dropout (identity in eval, so an
    identity here), ``model.1`` the bias-free conv."""

    def __init__(self, cin: int, **kw):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(cin, 1, 1, bias=False, **kw))


class LPIPS(nn.Module):
    """``forward(x0, x1)``: two (B, 3, H, W) batches (ImageNet-normalised, as
    :func:`compute_lpips` gives them) -> (B,) perceptual distances."""

    def __init__(self, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.scaling_layer = _ScalingLayer(**kw)
        self.net = VGG16Features(**kw)
        for si, (ch, _) in enumerate(VGG16_STAGES):
            setattr(self, f"lin{si}", _NetLinLayer(ch, **kw))

    def forward(self, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        sl = self.scaling_layer
        x = (torch.cat([x0, x1]) - sl.shift) / sl.scale  # one trunk pass for both sides
        total = 0.0
        for si, f in enumerate(self.net(x)):
            f = f / (torch.linalg.vector_norm(f, dim=1, keepdim=True) + 1e-10)
            a, b = f.chunk(2)
            total = total + getattr(self, f"lin{si}").model((a - b) ** 2).mean(dim=(1, 2, 3))
        return total


@torch.no_grad()
def compute_lpips(images: np.ndarray, lpips: LPIPS) -> np.ndarray:
    """Adjacent-pair LPIPS distances of a frame sequence: (N, H, W, 3) uint8
    or [0, 1] float -> (N - 1,) f32 numpy. ImageNet's mean and std first,
    then LPIPS's shift and scale inside the model; all N - 1 pairs in one
    batched call on the model's device."""
    weight = lpips.lin0.model[1].weight
    x = torch.as_tensor(np.asarray(images), device=weight.device)
    x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    x = ((x - mean) / std).permute(0, 3, 1, 2).to(weight.dtype)
    return lpips(x[:-1], x[1:]).float().cpu().numpy()
