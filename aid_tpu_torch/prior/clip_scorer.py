"""CLIP image features for the Beta-prior selection, and CLIP preprocessing.

Counterpart of ``aid_tpu.prior.clip_scorer``: ``preprocess`` resizes frames
straight to the tower's (S, S) and normalises them with
``CLIPImageProcessor``'s mean and std; ``make_clip_feature_fn`` wraps a
``CLIPVisionModel`` as the ``feature_fn`` of ``BetaPriorPipeline``, one
batched forward a call on the model's device.

The resize is the JAX package's ``jax.image.resize(..., "bilinear")``, which
antialiases when it downsamples (512 -> 224): a triangle filter widened by
the scale factor, its weights renormalised at the borders. That is
``F.interpolate(mode="bilinear", antialias=True)``; without ``antialias``
the 512 -> 224 frames would differ by up to half the value range.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

# CLIPImageProcessor's constants (openai/clip-vit-base-patch32)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def preprocess(images, image_size: int = 224, device=None) -> torch.Tensor:
    """uint8 or float (N, H, W, 3) frames (numpy or torch) -> CLIP-normalised
    f32 (N, 3, S, S) on ``device`` (the input's own when None). uint8 is
    scaled to [0, 1] first."""
    x = torch.as_tensor(images, device=device)
    x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
    x = F.interpolate(x.permute(0, 3, 1, 2), size=(image_size, image_size), mode="bilinear", align_corners=False,
                      antialias=True)
    mean = torch.tensor(CLIP_MEAN, device=x.device).reshape(1, 3, 1, 1)
    std = torch.tensor(CLIP_STD, device=x.device).reshape(1, 3, 1, 1)
    return (x - mean) / std


def make_clip_feature_fn(vision_model) -> Callable[[np.ndarray], np.ndarray]:
    """frames (N, H, W, 3) -> (N, projection_dim) f32 numpy image features,
    from one forward of ``vision_model`` (a ``CLIPVisionModel``) on its
    device and in its dtype."""
    weight = vision_model.visual_projection.weight

    @torch.no_grad()
    def feature_fn(images: np.ndarray) -> np.ndarray:
        px = preprocess(images, vision_model.config.image_size, device=weight.device).to(weight.dtype)
        embeds, _ = vision_model(px)
        return embeds.float().cpu().numpy()

    return feature_fn
