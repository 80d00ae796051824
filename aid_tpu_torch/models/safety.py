"""The safety checker (diffusers' ``StableDiffusionSafetyChecker``).

Counterpart of ``aid_tpu.models.safety``: a CLIP vision tower and its
projection score each frame against learned concept embeddings, and
:func:`run_safety_checker` blacks out the frames it flags. The JAX pipeline
runs it on every decode when a checkpoint ships one
(``aid_tpu/pipelines/interpolation.py:155-176``), and so does the port's.

Parameter names are diffusers': ``vision_model.vision_model.*`` (the
transformers ``CLIPVisionModel`` inside), ``visual_projection.weight``,
``concept_embeds``, ``special_care_embeds``, ``concept_embeds_weights`` and
``special_care_embeds_weights``, so a checkpoint's ``safety_checker/``
loads with ``load_state_dict(strict=True)`` and the port's ``state_dict()``
feeds ``aid_tpu.models.safety.convert_safety_checker_state_dict``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from aid_tpu_torch.models.clip import CLIPVisionTransformer
from aid_tpu_torch.models.configs import CLIPVisionConfig


class _VisionTower(nn.Module):
    """transformers' ``CLIPVisionModel``: the transformer under ``vision_model``."""

    def __init__(self, config: CLIPVisionConfig, **kw):
        super().__init__()
        self.vision_model = CLIPVisionTransformer(config, **kw)


def _cos(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-8)
    b = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True) + 1e-8)
    return a @ b.T


class SafetyChecker(nn.Module):
    """``forward(pixel_values, adjustment)``: CLIP-preprocessed (B, 3, S, S)
    -> (B,) bool, True where a frame is flagged (safety.py:24-55)."""

    def __init__(self, config: CLIPVisionConfig, num_concepts: int = 17, num_special: int = 3, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype)
        self.vision_model = _VisionTower(config, **kw)
        self.visual_projection = nn.Linear(config.hidden_size, config.projection_dim, bias=False, **kw)
        self.concept_embeds = nn.Parameter(torch.ones(num_concepts, config.projection_dim, **kw), requires_grad=False)
        self.special_care_embeds = nn.Parameter(torch.ones(num_special, config.projection_dim, **kw),
                                                requires_grad=False)
        self.concept_embeds_weights = nn.Parameter(torch.ones(num_concepts, **kw), requires_grad=False)
        self.special_care_embeds_weights = nn.Parameter(torch.ones(num_special, **kw), requires_grad=False)

    def forward(self, pixel_values: torch.Tensor, adjustment: float = 0.0) -> torch.Tensor:
        pooled, _ = self.vision_model.vision_model(pixel_values)
        image_embeds = self.visual_projection(pooled)
        # diffusers' semantics: ``adjustment`` moves only the special-care
        # scores; a frame that triggered special care gets the concepts'
        # threshold 0.01 stricter
        special = _cos(image_embeds, self.special_care_embeds) - self.special_care_embeds_weights + adjustment
        has_special = (special > 0).any(dim=-1)
        stricter = torch.where(has_special, 0.01, 0.0)[:, None]
        concept = _cos(image_embeds, self.concept_embeds) - self.concept_embeds_weights + stricter
        return (concept > 0).any(dim=-1)


@torch.no_grad()
def run_safety_checker(images: np.ndarray, checker: SafetyChecker) -> Tuple[np.ndarray, np.ndarray]:
    """(N, H, W, 3) uint8 frames -> (frames with the flagged ones set to 0,
    (N,) bool flags), as safety.py:81. The frames are CLIP-preprocessed and
    scored in one batch on the checker's device."""
    from aid_tpu_torch.prior.clip_scorer import preprocess

    weight = checker.visual_projection.weight
    flags = checker(preprocess(images, checker.config.image_size, device=weight.device).to(weight.dtype))
    flags = flags.cpu().numpy()
    out = images.copy()
    out[flags] = 0
    return out, flags
