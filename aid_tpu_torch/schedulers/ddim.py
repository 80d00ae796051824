"""DDIM scheduler (diffusers DDIMScheduler semantics), the SD1.x default.

Counterpart of ``aid_tpu.schedulers.ddim`` (ddim.py:1-104): every
prediction type, ``clip_sample``, and eta > 0 with noise drawn from an
explicit ``torch.Generator``. Timesteps are integers and
``init_noise_sigma`` is 1.

The per-step cumulative alphas are looked up on the host at ``init``:
``alpha_prod[i]`` is alphas_cumprod[t_i] and ``alpha_prod_prev[i]`` is
alphas_cumprod[t_i - T // n], or ``final_alpha_cumprod`` where that index
is negative (ddim.py:61-69). Both are f32 tensors on the sample's device, so
the step indexes them without a device-to-host sync and runs in f32, cast
back to the sample's dtype.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from aid_tpu_torch.schedulers.base import SchedulerConfig, make_betas, spaced_timesteps


class DDIMState(NamedTuple):
    timesteps: torch.Tensor  # (n,) int64, descending
    alpha_prod: torch.Tensor  # (n,) f32: alphas_cumprod at each step's timestep
    alpha_prod_prev: torch.Tensor  # (n,) f32: at the previous timestep, or final_alpha_cumprod
    alphas_cumprod: torch.Tensor  # (T,) f32, for add_noise
    num_inference_steps: int
    init_noise_sigma: float = 1.0


@dataclasses.dataclass(frozen=True)
class DDIMScheduler:
    config: SchedulerConfig = SchedulerConfig()

    def init(self, num_inference_steps: int, device=None) -> DDIMState:
        cfg = self.config
        acp = np.cumprod(1.0 - make_betas(cfg)).astype(np.float32)
        final = np.float32(1.0) if cfg.set_alpha_to_one else acp[0]
        ts = spaced_timesteps(cfg, num_inference_steps)
        prev_ts = ts - cfg.num_train_timesteps // num_inference_steps
        prev = np.where(prev_ts >= 0, acp[np.maximum(prev_ts, 0)], final).astype(np.float32)
        return DDIMState(
            timesteps=torch.tensor(ts, dtype=torch.int64, device=device),
            alpha_prod=torch.tensor(acp[ts], device=device),
            alpha_prod_prev=torch.tensor(prev, device=device),
            alphas_cumprod=torch.tensor(acp, device=device),
            num_inference_steps=num_inference_steps,
        )

    def scale_model_input(self, state: DDIMState, sample: torch.Tensor, step_index: int) -> torch.Tensor:
        return sample

    def step(self, state: DDIMState, model_output: torch.Tensor, step_index: int, sample: torch.Tensor,
             eta: float = 0.0, generator: Optional[torch.Generator] = None):
        """One step x_t -> x_{t-1}; returns (prev_sample, state). ``eta > 0``
        adds noise from ``generator`` (required then)."""
        cfg = self.config
        a_t = state.alpha_prod[step_index]
        a_prev = state.alpha_prod_prev[step_index]
        b_t = 1.0 - a_t
        x = sample.float()
        out = model_output.float()

        if cfg.prediction_type == "epsilon":
            pred_x0 = (x - torch.sqrt(b_t) * out) / torch.sqrt(a_t)
            pred_eps = out
        elif cfg.prediction_type == "v_prediction":
            pred_x0 = torch.sqrt(a_t) * x - torch.sqrt(b_t) * out
            pred_eps = torch.sqrt(a_t) * out + torch.sqrt(b_t) * x
        elif cfg.prediction_type == "sample":
            pred_x0 = out
            pred_eps = (x - torch.sqrt(a_t) * pred_x0) / torch.sqrt(b_t)
        else:
            raise ValueError(cfg.prediction_type)

        if cfg.clip_sample:
            pred_x0 = pred_x0.clamp(-cfg.clip_sample_range, cfg.clip_sample_range)
            pred_eps = (x - torch.sqrt(a_t) * pred_x0) / torch.sqrt(b_t)

        std = 0.0
        if eta > 0.0:
            if generator is None:
                raise ValueError("eta > 0 needs a torch.Generator for the step noise")
            variance = (1.0 - a_prev) / (1.0 - a_t) * (1.0 - a_t / a_prev)
            std = eta * torch.sqrt(variance)

        prev = torch.sqrt(a_prev) * pred_x0 + torch.sqrt(1.0 - a_prev - std ** 2) * pred_eps
        if eta > 0.0:
            prev = prev + std * torch.randn(prev.shape, generator=generator, device=prev.device,
                                            dtype=torch.float32)
        return prev.to(sample.dtype), state

    def add_noise(self, state: DDIMState, original: torch.Tensor, noise: torch.Tensor, t) -> torch.Tensor:
        a = state.alphas_cumprod[t]
        return torch.sqrt(a) * original + torch.sqrt(1.0 - a) * noise
