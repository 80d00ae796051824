"""Euler discrete scheduler (sigma parameterization).

Counterpart of ``aid_tpu.schedulers.euler``: diffusers
EulerDiscreteScheduler semantics, optional Karras sigmas, deterministic step.
The state's timesteps and sigmas are f32 tensors on the sample's device, so
indexing them inside the denoise loop needs no host round trip; the step runs
in f32 and is cast back to the sample dtype.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from aid_tpu_torch.schedulers.base import SchedulerConfig, make_betas, spaced_timesteps


class EulerState(NamedTuple):
    timesteps: torch.Tensor  # (n,) f32
    sigmas: torch.Tensor  # (n+1,) f32, descending, final 0
    num_inference_steps: int
    init_noise_sigma: float


@dataclasses.dataclass(frozen=True)
class EulerDiscreteScheduler:
    config: SchedulerConfig = SchedulerConfig(timestep_spacing="leading")
    use_karras_sigmas: bool = False

    def init(self, num_inference_steps: int, device=None) -> EulerState:
        cfg = self.config
        betas = make_betas(cfg)
        acp = np.cumprod(1.0 - betas)
        all_sigmas = np.sqrt((1.0 - acp) / acp)
        ts = spaced_timesteps(cfg, num_inference_steps).astype(np.float64)
        sigmas = np.interp(ts, np.arange(len(all_sigmas)), all_sigmas)
        if self.use_karras_sigmas:
            rho = 7.0
            smin, smax = sigmas[-1], sigmas[0]
            ramp = np.linspace(0, 1, num_inference_steps)
            sigmas = (smax ** (1 / rho) + ramp * (smin ** (1 / rho) - smax ** (1 / rho))) ** rho
            ts = np.array([self._sigma_to_t(s, np.log(all_sigmas)) for s in sigmas])
        sigmas = np.concatenate([sigmas, [0.0]])
        # diffusers init_noise_sigma: sqrt(max^2 + 1) for "leading", max otherwise
        init_sigma = (float(np.sqrt(sigmas[0] ** 2 + 1)) if cfg.timestep_spacing == "leading"
                      else float(sigmas.max()))
        return EulerState(
            timesteps=torch.tensor(ts.astype(np.float32), device=device),
            sigmas=torch.tensor(sigmas.astype(np.float32), device=device),
            num_inference_steps=num_inference_steps,
            init_noise_sigma=init_sigma,
        )

    @staticmethod
    def _sigma_to_t(sigma, log_sigmas):
        log_sigma = np.log(max(sigma, 1e-10))
        dists = log_sigma - log_sigmas
        low_idx = np.clip((dists >= 0).cumsum(0).argmax(), 0, len(log_sigmas) - 2)
        high_idx = low_idx + 1
        low, high = log_sigmas[low_idx], log_sigmas[high_idx]
        w = np.clip((low - log_sigma) / (low - high), 0, 1)
        return (1 - w) * low_idx + w * high_idx

    def scale_model_input(self, state: EulerState, sample: torch.Tensor, step_index: int) -> torch.Tensor:
        """sample / sqrt(sigma^2 + 1), in f32 (as the JAX package promotes it)."""
        sigma = state.sigmas[step_index]
        return sample.float() / torch.sqrt(sigma ** 2 + 1.0)

    def step(self, state: EulerState, model_output: torch.Tensor, step_index: int, sample: torch.Tensor):
        """One Euler step; returns (prev_sample, state)."""
        cfg = self.config
        sigma = state.sigmas[step_index]
        x = sample.float()
        out = model_output.float()
        if cfg.prediction_type == "epsilon":
            pred_x0 = x - sigma * out
        elif cfg.prediction_type == "v_prediction":
            pred_x0 = out * (-sigma / torch.sqrt(sigma ** 2 + 1)) + (x / (sigma ** 2 + 1))
        elif cfg.prediction_type == "sample":
            pred_x0 = out
        else:
            raise ValueError(cfg.prediction_type)
        derivative = (x - pred_x0) / sigma
        dt = state.sigmas[step_index + 1] - sigma
        prev = x + derivative * dt
        return prev.to(sample.dtype), state

    def add_noise(self, state: EulerState, original, noise, step_index):
        return original + noise * state.sigmas[step_index]
