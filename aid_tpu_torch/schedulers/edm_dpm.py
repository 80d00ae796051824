"""EDM DPM-Solver++ (2M) scheduler, playground-v2.5's default.

Counterpart of ``aid_tpu.schedulers.edm_dpm`` (edm_dpm.py:39-117): Karras
sigmas between ``sigma_min`` and ``sigma_max`` (rho 7), EDM preconditioning
(c_in = 1 / sqrt(sigma^2 + sigma_data^2) in ``scale_model_input``; c_skip
and c_out turn the model output into x0, edm_dpm.py:70-77) and the 2M
midpoint update in sigma space, first order on the first and the last step.
The UNet's timesteps are c_noise = log(sigma) / 4 (floats); the final
boundary's sigma is 1e-10 rather than 0, as there. ``add_noise`` takes a
step index, not a timestep (edm_dpm.py:115).

``step_index`` is a Python int, so the order is a Python branch, and every
per-step coefficient is a host float computed in float64; the previous x0
prediction is carried in the state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch


class EDMDPMState(NamedTuple):
    timesteps: torch.Tensor  # (n,) f32 c_noise values fed to the model
    sigmas: tuple  # (n + 1,) host floats, descending, final 1e-10
    m_prev: Optional[torch.Tensor]  # the previous x0 prediction
    num_inference_steps: int
    init_noise_sigma: float


@dataclasses.dataclass(frozen=True)
class EDMDPMSolverScheduler:
    sigma_min: float = 0.002
    sigma_max: float = 80.0
    sigma_data: float = 0.5
    rho: float = 7.0
    prediction_type: str = "epsilon"  # "epsilon" | "v_prediction" (the EDM F-prediction forms)

    def init(self, num_inference_steps: int, device=None) -> EDMDPMState:
        n = num_inference_steps
        ramp = np.linspace(0, 1, n)
        smin_r, smax_r = self.sigma_min ** (1 / self.rho), self.sigma_max ** (1 / self.rho)
        sigmas = (smax_r + ramp * (smin_r - smax_r)) ** self.rho
        c_noise = 0.25 * np.log(sigmas)
        sigmas = np.concatenate([sigmas, [1e-10]])
        return EDMDPMState(
            timesteps=torch.tensor(c_noise, dtype=torch.float32, device=device),
            sigmas=tuple(sigmas.tolist()), m_prev=None, num_inference_steps=n,
            init_noise_sigma=float((sigmas[0] ** 2 + 1.0) ** 0.5),
        )

    def scale_model_input(self, state: EDMDPMState, sample: torch.Tensor, step_index: int) -> torch.Tensor:
        """sample * c_in, in f32."""
        sigma = state.sigmas[step_index]
        return sample.float() / math.sqrt(sigma ** 2 + self.sigma_data ** 2)

    def _x0(self, state: EDMDPMState, model_output: torch.Tensor, i: int, sample: torch.Tensor) -> torch.Tensor:
        sigma, sd = state.sigmas[i], self.sigma_data
        c_skip = sd ** 2 / (sigma ** 2 + sd ** 2)
        c_out = sigma * sd / math.sqrt(sigma ** 2 + sd ** 2)
        if self.prediction_type == "v_prediction":
            c_out = -c_out
        elif self.prediction_type != "epsilon":
            raise ValueError(self.prediction_type)
        return c_skip * sample + c_out * model_output

    def step(self, state: EDMDPMState, model_output: torch.Tensor, step_index: int, sample: torch.Tensor,
             eta: float = 0.0, generator: Optional[torch.Generator] = None):
        """One DPM-Solver++ 2M step; returns (prev_sample, state).
        ``eta``/``generator`` are accepted for the engine's signature and
        unused, as in the JAX package."""
        i, n, sig = step_index, state.num_inference_steps, state.sigmas
        x = sample.float()
        m0 = self._x0(state, model_output.float(), i, x)
        h = math.log(sig[i]) - math.log(sig[i + 1])  # lambda = -log(sigma)
        phi = math.expm1(-h)
        prev = (sig[i + 1] / sig[i]) * x - phi * m0
        if 1 <= i < n - 1:  # 2M midpoint: D1 = (m0 - m_prev) / r0, r0 = h_0 / h
            r0 = (math.log(sig[i - 1]) - math.log(sig[i])) / h
            prev = prev - (0.5 * phi / r0) * (m0 - state.m_prev)
        return prev.to(sample.dtype), state._replace(m_prev=m0)

    def add_noise(self, state: EDMDPMState, original: torch.Tensor, noise: torch.Tensor, step_index: int):
        return original + noise * state.sigmas[step_index]
