"""UniPC multistep predictor-corrector scheduler (bh2, order 2, predict_x0).

Counterpart of ``aid_tpu.schedulers.unipc`` (unipc.py:44-163), the
scheduler the JAX app runs for SD checkpoints. Its timesteps are
``linspace(0, T - 1, n + 1)`` reversed, without the final t = 0, whatever
the config's ``timestep_spacing`` and ``steps_offset`` (unipc.py:57-59): the
JAX package reads only the beta schedule and the prediction type from the
config, and so does this port. The final boundary's sigma is 1e-10 rather
than 0, as there.

The JAX package selects the step's order with traced predicates; here
``step_index`` is a Python int, so the order is a Python branch: the
corrector runs from the second step on (order 1 at the second, 2 after),
the predictor is order 2 except on the first and the last step. Every
coefficient is a host float, in float64 from the tables ``init`` computes,
so a step is a few elementwise ops on the latents and no host round trip. The
history (the two previous x0 predictions and the sample fed to the previous
predictor) is carried in the state, which ``denoise_steps`` returns, so it
survives chunked generation and callbacks.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from aid_tpu_torch.schedulers.base import SchedulerConfig, make_betas


class UniPCState(NamedTuple):
    timesteps: torch.Tensor  # (n,) int64, descending
    alphas: tuple  # (n + 1,) host floats, alpha_t = sqrt(acp) per boundary
    sigmas: tuple  # (n + 1,) host floats, sigma_t = sqrt(1 - acp)
    lambdas: tuple  # (n + 1,) host floats, log(alpha / sigma)
    m_prev: Optional[torch.Tensor]  # x0 prediction at step i - 1
    m_prev2: Optional[torch.Tensor]  # x0 prediction at step i - 2
    last_sample: Optional[torch.Tensor]  # the sample fed to the previous predictor
    num_inference_steps: int
    init_noise_sigma: float = 1.0


def _bh_coeffs(h: float) -> tuple:
    """(h_phi_1, B_h, b0, b1) of bh2 with predict_x0 (unipc.py:92-104)."""
    hh = -h
    h_phi_1 = float(np.expm1(hh))
    h_phi_2 = h_phi_1 / hh - 1.0
    h_phi_3 = h_phi_2 / hh - 0.5
    return h_phi_1, h_phi_1, h_phi_2 / h_phi_1, h_phi_3 * 2.0 / h_phi_1


@dataclasses.dataclass(frozen=True)
class UniPCScheduler:
    config: SchedulerConfig = SchedulerConfig(timestep_spacing="linspace")

    def init(self, num_inference_steps: int, device=None) -> UniPCState:
        cfg = self.config
        acp = np.cumprod(1.0 - make_betas(cfg))
        n = num_inference_steps
        ts = np.linspace(0, cfg.num_train_timesteps - 1, n + 1).round()[::-1][:-1].astype(np.int64)
        alpha = np.concatenate([np.sqrt(acp[ts]), [1.0]])
        sigma = np.concatenate([np.sqrt(1.0 - acp[ts]), [1e-10]])
        lam = np.log(alpha) - np.log(sigma)
        return UniPCState(
            timesteps=torch.tensor(ts, dtype=torch.int64, device=device),
            alphas=tuple(alpha.tolist()), sigmas=tuple(sigma.tolist()), lambdas=tuple(lam.tolist()),
            m_prev=None, m_prev2=None, last_sample=None, num_inference_steps=n,
        )

    def scale_model_input(self, state: UniPCState, sample: torch.Tensor, step_index: int) -> torch.Tensor:
        return sample

    def _x0(self, state: UniPCState, model_output: torch.Tensor, i: int, sample: torch.Tensor) -> torch.Tensor:
        a, s = state.alphas[i], state.sigmas[i]
        kind = self.config.prediction_type
        if kind == "epsilon":
            return (sample - s * model_output) / a
        if kind == "v_prediction":
            return a * sample - s * model_output
        if kind == "sample":
            return model_output
        raise ValueError(kind)

    def step(self, state: UniPCState, model_output: torch.Tensor, step_index: int, sample: torch.Tensor,
             eta: float = 0.0, generator: Optional[torch.Generator] = None):
        """One corrector + predictor step; returns (prev_sample, state).
        ``eta``/``generator`` are accepted for the engine's signature and
        unused (an ODE solver), as in the JAX package."""
        i, n = step_index, state.num_inference_steps
        lam, alphas, sigmas = state.lambdas, state.alphas, state.sigmas
        x = sample.float()
        m_t = self._x0(state, model_output.float(), i, x)

        if i >= 1:  # corrector over [i - 1, i]: order 1 at i == 1, else 2
            h = lam[i] - lam[i - 1]
            h_phi_1, B_h, b0, b1 = _bh_coeffs(h)
            a_t = alphas[i]
            x_base = (sigmas[i] / sigmas[i - 1]) * state.last_sample - (a_t * h_phi_1) * state.m_prev
            D1_t = m_t - state.m_prev
            if i == 1:
                x = x_base - (a_t * B_h * 0.5) * D1_t
            else:
                r1 = (lam[i - 2] - lam[i - 1]) / h
                rho0 = (b0 - b1) / (1.0 - r1)
                rho1 = b0 - rho0
                D1_0 = (state.m_prev2 - state.m_prev) / r1
                x = x_base - (a_t * B_h) * (rho0 * D1_0 + rho1 * D1_t)

        # predictor over [i, i + 1]: order 1 on the first and the last step
        h = lam[i + 1] - lam[i]
        h_phi_1, B_h, _, _ = _bh_coeffs(h)
        a_t = alphas[i + 1]
        prev = (sigmas[i + 1] / sigmas[i]) * x - (a_t * h_phi_1) * m_t
        if 1 <= i < n - 1:
            r1 = (lam[i - 1] - lam[i]) / h
            prev = prev - (a_t * B_h * 0.5 / r1) * (state.m_prev - m_t)

        new_state = state._replace(m_prev=m_t, m_prev2=state.m_prev, last_sample=x)
        return prev.to(sample.dtype), new_state

    def add_noise(self, state: UniPCState, original: torch.Tensor, noise: torch.Tensor, t) -> torch.Tensor:
        """Forward diffusion to train timestep ``t`` (an int)."""
        acp = float(np.cumprod(1.0 - make_betas(self.config))[int(t)])
        return acp ** 0.5 * original + (1.0 - acp) ** 0.5 * noise
