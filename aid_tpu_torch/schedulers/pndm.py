"""PNDM (PLMS) scheduler with ``skip_prk_steps``, the SD1.x-derivatives' default.

Counterpart of ``aid_tpu.schedulers.pndm`` (pndm.py:51-151): linear
multistep (Adams-Bashforth) epsilon extrapolation over the last four model
outputs, transferred with the DDIM rule in the PNDM paper's denominator
form. Skipping the Runge-Kutta warmup, ``n`` nominal steps take ``n + 1``
UNet evaluations: the timesteps repeat their second entry, and the second
evaluation re-advances the first sample, stashed, with the mean of the
first two epsilons. Every entry point therefore loops over
``state.timesteps``; the AID warmup count is still taken from
``num_inference_steps``.

The JAX package keeps the history in a fixed (4, *latent) ring with traced
order selection; here ``step_index`` is a Python int, so the history is a
tuple of at most four tensors (newest last) and the order a Python branch.
The cumulative alphas each step reads are host floats from ``init``. The
step index doubles as the PLMS counter, global across chunked
``denoise_steps`` segments, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from aid_tpu_torch.schedulers.base import SchedulerConfig, make_betas, spaced_timesteps


class PNDMState(NamedTuple):
    timesteps: torch.Tensor  # (n + 1,) int64, descending, second entry repeated
    alpha_t: tuple  # (n + 1,) host floats: acp at the timestep each step advances from
    alpha_prev: tuple  # (n + 1,) host floats: acp at the one it advances to (or the final alpha)
    ets: tuple  # at most 4 f32 epsilon tensors, newest last
    cur_sample: Optional[torch.Tensor]  # the first sample, stashed for the corrector
    num_inference_steps: int  # the NOMINAL step count n (the loop runs n + 1)
    init_noise_sigma: float = 1.0


@dataclasses.dataclass(frozen=True)
class PNDMScheduler:
    config: SchedulerConfig = SchedulerConfig()
    skip_prk_steps: bool = True

    def init(self, num_inference_steps: int, device=None) -> PNDMState:
        if not self.skip_prk_steps:
            raise NotImplementedError("PNDM's Runge-Kutta warmup (skip_prk_steps=False) is not implemented, as in "
                                      "the JAX package: every SD-family checkpoint pins skip_prk_steps=True")
        cfg = self.config
        acp = np.cumprod(1.0 - make_betas(cfg))
        final = 1.0 if cfg.set_alpha_to_one else acp[0]
        ds = spaced_timesteps(cfg, num_inference_steps)
        ts = np.concatenate([ds[:1], ds[1:2], ds[1:]])
        dt = cfg.num_train_timesteps // num_inference_steps
        # the corrector (step 1) re-advances the stash over the first
        # interval (t + dt -> t); every other step advances t -> t - dt
        t_from = ts.copy()
        t_from[1] += dt
        t_to = ts - dt
        t_to[1] = ts[1]
        a_prev = np.where(t_to >= 0, acp[np.maximum(t_to, 0)], final)
        return PNDMState(
            timesteps=torch.tensor(ts, dtype=torch.int64, device=device),
            alpha_t=tuple(acp[t_from].tolist()), alpha_prev=tuple(a_prev.tolist()),
            ets=(), cur_sample=None, num_inference_steps=num_inference_steps,
        )

    def scale_model_input(self, state: PNDMState, sample: torch.Tensor, step_index: int) -> torch.Tensor:
        return sample

    def step(self, state: PNDMState, model_output: torch.Tensor, step_index: int, sample: torch.Tensor,
             eta: float = 0.0, generator: Optional[torch.Generator] = None):
        """One PLMS step over the (n + 1)-long timesteps; returns
        (prev_sample, state). ``eta``/``generator`` are accepted for the
        engine's signature and unused (PNDM is ODE-only)."""
        i = step_index
        x = sample.float()
        eps = model_output.float()
        ets = state.ets if i == 1 else (state.ets + (eps,))[-4:]  # the corrector appends nothing
        if i == 0:
            mo = eps
        elif i == 1:
            mo = (eps + ets[-1]) / 2.0
        elif len(ets) == 2:
            mo = (3.0 * ets[-1] - ets[-2]) / 2.0
        elif len(ets) == 3:
            mo = (23.0 * ets[-1] - 16.0 * ets[-2] + 5.0 * ets[-3]) / 12.0
        else:
            mo = (55.0 * ets[-1] - 59.0 * ets[-2] + 37.0 * ets[-3] - 9.0 * ets[-4]) / 24.0

        x_eff = state.cur_sample if i == 1 else x
        a_t, a_prev = state.alpha_t[i], state.alpha_prev[i]
        kind = self.config.prediction_type
        if kind == "v_prediction":
            mo = a_t ** 0.5 * mo + (1.0 - a_t) ** 0.5 * x_eff
        elif kind != "epsilon":
            raise ValueError(f"PNDM supports epsilon/v_prediction, got {kind}")
        denom = a_t * (1.0 - a_prev) ** 0.5 + (a_t * (1.0 - a_t) * a_prev) ** 0.5
        prev = (a_prev / a_t) ** 0.5 * x_eff - ((a_prev - a_t) / denom) * mo
        new_state = state._replace(ets=ets, cur_sample=x if i == 0 else state.cur_sample)
        return prev.to(sample.dtype), new_state

    def add_noise(self, state: PNDMState, original: torch.Tensor, noise: torch.Tensor, t) -> torch.Tensor:
        """Forward diffusion to train timestep ``t`` (an int)."""
        acp = float(np.cumprod(1.0 - make_betas(self.config))[int(t)])
        return acp ** 0.5 * original + (1.0 - acp) ** 0.5 * noise
