"""Shared scheduler machinery: beta schedules, timestep spacing, config.

Counterpart of ``aid_tpu.schedulers.base``; host numpy, copied as is.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # "linear" | "scaled_linear" | "squaredcos_cap_v2"
    prediction_type: str = "epsilon"  # "epsilon" | "v_prediction" | "sample"
    timestep_spacing: str = "leading"  # "leading" | "trailing" | "linspace"
    steps_offset: int = 1
    set_alpha_to_one: bool = False
    clip_sample: bool = False
    clip_sample_range: float = 1.0
    thresholding: bool = False
    rescale_betas_zero_snr: bool = False


def make_betas(cfg: SchedulerConfig) -> np.ndarray:
    T = cfg.num_train_timesteps
    if cfg.beta_schedule == "linear":
        betas = np.linspace(cfg.beta_start, cfg.beta_end, T, dtype=np.float64)
    elif cfg.beta_schedule == "scaled_linear":
        betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5, T, dtype=np.float64) ** 2
    elif cfg.beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
        ts = np.arange(T)
        betas = np.minimum(1 - alpha_bar((ts + 1) / T) / alpha_bar(ts / T), 0.999)
    else:
        raise ValueError(f"unknown beta_schedule {cfg.beta_schedule}")
    if cfg.rescale_betas_zero_snr:
        betas = _rescale_zero_terminal_snr(betas)
    return betas


def _rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)
    alphas_bar_sqrt = np.sqrt(alphas_cumprod)
    a0, aT = alphas_bar_sqrt[0].copy(), alphas_bar_sqrt[-1].copy()
    alphas_bar_sqrt = (alphas_bar_sqrt - aT) * a0 / (a0 - aT)
    alphas_bar = alphas_bar_sqrt ** 2
    alphas = np.concatenate([alphas_bar[:1], alphas_bar[1:] / alphas_bar[:-1]])
    return 1 - alphas


def spaced_timesteps(cfg: SchedulerConfig, num_inference_steps: int) -> np.ndarray:
    """Descending inference timesteps per diffusers timestep_spacing rules."""
    T = cfg.num_train_timesteps
    n = num_inference_steps
    if cfg.timestep_spacing == "leading":
        ratio = T // n
        ts = (np.arange(n) * ratio).round()[::-1].astype(np.int64) + cfg.steps_offset
    elif cfg.timestep_spacing == "trailing":
        ratio = T / n
        ts = np.round(np.arange(T, 0, -ratio)).astype(np.int64) - 1
    elif cfg.timestep_spacing == "linspace":
        ts = np.linspace(0, T - 1, n).round()[::-1].astype(np.int64)
    else:
        raise ValueError(f"unknown timestep_spacing {cfg.timestep_spacing}")
    return ts
