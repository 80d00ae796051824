"""Diffusion schedulers: DDIM, Euler, PNDM, UniPC and EDM DPM-Solver++."""

from aid_tpu_torch.schedulers.base import SchedulerConfig
from aid_tpu_torch.schedulers.ddim import DDIMScheduler
from aid_tpu_torch.schedulers.edm_dpm import EDMDPMSolverScheduler
from aid_tpu_torch.schedulers.euler import EulerDiscreteScheduler
from aid_tpu_torch.schedulers.pndm import PNDMScheduler
from aid_tpu_torch.schedulers.unipc import UniPCScheduler

__all__ = [
    "SchedulerConfig",
    "DDIMScheduler",
    "EulerDiscreteScheduler",
    "PNDMScheduler",
    "UniPCScheduler",
    "EDMDPMSolverScheduler",
]
