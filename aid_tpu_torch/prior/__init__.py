"""Coefficient selection: the Beta-prior explore-and-select and the Bayesian (alpha, beta) search.

Exports what ``aid_tpu.prior`` exports, under the same names. The native DP
solver (``dp_solver``) is built at its first use, not at import.
"""

from aid_tpu_torch.ops.interp import generate_beta_schedule as generate_beta_tensor
from aid_tpu_torch.prior.bayes import GPOptimizer, bayesian_prior_selection
from aid_tpu_torch.prior.beta import BetaPriorPipeline, find_minimal_spread_and_path, fit_alpha_beta

__all__ = [
    "BetaPriorPipeline",
    "find_minimal_spread_and_path",
    "fit_alpha_beta",
    "GPOptimizer",
    "bayesian_prior_selection",
    "generate_beta_tensor",
]
