"""MCMC baselines on a factor graph's pointwise density: HMC, NUTS and
adaptive SMC with the chains batched on the card, convergence diagnostics,
and the GVI-vs-sampler validation harness (counterpart of
``gaussianvi_tpu/samplers``)."""

from .hmc import HMCResult, hmc, run_chains
from .nuts import NUTSResult, nuts, nuts_chains
from .smc import SMCResult, smc_adaptive
from .target import make_log_density, neg_log_prob
from .diagnostics import ess, rank_normalized_rhat, split_rhat, summarize
from .validate import validate_posterior

__all__ = [
    "hmc", "run_chains", "HMCResult",
    "nuts", "nuts_chains", "NUTSResult",
    "smc_adaptive", "SMCResult",
    "neg_log_prob", "make_log_density",
    "validate_posterior",
    "ess", "rank_normalized_rhat", "split_rhat", "summarize",
]
