"""Posterior-validation harness: GVI moments vs sampler moments.

Counterpart of ``gaussianvi_tpu/samplers/validate.py``.  The north-star
check: the variational posterior's mean and covariance should match the
true posterior (as estimated by HMC/NUTS) within Monte-Carlo + quadrature
error on the example models.  GVI is a KL-projection: on non-Gaussian
targets the match is approximate by design; on linear-Gaussian graphs it
must be exact.  The sampler runs on the GVI state's device; the report is
NumPy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..inference.graph import FactorGraph, GaussianState
from ..ops.blocktridiag import gbp_covariance
from .hmc import hmc
from .nuts import nuts
from .target import make_log_density


class ValidationReport(NamedTuple):
    gvi_mean: np.ndarray
    sampler_mean: np.ndarray
    gvi_cov_diag: np.ndarray
    sampler_cov_diag: np.ndarray
    mean_abs_err: float
    cov_rel_err: float


def sampler_moments(samples: torch.Tensor):
    """samples [T, D] -> (mean [D], cov [D, D])."""
    mean = torch.mean(samples, dim=0)
    centered = samples - mean
    cov = centered.T @ centered / (samples.shape[0] - 1)
    return mean, cov


def validate_posterior(
    graph: FactorGraph,
    gvi_state: GaussianState,
    generator: torch.Generator,
    sampler: str = "hmc",
    num_samples: int = 4000,
    num_warmup: int = 1000,
    **kwargs,
) -> ValidationReport:
    """Run a sampler on the graph's true posterior, compare moments with the
    converged GVI state."""
    n, s = gvi_state.mu.shape
    log_density = make_log_density(graph, n, s)
    init = gvi_state.mu.reshape(-1)
    if sampler == "hmc":
        run = hmc
    elif sampler == "nuts":
        run = nuts
    else:
        raise ValueError(f"unknown sampler {sampler!r}")
    samples = run(log_density, init, generator, num_samples=num_samples,
                  num_warmup=num_warmup, **kwargs).samples

    smean, scov = sampler_moments(samples)
    cov_diag, _ = gbp_covariance(gvi_state.precision)
    gvi_mean = gvi_state.mu.reshape(-1).cpu().numpy()
    gvi_var = torch.diagonal(cov_diag, dim1=-2, dim2=-1).reshape(-1).cpu().numpy()
    smean = smean.cpu().numpy()
    s_var = torch.diagonal(scov).cpu().numpy()
    return ValidationReport(
        gvi_mean=gvi_mean,
        sampler_mean=smean,
        gvi_cov_diag=gvi_var,
        sampler_cov_diag=s_var,
        mean_abs_err=float(np.abs(gvi_mean - smean).max()),
        cov_rel_err=float(
            np.abs(gvi_var - s_var).max() / max(s_var.max(), 1e-12)
        ),
    )
