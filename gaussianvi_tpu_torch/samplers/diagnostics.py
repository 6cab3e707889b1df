"""MCMC convergence diagnostics: split-R-hat (plain, rank-normalized, and
folded) and effective sample size.

Counterpart of ``gaussianvi_tpu/samplers/diagnostics.py``, the same NumPy
code; a tensor argument (a CUDA one too) is copied to the host first.

Gelman et al. (BDA3) split-R-hat plus the Vehtari et al. 2021
rank-normalized variants: ``rank_normalized_rhat`` is robust to heavy tails
and infinite variance (plain R-hat is not), and the folded version detects
scale (variance) non-mixing that location-based R-hat misses.  NumPy over
[C, T, D] sample stacks.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import ndtri as _ndtri  # inverse normal CDF


def _host(samples) -> np.ndarray:
    """A sample stack as a NumPy array (tensors copied to the host)."""
    if isinstance(samples, torch.Tensor):
        return samples.detach().cpu().numpy()
    return np.asarray(samples)


def split_rhat(samples: np.ndarray) -> np.ndarray:
    """Split-R-hat per dimension.  samples [C, T, D] (chains, draws, dims)."""
    samples = _host(samples)
    c, t, d = samples.shape
    half = t // 2
    chains = np.concatenate(
        [samples[:, :half], samples[:, half:2 * half]], axis=0
    )  # [2C, half, D]
    m, n = chains.shape[0], chains.shape[1]
    chain_means = chains.mean(axis=1)              # [2C, D]
    chain_vars = chains.var(axis=1, ddof=1)        # [2C, D]
    between = n * chain_means.var(axis=0, ddof=1)  # [D]
    within = chain_vars.mean(axis=0)               # [D]
    var_est = (n - 1) / n * within + between / n
    return np.sqrt(var_est / np.maximum(within, 1e-300))


def _rank_normalize(samples: np.ndarray) -> np.ndarray:
    """Fractional-rank normal-score transform (Vehtari et al. 2021 eq. 14):
    pooled average ranks -> z = Phi^{-1}((rank - 3/8) / (S + 1/4))."""
    c, t, d = samples.shape
    flat = samples.reshape(c * t, d)
    order = np.argsort(flat, axis=0)
    ranks = np.empty_like(flat)
    rows = np.arange(1, c * t + 1, dtype=flat.dtype)[:, None]
    np.put_along_axis(ranks, order, np.broadcast_to(rows, flat.shape), axis=0)
    # average ties (exact ties are measure-zero for continuous chains; the
    # Blom offset handles the rest)
    z = _ndtri((ranks - 0.375) / (c * t + 0.25))
    return z.reshape(c, t, d)


def rank_normalized_rhat(samples: np.ndarray) -> np.ndarray:
    """Rank-normalized + folded split-R-hat (Vehtari et al. 2021):
    max of bulk (rank-normalized) and tail (folded rank-normalized) R-hat
    per dimension.  samples [C, T, D]."""
    samples = _host(samples)
    bulk = split_rhat(_rank_normalize(samples))
    med = np.median(samples.reshape(-1, samples.shape[-1]), axis=0)
    folded = split_rhat(_rank_normalize(np.abs(samples - med)))
    return np.maximum(bulk, folded)


def ess(samples: np.ndarray, max_lag: int | None = None) -> np.ndarray:
    """Autocorrelation-based effective sample size per dimension.

    samples [C, T, D]; Geyer initial-positive-sequence truncation.
    """
    samples = _host(samples)
    c, t, d = samples.shape
    max_lag = max_lag or min(t - 1, 1000)
    centered = samples - samples.mean(axis=1, keepdims=True)
    out = np.empty(d)
    for j in range(d):
        # average autocorrelation over chains via FFT
        acov = np.zeros(max_lag + 1)
        for ch in range(c):
            x = centered[ch, :, j]
            f = np.fft.rfft(x, n=2 * t)
            ac = np.fft.irfft(f * np.conj(f))[: max_lag + 1]
            acov += ac / t
        acov /= c
        rho = acov / max(acov[0], 1e-300)
        # Geyer: sum consecutive pairs while positive
        tau = 1.0
        k = 1
        while k + 1 <= max_lag:
            pair = rho[k] + rho[k + 1]
            if pair < 0:
                break
            tau += 2.0 * pair
            k += 2
        out[j] = c * t / max(tau, 1e-300)
    return out


def summarize(samples: np.ndarray) -> dict:
    """Convenience: {'rhat', 'rank_rhat', 'ess', 'mean', 'std'}, each [D]."""
    samples = _host(samples)
    flat = samples.reshape(-1, samples.shape[-1])
    return {
        "rhat": split_rhat(samples),
        "rank_rhat": rank_normalized_rhat(samples),
        "ess": ess(samples),
        "mean": flat.mean(axis=0),
        "std": flat.std(axis=0, ddof=1),
    }
