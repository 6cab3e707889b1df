"""Small-block and block-tridiagonal algebra (plain PyTorch)."""

from .blocktridiag import (
    BlockTridiag,
    block_cholesky,
    gbp_covariance,
    gbp_covariance_logdet,
    logdet,
    marginal_covariance_dense,
    solve,
    spd_inv,
    spd_solve,
)
from .psd import psd_inv_sqrtm, psd_sqrtm, sqrtm_product

__all__ = [
    "BlockTridiag", "block_cholesky", "gbp_covariance", "logdet",
    "marginal_covariance_dense", "solve", "gbp_covariance_logdet",
    "spd_inv", "spd_solve",
    "psd_sqrtm", "psd_inv_sqrtm", "sqrtm_product",
]
