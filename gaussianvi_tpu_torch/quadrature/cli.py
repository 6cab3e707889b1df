"""Quadrature command-line tools.

Counterpart of ``gaussianvi_tpu/quadrature/cli.py``, printing the same
text.  Equivalents of the reference's driver executables:
* ``save-table``   — src/save_SparseGH_weights.cpp (build + serialize the
  full (dim, degree) table per the reference schedule; by default into the
  port's build directory, never over the committed table)
* ``show-rule``    — src/spgh_example.cpp (print a rule's nodes/weights)
* ``sigmapts``     — src/generate_sigmapts.cpp (sigma points of a rule
  placed at N(mu, sigma^2 I))

Usage:
    python -m gaussianvi_tpu_torch.quadrature.cli save-table [path]
    python -m gaussianvi_tpu_torch.quadrature.cli show-rule DIM DEGREE
    python -m gaussianvi_tpu_torch.quadrature.cli sigmapts DIM DEGREE MU SIGMA
"""

from __future__ import annotations

import sys

import numpy as np

from .smolyak import sparse_gh
from .table import BUILD_TABLE, save_table


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    cmd = argv[0]
    if cmd == "save-table":
        path = argv[1] if len(argv) > 1 else BUILD_TABLE
        out = save_table(path)
        print(f"saved quadrature table to {out}")
        return 0
    if cmd == "show-rule":
        dim, deg = int(argv[1]), int(argv[2])
        nodes, weights = sparse_gh(dim, deg)
        print(f"(dim={dim}, degree={deg}): {nodes.shape[0]} nodes")
        with np.printoptions(precision=12, suppress=False):
            print("nodes:\n", nodes)
            print("weights:\n", weights)
        return 0
    if cmd == "sigmapts":
        dim, deg = int(argv[1]), int(argv[2])
        mu, sigma = float(argv[3]), float(argv[4])
        nodes, weights = sparse_gh(dim, deg)
        pts = nodes * sigma + mu
        print(f"(dim={dim}, degree={deg}) at N({mu}, {sigma}^2 I): "
              f"{pts.shape[0]} sigma points")
        with np.printoptions(precision=12):
            print("sigma points:\n", pts)
            print("weights:\n", weights)
        return 0
    print(f"unknown command {cmd!r}")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
