"""Plot the 1-D example: the cost map's contours and each optimizer's
(mu, precision) path, and the cost curves.

Counterpart of ``gaussianvi_tpu/examples/plot_1d.py``; matplotlib is
imported only when the plot is drawn.  Usage (CPU tensors):

    python -m gaussianvi_tpu_torch.examples.plot_1d [out.png] [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np


def main(out_path: str = "barfoot_1d.png", device=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..utils.recorder import cost_map_1d
    from .barfoot_1d import build_barfoot_1d, run_barfoot_1d

    graph, _, _ = build_barfoot_1d(device=device)
    nmesh = 40
    x_start, x_end, y_start, y_end = 18.0, 25.0, 0.05, 1.0
    z = cost_map_1d(graph, x_start=x_start, x_end=x_end, y_start=y_start,
                    y_end=y_end, nmesh=nmesh)
    xs = np.linspace(x_start, x_end, nmesh)
    ys = np.linspace(y_start, y_end, nmesh)

    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    cs = axes[0].contourf(xs, ys, z, levels=30, cmap="viridis")
    fig.colorbar(cs, ax=axes[0])
    for method, color in (("ngd", "w"), ("prox", "r")):
        _, hist = run_barfoot_1d(method, device=device)
        mus = hist.mu[:, 0, 0].cpu().numpy()
        precs = 1.0 / hist.cov_diag[:, 0, 0, 0].cpu().numpy()
        axes[0].plot(mus, precs, f"{color}.-", label=method.upper())
        axes[1].plot(hist.cost.cpu().numpy(), ".-", label=method.upper())
    axes[0].set_xlabel(r"$\mu$")
    axes[0].set_ylabel(r"$\Lambda$ (precision)")
    axes[0].set_title("V(q) landscape + iterates")
    axes[0].legend()
    axes[1].set_xlabel("iteration")
    axes[1].set_ylabel("cost")
    axes[1].set_title("convergence")
    axes[1].legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    print(f"saved {out_path}")
    return out_path


if __name__ == "__main__":
    args = sys.argv[1:]
    dev = None
    if "--device" in args:
        i = args.index("--device")
        dev = args[i + 1]
        del args[i:i + 2]
    main(*args[:1], device=dev)
