"""The chain kernels' share of their roofline at s = 14 (the wide layout,
``kernels/chain.py`` -> ``csrc/chain_wide.cu`` ``gbp_wide_kernel``,
``solve_wide_kernel``): the least time of the chains' algorithmic work
over the device time of those kernels, over the profiled calls.  A
call's work is a covariance sweep of every problem's chain at the
initial state and of every trial's every iteration (``work.chain_flops``
a state), and the NGD step's pair of solves every iteration
(``work.solve_flops`` a state and system); its bytes each chain's blocks
read once and its covariance blocks and log det written once, each
pair's two systems and one right-hand side read and two solutions
written.  If the chains move to other kernels this list goes stale and
the metric reads nothing."""

from benchmark import work
from benchmark.metrics._device import roofline_pct

KERNELS = ("gbp_wide_kernel", "solve_wide_kernel")


def read(run):
    tr = run.trace
    if tr is None or not tr.calls or tr.seconds_of(KERNELS) <= 0:
        return None  # not this cell's kernels: no shapes read
    z = run.shapes()
    n, s = z["n"], z["s"]
    trials = run.cell.cfg["gvi"]["niters_backtrack"] + 1
    chains = run.problems_per_call * (1 + run.iters * trials)
    pairs = run.problems_per_call * run.iters
    ops = n * (chains * work.chain_flops(s) + 2 * pairs * work.solve_flops(s))
    blocks = n * s * s + (n - 1) * s * s
    values = chains * (2 * blocks + 1) + pairs * (2 * blocks + 3 * n * s)
    return roofline_pct(run, "wide_chain_roofline.interactive", KERNELS,
                        (ops, values * run.elt))
