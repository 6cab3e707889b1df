"""The arm quadrature's share of its roofline: the least time of its
algorithmic work over the device time of the kernel that computes it (the
arm's K3 instance, ``kernels/quad.py`` -> ``csrc/quad_arm.cu``
``quad_arm_kernel``), over the profiled calls.  A call's work is E[phi]
of every factor at the initial state and on the line search's trials
every iteration, and the moments of every factor every iteration
(``work.quad_flops`` with the cost's operations a node from the family's
``shapes``); its bytes each factor's marginal read once (the joint
angles' for E[phi], the whole state's for the moments) and its outputs
written once, with the field, the params and the rule once a launch.  If
the quadrature moves to other kernels this list goes stale and the
metric reads nothing."""

from benchmark import work
from benchmark.metrics._device import roofline_pct

KERNELS = ("quad_arm_kernel",)


def read(run):
    tr = run.trace
    if tr is None or not tr.calls or tr.seconds_of(KERNELS) <= 0:
        return None  # not this cell's kernels: no shapes read
    z = run.shapes()
    d, m, dx, cost = z["s"], z["m"], z["dx"], z["cost"]
    factors = run.problems_per_call * z["n"]
    trials = run.cell.cfg["gvi"]["niters_backtrack"] + 1
    phi_batches = 1 + run.iters * trials
    ops = factors * (phi_batches * work.quad_flops(d, m, dx, False, cost)
                     + run.iters * work.quad_flops(d, m, dx, True, cost))
    values = (factors * (phi_batches * (dx + dx * dx + 1)
                         + run.iters * (2 * (d + d * d) + 1))
              + (phi_batches + run.iters) * z["quad_shared"])
    return roofline_pct(run, "arm_quad_roofline.interactive", KERNELS,
                        (ops, values * run.elt))
