"""The NGD gradient step's share of its roofline (covariance, moments,
assembly, both solves): the least time of its algorithmic work
(``work.gradient``, every iteration of the profiled calls) over the
device time of the kernels that compute it (the fused gradient kernel K6,
``kernels/fused_gradient.py`` -> ``csrc/fused_gradient*.cu*``).  If the
step moves to other kernels this list goes stale and the metric reads
nothing."""

from benchmark import work
from benchmark.metrics._device import roofline_pct

KERNELS = ("grad_kernel", "grad_s6_kernel")


def read(run):
    ops, nbytes = work.gradient(run.shapes(), run.problems_per_call, run.elt)
    return roofline_pct(run, "gradient_roofline.bulk", KERNELS,
                        (run.iters * ops, run.iters * nbytes))
