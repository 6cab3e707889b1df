"""The line-search trial costs' share of their roofline: the least time
of the trials' algorithmic work (``work.trials``, every iteration of the
profiled calls) over the device time of the kernels that compute them
(the fused trial kernel K5, ``kernels/fused_trials.py`` ->
``csrc/fused_trials*.cu``).  If the trials move to other kernels this
list goes stale and the metric reads nothing."""

from benchmark import work
from benchmark.metrics._device import roofline_pct

KERNELS = ("trials_kernel", "trials_s6_kernel")


def read(run):
    ops, nbytes = work.trials(run.shapes(), run.cell.cfg["gvi"],
                              run.problems_per_call, run.elt)
    return roofline_pct(run, "trials_roofline.bulk", KERNELS,
                        (run.iters * ops, run.iters * nbytes))
