"""Problems x configured iterations of every call that started in the
window, over the span from the first call's start to the last call's end
(host clock)."""


def read(run):
    span = run.calls[-1][1] - run.calls[0][0]
    return run.problems_per_call * run.iters * len(run.calls) / span
