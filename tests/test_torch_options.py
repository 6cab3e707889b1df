"""PyTorch port, the loop's options: the sequential line search
(``linesearch="seq"``) and EMA smoothing (``ema_alpha``), NGD and prox,
against ``jax.vmap(optimize)`` on the CPU (f64, three problems that take
different decisions), and ``seq`` against ``batched`` as
``tests/test_linesearch.py`` holds them in the JAX package."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gaussianvi_tpu_torch import GVIConfig, optimize, stack_problems  # noqa: E402
from gaussianvi_tpu_torch.convert import (  # noqa: E402
    graph_from_arrays,
    state_from_arrays,
)
from test_torch_slice import (  # noqa: E402
    CPU,
    build_chain_estimation,
    describe,
    run_both,
)

# a scheduled switch at iteration 2 inside 4 iterations; prox at a step it
# accepts (at 0.9 every prox trial on this chain is rejected, in JAX too)
BASE = {"ngd": dict(niters=4, niters_lowtemp=2, step_size_base=0.9),
        "prox": dict(niters=4, niters_lowtemp=2, step_size_base=0.1)}


@functools.lru_cache(maxsize=None)
def _problems():
    return tuple(build_chain_estimation(num_states=6, dim_x=2, gh_degree=4,
                                        seed=seed)[:2] for seed in range(3))


def _assert_same(jstate, jhist, state, hist):
    np.testing.assert_allclose(hist.cost.numpy(), np.asarray(jhist.cost),
                               rtol=1e-9)
    np.testing.assert_array_equal(hist.accepted_step.numpy(),
                                  np.asarray(jhist.accepted_step))
    np.testing.assert_allclose(hist.factor_costs.numpy(),
                               np.asarray(jhist.factor_costs), rtol=1e-9)
    np.testing.assert_allclose(state.mu.numpy(), np.asarray(jstate.mu),
                               atol=1e-9)
    np.testing.assert_allclose(state.precision.diag.numpy(),
                               np.asarray(jstate.precision.diag), atol=1e-9)
    np.testing.assert_allclose(state.precision.off.numpy(),
                               np.asarray(jstate.precision.off), atol=1e-9)


@pytest.mark.parametrize("method,fields", [
    ("ngd", dict(linesearch="seq")),
    ("prox", dict(linesearch="seq")),
    ("ngd", dict(ema_alpha=0.5)),
    ("ngd", dict(ema_alpha=0.7)),
    ("prox", dict(ema_alpha=0.5)),
    ("prox", dict(ema_alpha=0.7)),
])
def test_option_matches_jax(method, fields):
    """The option on the port's separate path against the JAX package's
    ``jax.vmap(optimize)``: the same costs, factor costs, accepted steps
    and final state."""
    cfg = dict(BASE[method], **fields)
    jstate, jhist, state, hist = run_both(list(_problems()), cfg, cfg,
                                          method)
    _assert_same(jstate, jhist, state, hist)
    assert (np.asarray(jhist.accepted_step) > 0).any()


def _port_run(method, seeds=(3, 7), **cfg):
    """Two different problems stacked, through the port's ``optimize``."""
    described = [describe(*build_chain_estimation(
        num_states=6, dim_x=2, gh_degree=4, seed=seed)[:2]) for seed in seeds]
    graph, state = stack_problems(
        [graph_from_arrays(d, device=CPU) for d, _ in described],
        [state_from_arrays(st, device=CPU) for _, st in described])
    return optimize(graph, state, GVIConfig(**cfg), method=method)


@pytest.mark.parametrize("method,kw", [
    ("ngd", dict(niters=8, niters_lowtemp=8, step_size_base=0.9)),
    ("prox", dict(niters=8, niters_lowtemp=8, step_size_base=0.9)),
    # a hopeless step size exhausts the search: NGD escalates, then
    # freezes; both strategies must walk that trajectory too
    ("ngd", dict(niters=6, niters_lowtemp=2, step_size_base=1e6,
                 niters_backtrack=3)),
])
def test_seq_matches_batched(method, kw):
    """Both strategies select the same iterate on every problem of a batch
    (``tests/test_linesearch.py``'s tolerances)."""
    f_b, h_b = _port_run(method, linesearch="batched", **kw)
    f_s, h_s = _port_run(method, linesearch="seq", **kw)
    torch.testing.assert_close(h_s.accepted_step, h_b.accepted_step,
                               rtol=0, atol=0)
    np.testing.assert_allclose(h_s.cost.numpy(), h_b.cost.numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(f_s.mu.numpy(), f_b.mu.numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(f_s.precision.diag.numpy(),
                               f_b.precision.diag.numpy(), rtol=1e-12,
                               atol=1e-12)


STEP_APART = 0.9


def test_seq_problems_search_on_their_own():
    """A batch whose problems accept different trials: each problem's
    search stops at its own first decreasing trial (one problem's longer
    search does not move another's selection)."""
    kw = dict(niters=3, niters_lowtemp=3, step_size_base=STEP_APART)
    _, h = _port_run("ngd", linesearch="seq", **kw)
    assert not torch.equal(h.accepted_step[0], h.accepted_step[1])
    for b, seed in enumerate((3, 7)):
        single = _port_run("ngd", seeds=(seed,), linesearch="seq", **kw)[1]
        torch.testing.assert_close(h.accepted_step[b],
                                   single.accepted_step[0], rtol=0, atol=0)
        np.testing.assert_allclose(h.cost[b].numpy(), single.cost[0].numpy(),
                                   rtol=1e-12)


@pytest.mark.parametrize("fields,error", [
    (dict(linesearch="nope"), "linesearch"),
    (dict(linesearch="seq", fused_trials="on"), "batched"),
    (dict(moments_eval_dtype="float8"), "moments_eval_dtype"),
])
def test_bad_options_rejected(fields, error):
    with pytest.raises(ValueError, match=error):
        _port_run("ngd", niters=1, **fields)
