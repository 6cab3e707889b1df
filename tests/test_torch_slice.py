"""PyTorch port, the whole slice: ``optimize(method="ngd")`` on four
different flagship problems carried over from the JAX package with
``convert.py``, against ``jax.vmap(optimize)`` on the CPU default path
(CPU, f64)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from gaussianvi_tpu.examples.chain_estimation import (  # noqa: E402
    build_chain_estimation,
)
from gaussianvi_tpu.inference import GVIConfig as JaxConfig  # noqa: E402
from gaussianvi_tpu.inference.optimize import optimize as jax_optimize  # noqa: E402
from gaussianvi_tpu.parallel.sharding import stack_problems as jax_stack  # noqa: E402
from gaussianvi_tpu_torch import GVIConfig, optimize, stack_problems  # noqa: E402
from gaussianvi_tpu_torch.convert import (  # noqa: E402
    graph_from_arrays,
    state_from_arrays,
)

N, B = 8, 4
CONFIGS = {
    # the bench's settings, shortened
    "bench": dict(niters=5, niters_lowtemp=5, step_size_base=0.9),
    # few trials and an early scheduled switch: exercises the temperature
    # escalation, the switch and the convergence freeze
    "converging": dict(niters=5, niters_lowtemp=2, niters_backtrack=1,
                       step_size_base=0.9),
}


def describe(graph, init):
    """The JAX problem as the plain arrays convert.py takes."""
    a = np.asarray
    nonlinear = [dict(
        start=a(fb.start), nodes=a(fb.nodes), weights=a(fb.weights),
        params={k: a(v) for k, v in fb.params.items()}, nb=fb.nb,
        slice_offset=fb.slice_offset, nonneg_cost=fb.nonneg_cost,
        quad_rdim=fb.quad_rdim, shared_start=fb.shared_start, cost="range",
    ) for fb in graph.nonlinear]
    linear = [dict(
        start=a(lb.start), lam=a(lb.lam), psi=a(lb.psi),
        target_mu=a(lb.target_mu), target_prec=a(lb.target_prec),
        constant=a(lb.constant), nb=lb.nb, slice_offset=lb.slice_offset,
        uniform=lb.uniform, shared_start=lb.shared_start,
    ) for lb in graph.linear]
    state = dict(mu=a(init.mu), prec_diag=a(init.precision.diag),
                 prec_off=a(init.precision.off))
    return dict(num_states=graph.num_states, state_dim=graph.state_dim,
                nonlinear=nonlinear, linear=linear), state


@pytest.fixture(scope="module")
def problems():
    return [build_chain_estimation(num_states=N, dim_x=2, gh_degree=4,
                                   seed=seed)[:2] for seed in range(B)]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_slice_matches_jax(problems, name):
    cfg = CONFIGS[name]
    graph_b, state_b = jax_stack([p[0] for p in problems],
                                 [p[1] for p in problems])
    jcfg = JaxConfig(**cfg)
    jstate, jhist = jax.jit(jax.vmap(
        lambda g, s: jax_optimize(g, s, jcfg)))(graph_b, state_b)

    described = [describe(g, s) for g, s in problems]
    tgraph, tstate = stack_problems(
        [graph_from_arrays(d) for d, _ in described],
        [state_from_arrays(s) for _, s in described],
    )
    state, hist = optimize(tgraph, tstate, GVIConfig(**cfg))

    jcost = np.asarray(jhist.cost)
    assert hist.cost.shape == jcost.shape == (B, cfg["niters"])
    assert np.isfinite(jcost).all()
    np.testing.assert_allclose(hist.cost.numpy(), jcost, rtol=1e-9)
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
    # the problems differ, so per-problem decisions differ too
    assert len({tuple(r) for r in jcost.round(6).tolist()}) == B
    if name == "converging":
        # a failed search after the switch freezes the state
        acc = np.asarray(jhist.accepted_step)
        assert (acc[:, 2:] == 0).any()


@pytest.mark.parametrize("field,value", [
    ("fused_trials", "on"), ("fused_gradient", "on"),
    ("linesearch", "seq"), ("ema_alpha", 0.5),
    ("moments_eval_dtype", "bfloat16"), ("use_pallas", True),
    ("chain_impl", "assoc"),
])
def test_unported_options_raise(problems, field, value):
    g, s = problems[0]
    d, st = describe(g, s)
    with pytest.raises(NotImplementedError):
        optimize(graph_from_arrays(d), state_from_arrays(st),
                 GVIConfig(niters=1, **{field: value}))


@pytest.mark.parametrize("field", ["chain_impl", "quad_impl"])
def test_kernel_impl_on_cpu_raises(problems, field):
    g, s = problems[0]
    d, st = describe(g, s)
    with pytest.raises(ValueError, match="CUDA"):
        optimize(graph_from_arrays(d), state_from_arrays(st),
                 GVIConfig(niters=1, **{field: "lanes"}))


def test_prox_raises(problems):
    g, s = problems[0]
    d, st = describe(g, s)
    with pytest.raises(NotImplementedError):
        optimize(graph_from_arrays(d), state_from_arrays(st), method="prox")


def test_single_problem_matches_batch_of_one(problems):
    """Without a problem axis the loop runs one problem unbatched (JAX's
    unvmapped ``optimize``) with the same result as a batch of one."""
    g, s = problems[1]
    d, st = describe(g, s)
    graph, state = graph_from_arrays(d), state_from_arrays(st)
    cfg = GVIConfig(niters=3, niters_lowtemp=3, step_size_base=0.9)
    one_state, one = optimize(graph, state, cfg)
    batch_state, batch = optimize(*stack_problems([graph], [state]), cfg)
    assert one.cost.shape == (3,) and batch.cost.shape == (1, 3)
    np.testing.assert_array_equal(one.cost.numpy(), batch.cost[0].numpy())
    np.testing.assert_array_equal(one_state.mu.numpy(),
                                  batch_state.mu[0].numpy())
