"""PyTorch port, the planar planner (``examples/planar_planning.py``) end
to end against the JAX package (CPU, f64): restarts of one problem under
``optimize`` on the plain routes and on the fused kernels' plain versions
(the ``"planar_sdf"`` cost form) against ``jax.vmap(optimize)``; the
converged plan clears the obstacle as ``tests/test_planning.py`` asks of
the JAX package; the field survives batching and sharding."""

from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gaussianvi_tpu.examples.planar_planning import (  # noqa: E402
    build_planar_planning as jax_build,
)
from gaussianvi_tpu.inference.graph import GaussianState as JaxState  # noqa: E402
from gaussianvi_tpu.inference.optimize import optimize as jax_optimize  # noqa: E402
from gaussianvi_tpu.ops import BlockTridiag as JaxBlockTridiag  # noqa: E402
from gaussianvi_tpu_torch import optimize, stack_problems  # noqa: E402
from gaussianvi_tpu_torch.examples.planar_planning import (  # noqa: E402
    build_planar_planning,
    run_planar_planning,
)
from gaussianvi_tpu_torch.inference.engine import (  # noqa: E402
    LocalEngine,
    fused_operands,
)
from gaussianvi_tpu_torch.inference.graph import GaussianState  # noqa: E402
from gaussianvi_tpu_torch.ops.blocktridiag import BlockTridiag  # noqa: E402
from gaussianvi_tpu_torch.parallel import (  # noqa: E402
    optimize_restarts,
    perturb_inits,
    shard_graph,
)

CPU = torch.device("cpu")
N, R, NITERS = 8, 4, 6
# the planner's config, shortened: the scheduled switch to the high
# temperature falls inside the run
SHORT = dict(niters=NITERS, niters_lowtemp=4)
PATHS = {
    "plain": {},
    # the fused kernels' plain versions (K5, K6) with the planar cost form
    "fused plain versions": dict(fused_trials="on", fused_gradient="on"),
}


def _restart_means(seed=0):
    """R initial means around the straight line, restart 0 on it."""
    rng = np.random.default_rng(seed)
    noise = 0.3 * rng.standard_normal((R, N, 4))
    noise[0] = 0.0
    return noise


@pytest.fixture(scope="module")
def jax_run():
    graph, init, config, _ = jax_build(num_states=N, dtype=jnp.float64)
    cfg = replace(config, **SHORT)
    mu = np.asarray(init.mu)[None] + _restart_means()
    prec = init.precision
    states = JaxState(jnp.asarray(mu), JaxBlockTridiag(
        jnp.broadcast_to(prec.diag, (R, *prec.diag.shape)),
        jnp.broadcast_to(prec.off, (R, *prec.off.shape))))
    return jax.jit(jax.vmap(lambda s: jax_optimize(graph, s, cfg)))(states)


def _port_restarts(**build):
    graph, init, config, sdf = build_planar_planning(num_states=N,
                                                     device=CPU, **build)
    mu = init.mu[None] + torch.as_tensor(_restart_means())
    prec = init.precision
    states = GaussianState(mu, BlockTridiag(
        prec.diag.expand(R, *prec.diag.shape).clone(),
        prec.off.expand(R, *prec.off.shape).clone()))
    return graph, states, replace(config, **SHORT)


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("interp", ["auto", "matmul"])
def test_planner_restarts_match_jax(jax_run, path, interp):
    """Four restarts of the N = 8 planner, 6 iterations: relative cost
    within 1e-9 of ``jax.vmap(optimize)`` and identical accepted steps, on
    every route the CPU runs (the kernel cost's plain form on the fused
    path; ``interp="matmul"`` is a cost_fn-only batch, which the fused
    kernels do not take)."""
    jstate, jhist = jax_run
    graph, states, cfg = _port_restarts(interp=interp)
    if interp == "matmul" and path != "plain":
        with pytest.raises(ValueError, match="kernel_cost"):
            optimize(graph, states, replace(cfg, **PATHS[path]))
        return
    state, hist = optimize(graph, states, replace(cfg, **PATHS[path]))
    jcost = np.asarray(jhist.cost)
    assert hist.cost.shape == jcost.shape == (R, NITERS)
    assert np.isfinite(jcost).all()
    np.testing.assert_allclose(hist.cost.numpy(), jcost, rtol=1e-9)
    np.testing.assert_array_equal(hist.accepted_step.numpy(),
                                  np.asarray(jhist.accepted_step))
    np.testing.assert_allclose(hist.factor_costs.numpy(),
                               np.asarray(jhist.factor_costs), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(state.mu.numpy(), np.asarray(jstate.mu),
                               atol=1e-9)
    # the restarts took different steps, and some factors were clear
    # (E[phi] exactly 0) while others touched the obstacle
    assert len({tuple(r) for r in jcost.round(6).tolist()}) == R
    fc = hist.factor_costs.numpy()[..., :N]
    assert (fc == 0).any() and (fc > 0).any()


def test_trajectory_avoids_obstacle():
    """``tests/test_planning.py`` on the port's plain route: N = 20, the
    planner's 30 iterations; the straight-line start collides, the plan
    clears the obstacle with its endpoints anchored."""
    final, hist, sdf = run_planar_planning(num_states=20, device=CPU)
    pos = final.mu[:, :2]
    assert sdf.signed_distance(pos).min() > 0.0
    np.testing.assert_allclose(pos[0].numpy(), [1.0, 1.0], atol=0.05)
    np.testing.assert_allclose(pos[-1].numpy(), [8.5, 8.5], atol=0.05)
    cost = hist.cost.numpy()
    assert cost[-1] < cost[0] / 10


def test_restarts_pick_a_clear_plan():
    """``parallel.optimize_restarts`` on the planner (perturbed inits, one
    batched run): the best restart clears the obstacle."""
    graph, init, config, sdf = build_planar_planning(num_states=12,
                                                     device=CPU)
    gen = torch.Generator().manual_seed(0)
    best, best_cost, costs = optimize_restarts(
        graph, init, gen, num_restarts=4,
        config=replace(config, niters=15, niters_lowtemp=10),
        mean_scale=0.3)
    assert costs.shape == (4,) and torch.isfinite(costs).all()
    assert best_cost == costs.min()
    assert sdf.signed_distance(best.mu[:, :2]).min() > 0.0
    inits = perturb_inits(init, torch.Generator().manual_seed(0), 4, 0.3)
    assert torch.equal(inits.mu[0], init.mu)


def _problems(count):
    """``count`` problems on one planner graph (its cost closure is what
    makes two separately built graphs different problems, as in the JAX
    package), their means jittered."""
    graph, init, _, _ = build_planar_planning(num_states=N, device=CPU)
    rng = np.random.default_rng(0)
    return [(graph, GaussianState(init.mu + 0.1 * torch.as_tensor(
        rng.standard_normal(init.mu.shape)), init.precision))
        for _ in range(count)]


def test_stack_problems_keeps_the_field():
    """Stacked planner problems share one field, as they share the rule;
    problems with different fields do not stack."""
    problems = _problems(3)
    graph, state = stack_problems(*map(list, zip(*problems)))
    fb = graph.nonlinear[0]
    assert fb.kernel_field is problems[0][0].nonlinear[0].kernel_field
    assert fb.kernel_params.shape == (3, N, 7)
    assert state.mu.shape == (3, N, 4)
    ops = fused_operands(graph)
    assert ops[2][0][4] is fb.kernel_field
    other = problems[1][0]
    moved = replace(other, nonlinear=(replace(
        other.nonlinear[0], kernel_field=fb.kernel_field + 1.0),))
    with pytest.raises(ValueError, match="kernel_field differ"):
        stack_problems([problems[0][0], moved], [problems[0][1],
                                                 problems[1][1]])


@pytest.mark.parametrize("fp", [1, 2, 4])
def test_shard_graph_gives_every_shard_the_field(fp):
    """Every fp rank's shard of the obstacle batch holds its factors'
    params and the whole field; the shards' costs are the whole batch's."""
    graph, state = stack_problems(*map(list, zip(*_problems(2))))
    whole = LocalEngine(graph, replace(build_planar_planning(
        num_states=N, device=CPU)[2]), CPU)
    cd = (0.05 * torch.eye(4, dtype=torch.float64)).expand(2, N, 4, 4)
    co = torch.zeros(2, N - 1, 4, 4, dtype=torch.float64)
    want = whole.factor_costs_raw(state.mu, cd, co)[0]
    parts = []
    for i in range(fp):
        mesh = SimpleNamespace(dp=1, fp=fp, dp_index=0, fp_index=i)
        shard = shard_graph(graph, mesh).nonlinear[0]
        assert shard.kernel_field is graph.nonlinear[0].kernel_field
        assert shard.kernel_params.shape == (2, N // fp, 7)
        assert shard.num_factors == N // fp
        eng = LocalEngine(replace(graph, nonlinear=(shard,)),
                          build_planar_planning(num_states=N,
                                                device=CPU)[2], CPU)
        parts.append(eng.factor_costs_raw(state.mu, cd, co)[0])
    got = torch.cat(parts, -1)
    # a shard gathers its marginals by index, the whole batch by a slice:
    # the same values up to rounding, and the clear factors' exact zeros
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-13, atol=0)
    assert torch.equal(got == 0, want == 0) and (want == 0).any()


def test_packed_operands_carry_the_field():
    """``factor_args`` hands K5 / K6 the planner batch's field in place:
    its pointer, rows, columns and depth (1) in the batch's slots
    (``csrc/fused.cuh`` ``parse_factors``), the packed params row by row,
    the planar cost's id and param count."""
    import ctypes

    from gaussianvi_tpu_torch.kernels import fused_trials as tft
    from gaussianvi_tpu_torch.kernels.quad import KERNEL_COSTS

    graph, state = stack_problems(*map(list, zip(*_problems(2))))
    fb = graph.nonlinear[0]
    ops = fused_operands(graph)
    fa = tft.factor_args("t", state.mu, *ops, rows=3 * 2)
    assert (fa.cost, fa.n_params) == (KERNEL_COSTS["planar_sdf"][0], 7)
    p_field = fa.nl_ptrs[5]
    k, m, nonneg, rdim, rows, cols, depth, quant = fa.nl_ints[:tft.NL_INTS]
    assert (k, m, nonneg, rdim, rows, cols, depth, quant) == (
        N, 13, 1, 2, 100, 100, 1, 0)
    assert p_field == fb.kernel_field.data_ptr()
    back = np.ctypeslib.as_array(
        (ctypes.c_double * (rows * cols)).from_address(p_field))
    np.testing.assert_array_equal(back.reshape(rows, cols),
                                  fb.kernel_field.numpy())
    par = np.ctypeslib.as_array(
        (ctypes.c_double * (2 * N * 7)).from_address(fa.nl_ptrs[2]))
    np.testing.assert_array_equal(par.reshape(2, N, 7),
                                  fb.kernel_params.numpy())
    # a batch whose field is missing is refused before any launch
    bare = ((*ops[2][0][:4],),)
    with pytest.raises(ValueError, match="carries none"):
        tft.factor_args("t", state.mu, ops[0], ops[1], bare, ops[3])



def test_float32_takes_other_steps_in_both_packages():
    """The planner's nominal problem (N = 20, 30 iterations) in float32
    against float64, in the JAX package and on the port's plain route: the
    first record agrees within 1e-4 and the final cost within 1e-3, but
    both float32 runs take another line-search step than float64 at
    iteration 6 and their histories part by more than 0.1 before they meet
    again.  A property of the problem, not of a route: ``chip_smoke.py``
    holds the card's restart 0 to its final cost, not to its history."""
    runs = {}
    for name, dt in (("f64", jnp.float64), ("f32", jnp.float32)):
        graph, init, cfg, _ = jax_build(dtype=dt)
        runs["jax", name] = jax.jit(lambda s: jax_optimize(graph, s, cfg))(
            init)[1]
    for name, dt in (("f64", torch.float64), ("f32", torch.float32)):
        runs["port", name] = run_planar_planning(dtype=dt, device=CPU)[1]
    for pkg in ("jax", "port"):
        lo, hi = runs[pkg, "f32"], runs[pkg, "f64"]
        c32 = np.asarray(lo.cost, np.float64)
        c64 = np.asarray(hi.cost)
        rel = np.abs(c32 - c64) / np.abs(c64)
        assert rel[0] < 1e-4 and rel[-1] < 1e-3, (pkg, rel)
        assert rel.max() > 0.1, (pkg, rel)
        # the steps (trial sizes, rounded to each dtype) agree up to 6
        steps32 = np.asarray(lo.accepted_step, np.float64)
        steps64 = np.asarray(hi.accepted_step)
        np.testing.assert_allclose(steps32[:6], steps64[:6], rtol=1e-6)
        assert abs(steps32[6] - steps64[6]) > 0.1, pkg
