"""PyTorch port, the kernels at block size s = 6: their plain versions
against the JAX Pallas kernels in interpret mode on chain estimation at
dim_x = 3 (K1 covariance + log det, K2 solve, K3 in both variants on the
69-node (3, 4) marginal rule, K5 trial costs, K6 ``full``), and the whole
loop at dim_x = 3 against ``jax.vmap(optimize)`` on the JAX package's XLA
path, on the plain routes and on the fused kernels' plain versions (CPU,
f64).  The tolerances are the s = 4 tests' (``tests/test_torch_ops.py``,
``test_torch_quad.py``, ``test_torch_fused.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gaussianvi_tpu.examples.chain_estimation import range_cost_lanes  # noqa: E402
from gaussianvi_tpu.inference import GVIConfig as JaxConfig  # noqa: E402
from gaussianvi_tpu.kernels import chain_lanes as jlanes  # noqa: E402
from gaussianvi_tpu.kernels import fused_gradient as jfg  # noqa: E402
from gaussianvi_tpu.kernels import fused_trials as jft  # noqa: E402
from gaussianvi_tpu.kernels.quad_lanes import quad_lanes  # noqa: E402
from gaussianvi_tpu_torch import GVIConfig, optimize  # noqa: E402
from gaussianvi_tpu_torch.inference.engine import fused_operands  # noqa: E402
from gaussianvi_tpu_torch.kernels import chain as tchain  # noqa: E402
from gaussianvi_tpu_torch.kernels import fused_gradient as tfg  # noqa: E402
from gaussianvi_tpu_torch.kernels import fused_trials as tft  # noqa: E402
from gaussianvi_tpu_torch.kernels import quad as tquad  # noqa: E402
from test_torch_fused import (  # noqa: E402
    B,
    _assert_runs_match,
    _assert_same_operands,
    _close,
    _inputs,
    _jax_operands,
    _port,
    _problems,
)
from test_torch_ops import _chain  # noqa: E402

ATOL = 1e-10
N, DIM_X, S = 6, 3, 6


@pytest.fixture(scope="module")
def problems():
    """Three chain estimation problems at dim_x = 3 (s = 6, the 69-node
    (3, 4) marginal rule), JAX-built, and the port's stacked copy."""
    jax_problems = _problems(N, DIM_X, range(B))
    return jax_problems, _port(jax_problems)


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("n", [1, N])
def test_chain_kernels_plain_match_jax_kernels(n):
    """K1 and K2 (both entries) at s = 6: their plain versions against the
    JAX chain kernels in interpret mode, three different problems."""
    diag, off, rhs = _chain(3, n, S, seed=30 + n)
    jcd, jco, jld = map(np.asarray, jlanes.gbp_covariance_logdet_lanes(
        jnp.asarray(diag), jnp.asarray(off), interpret=True))
    tcd, tco, tld = tchain.gbp_covariance_logdet_lanes(_t(diag), _t(off))
    np.testing.assert_allclose(tcd.numpy(), jcd, atol=ATOL)
    np.testing.assert_allclose(tco.numpy(), jco, atol=ATOL)
    np.testing.assert_allclose(tld.numpy(), jld, atol=ATOL)
    jx = np.asarray(jlanes.solve_lanes(jnp.asarray(diag), jnp.asarray(off),
                                       jnp.asarray(rhs), interpret=True))
    np.testing.assert_allclose(
        tchain.solve_lanes(_t(diag), _t(off), _t(rhs)).numpy(), jx,
        atol=ATOL)
    shifted = diag + np.eye(S)
    pair = tchain.solve_pair_lanes(_t(diag), _t(off), _t(shifted), _t(off),
                                   _t(rhs))
    np.testing.assert_allclose(pair[0].numpy(), jx, atol=ATOL)
    jx1 = jlanes.solve_lanes(jnp.asarray(shifted), jnp.asarray(off),
                             jnp.asarray(rhs), interpret=True)
    np.testing.assert_allclose(pair[1].numpy(), np.asarray(jx1), atol=ATOL)
    assert tchain.covers(S, torch.float64) is None


@pytest.mark.parametrize("with_moments", [False, True])
def test_quad_kernel_plain_matches_jax_kernel(problems, with_moments):
    """K3 at d = 6 with the range cost (``RangeCost<3>``, P = 5): its plain
    versions on the packed params against the JAX kernel in interpret
    mode on the range batch's 69-node marginal rule, the lift on."""
    (jax_problems, (graph, _)) = problems
    jfb = jax_problems[0][0].nonlinear[0]
    tfb = graph.nonlinear[0]
    assert tfb.nodes.shape == (69, 6) and tfb.kernel_params.shape == (B, N, 5)
    rng = np.random.default_rng(5)
    mu = rng.standard_normal((B, N, S))
    a = 0.3 * rng.standard_normal((B, N, S, S))
    cov = a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(S)
    leaves = {k: np.stack([np.asarray(p[0].nonlinear[0].params[k])
                           for p in jax_problems]) for k in jfb.params}
    want = quad_lanes(
        jnp.asarray(mu), jnp.asarray(cov), jfb.nodes, jfb.weights,
        range_cost_lanes,
        tuple(jnp.asarray(leaves[k]) for k in sorted(leaves)),
        with_moments=with_moments, interpret=True, nonneg=True,
        rdim=jfb.quad_rdim)
    args = (_t(mu), _t(cov), tfb.nodes, tfb.weights, "range",
            tfb.kernel_params)
    if with_moments:
        got = tquad.quad_lanes_moments(*args, rdim=tfb.quad_rdim)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    else:
        got = tquad.quad_lanes_phi(*args, nonneg=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert tquad.covers("range", 6, 5, 69, torch.float64) is None


def test_trial_costs_plain_matches_jax_kernel(problems):
    """K5's plain version at s = 6 against the JAX kernel (interpret mode),
    three problems, T = 11, as the s = 2 and 4 cases of
    ``tests/test_torch_fused.py`` hold it."""
    jax_problems, (graph, _) = problems
    jops = _jax_operands(jax_problems, JaxConfig(chain_impl="lanes"))
    tops = fused_operands(graph)
    _assert_same_operands(jops, tops)
    x = _inputs(jax_problems, N, S, np.random.default_rng(N))
    ld, fc_nl, fc_lin = jft.trial_costs_lanes(*map(jnp.asarray, x), *jops,
                                               interpret=True)
    t_ld, t_fc = tft.trial_costs_plain(*map(torch.as_tensor, x), *tops)
    assert t_ld.shape == (11, B) and len(t_fc) == 3
    _close(t_ld.numpy(), np.asarray(ld).T)
    _close(t_fc[0].numpy(), np.moveaxis(np.asarray(fc_nl[0]), 1, 0))
    for got, want in zip(t_fc[1:], fc_lin):
        want = np.moveaxis(np.asarray(want), 1, 0)
        _close(got.numpy(), np.where(want < 0, np.nan, want))


def test_gradient_plain_matches_jax_kernel(problems):
    """K6 ``full``'s plain version at s = 6 against the JAX kernel
    (interpret mode): problem 0 at its initial iterate, the others moved,
    per-problem temperatures."""
    jax_problems, (graph, state) = problems
    jops = _jax_operands(jax_problems, JaxConfig(chain_impl="lanes"))
    tops = fused_operands(graph)
    rng = np.random.default_rng(N)
    mu = state.mu.numpy().copy()
    mu[1:] += 0.05 * rng.standard_normal(mu[1:].shape)
    q = rng.standard_normal((B, N, S, S))
    pd = state.precision.diag.numpy() + 0.2 * q @ np.swapaxes(q, -1, -2)
    pd[0] = state.precision.diag[0].numpy()
    po = 0.3 * rng.standard_normal((B, N - 1, S, S))
    po[0] = 0.0
    x = (mu, pd, po, np.array([1.0, 2.0, 10.0]))
    want = jfg.gradient_lanes(*map(jnp.asarray, x), *jops, interpret=True)
    got = tfg.gradient_plain(*map(torch.as_tensor, x), *tops)
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w))
    assert np.isfinite(got[6].numpy()).all()


@pytest.mark.parametrize("path", ["plain", "fused plain versions"])
def test_dim_x3_optimize_matches_jax(path):
    """Chain estimation at dim_x = 3, four problems, 6 iterations: the
    port's ``optimize`` on the CPU (the plain routes, or the fused kernels'
    plain versions) against ``jax.vmap(optimize)`` on the JAX package's
    XLA path, rtol 1e-9 and the same steps."""
    cfg = dict(niters=6, niters_lowtemp=3, step_size_base=0.9)
    jax_problems = _problems(N, DIM_X, range(4))
    jstate, jhist = _jax_run_xla(jax_problems, cfg)
    graph, state0 = _port(jax_problems)
    fused = dict(fused_trials="on", fused_gradient="on")
    state, hist = optimize(graph, state0, GVIConfig(
        **cfg, **(fused if path != "plain" else {})))
    _assert_runs_match(state, hist, jstate, jhist)
    assert len({tuple(r) for r in np.asarray(jhist.cost).round(6)}) == 4


def _jax_run_xla(problems, cfg):
    from gaussianvi_tpu.inference.optimize import optimize as jax_optimize
    from gaussianvi_tpu.parallel.sharding import stack_problems as jax_stack

    graph_b, state_b = jax_stack([p[0] for p in problems],
                                 [p[1] for p in problems])
    jcfg = JaxConfig(**cfg)
    return jax.jit(jax.vmap(lambda g, s: jax_optimize(g, s, jcfg)))(
        graph_b, state_b)


def test_cholesky_beyond_the_unroll_limit_poisons_like_jax():
    """The plain edge covariance at s = 6 inverts 12 x 12 joints, past the
    unrolled algebra: a joint that is not positive definite (a line-search
    trial outside the SPD cone) gives a factor whose lower triangle is
    NaN, as JAX's does, not the partial factor ``cholesky_ex`` leaves; a
    definite one matches."""
    from gaussianvi_tpu.ops import smallmat as jsm
    from gaussianvi_tpu_torch.ops import smallmat as tsm

    rng = np.random.default_rng(12)
    a = rng.standard_normal((3, 12, 12))
    spd = a @ np.swapaxes(a, -1, -2) + 12 * np.eye(12)
    bad = spd.copy()
    bad[1, 7, 7] = -1.0
    want = np.asarray(jsm.chol_small(jnp.asarray(bad)))
    got = tsm.chol_small(_t(bad)).numpy()
    lower = np.tril(np.ones((12, 12), bool))
    assert np.isnan(want[1][lower]).all() and (want[1][~lower] == 0).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want),
                               atol=ATOL)
    inv = tsm.spd_inv_small(_t(bad)).numpy()
    assert np.isnan(inv[1]).all() and np.isfinite(inv[[0, 2]]).all()


def test_block_plans_at_s6():
    """The arenas the s = 6 launches ask for (one warp of two chains for
    K1 / K2 and K5's first pass; K6's problems per block) at the shapes
    the models give them, float32 and float64; the long chains take the
    global scratch."""
    k1 = tchain.gbp_warp_elems(32, 6, 4)
    assert tchain.chains_per_warp(6) == 2
    # both pivot arrays of its two chains, 32 blocks of 37 words each
    assert k1 == 2 * 2 * tchain.slot_pitch(32 * 37, 2, 4)
    assert not tchain.chain_plan(k1, 4).scratch
    assert tchain.chain_plan(tchain.gbp_warp_elems(1100, 6, 8), 8).scratch
    # K5's first pass lays K1's warps over every trial chain at once; the
    # second takes the rules alone
    for n, itemsize, rules in ((20, 4, 25 * 7 * 4), (20, 8, 25 * 7 * 8),
                               (32, 4, 69 * 7 * 4), (32, 8, 69 * 7 * 8)):
        plan = tft.trial_plan("t", n, 6, 11, itemsize, rules)
        assert (plan.warps, plan.chunk, plan.scratch) == (1, 11, False)
        assert plan.arena == tchain.gbp_warp_elems(n, 6, itemsize)
        assert plan.smem == plan.arena * itemsize
    assert tfg.grad_plan("g", 20, 6, 4, 700).warps == 2
    assert tfg.grad_plan("g", 32, 6, 8, 3864).warps == 1
    # every mode of K6 at s = 6, the split pair too (since the factor-
    # parallel path's s = 6 instances); not at s = 8
    for mode in ("full", "accum", "solve"):
        assert tfg.covers(6, (mode,)) is None
        assert "s=8" in tfg.covers(8, (mode,))
