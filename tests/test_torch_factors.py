"""PyTorch port, factors and graph plumbing against the JAX package (CPU,
f64): priors, the flagship builder's arrays, linear costs and gradients,
NGD local gradients, gather/scatter, and problem stacking."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gaussianvi_tpu.examples import chain_estimation as jce  # noqa: E402
from gaussianvi_tpu.factors import moments as jmm  # noqa: E402
from gaussianvi_tpu.factors import priors as jpr  # noqa: E402
from gaussianvi_tpu.inference import graph as jgraph  # noqa: E402
from gaussianvi_tpu.ops.blocktridiag import BlockTridiag as JBT  # noqa: E402
from gaussianvi_tpu_torch import stack_problems  # noqa: E402
from gaussianvi_tpu_torch.examples import chain_estimation as tce  # noqa: E402
from gaussianvi_tpu_torch.factors import moments as tmm  # noqa: E402
from gaussianvi_tpu_torch.factors import priors as tpr  # noqa: E402
from gaussianvi_tpu_torch.inference import graph as tgraph  # noqa: E402
from gaussianvi_tpu_torch.ops.blocktridiag import BlockTridiag  # noqa: E402

ATOL = 1e-10
_LIN = ("lam", "psi", "target_mu", "target_prec", "constant")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_prior_matrices_match_jax():
    qc = np.array([[2.0, 0.3], [0.3, 1.0]])
    np.testing.assert_array_equal(tpr.min_acc_q(qc, 0.1), jpr.min_acc_q(qc, 0.1))
    np.testing.assert_array_equal(tpr.min_acc_q_inv(qc, 0.1),
                                  jpr.min_acc_q_inv(qc, 0.1))
    for jb, tb in [
        (jpr.fixed_prior(2, [1.0, 2.0], 0.5 * np.eye(2)),
         tpr.fixed_prior(2, [1.0, 2.0], 0.5 * np.eye(2))),
        (jpr.minimum_acc_prior(qc, 0.1, 5), tpr.minimum_acc_prior(qc, 0.1, 5)),
    ]:
        for name in ("start", *_LIN):
            np.testing.assert_array_equal(_np(getattr(tb, name)),
                                          _np(getattr(jb, name)))
        assert (tb.nb, tb.slice_offset, tb.uniform) == (
            jb.nb, jb.slice_offset, jb.uniform)


@pytest.mark.parametrize("dim_x,degree,marginal", [(2, 4, True), (1, 3, False)])
def test_build_chain_estimation_same_arrays(dim_x, degree, marginal):
    kw = dict(num_states=6, dim_x=dim_x, gh_degree=degree, seed=3,
              marginal_quad=marginal)
    jg, jinit, jcfg = jce.build_chain_estimation(**kw)
    tg, tinit, tcfg = tce.build_chain_estimation(**kw)
    jfb, tfb = jg.nonlinear[0], tg.nonlinear[0]
    for name in ("start", "nodes", "weights"):
        np.testing.assert_array_equal(_np(getattr(tfb, name)),
                                      _np(getattr(jfb, name)))
    for name, leaf in jfb.params.items():
        np.testing.assert_array_equal(_np(tfb.params[name]), _np(leaf))
    packed = np.concatenate([np.asarray(l).reshape(6, -1)
                             for l in jax.tree.leaves(jfb.params)], axis=-1)
    np.testing.assert_array_equal(_np(tfb.kernel_params), packed)
    assert (tfb.nb, tfb.slice_offset, tfb.quad_rdim, tfb.nonneg_cost) == (
        jfb.nb, jfb.slice_offset, jfb.quad_rdim, jfb.nonneg_cost)
    assert tfb.kernel_cost == "range"
    for jlb, tlb in zip(jg.linear, tg.linear):
        for name in ("start", *_LIN):
            np.testing.assert_array_equal(_np(getattr(tlb, name)),
                                          _np(getattr(jlb, name)))
        assert (tlb.nb, tlb.slice_offset, tlb.uniform) == (
            jlb.nb, jlb.slice_offset, jlb.uniform)
    np.testing.assert_array_equal(_np(tinit.mu), _np(jinit.mu))
    np.testing.assert_array_equal(_np(tinit.precision.diag),
                                  _np(jinit.precision.diag))
    np.testing.assert_array_equal(_np(tinit.precision.off),
                                  _np(jinit.precision.off))
    assert tcfg == type(tcfg)(**vars(jcfg))


def _edge_problem(seed):
    """A stacked 2-problem GP batch with different chain blocks."""
    rng = np.random.default_rng(seed)
    n, s = 5, 2
    mu = rng.standard_normal((2, n, s))
    a = rng.standard_normal((2, n, s, s)) * 0.2
    cd = a @ np.swapaxes(a, -1, -2) + np.eye(s)
    co = 0.1 * rng.standard_normal((2, n - 1, s, s))
    return mu, cd, co


def test_linear_costs_and_gradients_match_jax():
    qc = np.eye(1)
    jlb = jpr.minimum_acc_prior(qc, 0.1, 5)
    tlb = tpr.minimum_acc_prior(qc, 0.1, 5)
    mu, cd, co = _edge_problem(0)
    temps = np.array([1.0, 10.0])

    def jax_one(m, c_d, c_o, t):
        cost = jmm.batch_linear_cost(jlb, m, c_d, c_o)
        dense = jmm.batch_linear_cost(jlb, m, c_d, c_o, blockwise=False)
        mu_k, _ = jgraph.gather_marginals(jlb.start, 2, m, c_d, c_o,
                                          jlb.slice_offset)
        g = jmm.linear_local_gradients(jlb.lam, jlb.psi, jlb.target_mu,
                                       jlb.target_prec, jlb.constant, mu_k, t)
        return cost, dense, *g

    want = jax.vmap(jax_one)(*map(jnp.asarray, (mu, cd, co, temps)))
    tlb_b = stack_problems(
        [tgraph.FactorGraph(5, 2, (), (tlb,))] * 2,
        [tgraph.GaussianState(torch.zeros(5, 2),
                              BlockTridiag.zeros((), 5, 2, torch.float64))] * 2,
    )[0].linear[0]
    mu_t, cd_t, co_t = map(torch.as_tensor, (mu, cd, co))
    cost = tmm.batch_linear_cost(tlb_b, mu_t, cd_t, co_t)
    mu_k, cov_k = tgraph.gather_marginals(tlb_b.start, 2, mu_t, cd_t, co_t,
                                          tlb_b.slice_offset)
    dense = tmm.linear_cost(tlb_b.lam, tlb_b.psi, tlb_b.target_mu,
                            tlb_b.target_prec, tlb_b.constant, mu_k, cov_k)
    grads = tmm.linear_local_gradients(
        tlb_b.lam, tlb_b.psi, tlb_b.target_mu, tlb_b.target_prec,
        tlb_b.constant, mu_k, torch.as_tensor(temps))
    for g, w in zip((cost, dense, *grads), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_linear_cost_guard_poisons_negative():
    cost = tmm.guard_linear_cost(torch.tensor([1.0, -1e-9, 0.0]))
    assert torch.isnan(cost[1]) and cost[0] == 1.0 and cost[2] == 0.0


def test_ngd_local_gradients_match_jax():
    rng = np.random.default_rng(1)
    b, k, d = 2, 3, 4
    a = rng.standard_normal((b, k, d, d))
    cov = a @ np.swapaxes(a, -1, -2) + np.eye(d)
    e_phi = rng.standard_normal((b, k))
    e_xmu = rng.standard_normal((b, k, d))
    e_xxt = rng.standard_normal((b, k, d, d))
    temps = np.array([1.0, 10.0])
    want = jax.vmap(jmm.ngd_local_gradients)(
        *map(jnp.asarray, (e_phi, e_xmu, e_xxt, cov, temps)))
    got = tmm.ngd_local_gradients(*map(torch.as_tensor,
                                       (e_phi, e_xmu, e_xxt, cov, temps)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("nb", [1, 2])
@pytest.mark.parametrize("starts", ["slice", "shared", "per_problem"])
def test_gather_scatter_match_jax(nb, starts):
    """Slices, shared index lists and per-problem index lists (problems
    stacked with different supports) all agree with JAX per problem."""
    n, s, k = 6, 2, 3
    start_sets = {
        "slice": [np.arange(1, 1 + k)] * 2,
        "shared": [np.array([0, 3, 3])] * 2,
        "per_problem": [np.array([0, 2, 4]), np.array([1, 1, 3])],
    }[starts]
    rng = np.random.default_rng(nb)
    mu, cd, co = (rng.standard_normal((2, n, s)),
                  rng.standard_normal((2, n, s, s)),
                  rng.standard_normal((2, n - 1, s, s)))
    vdmu = rng.standard_normal((2, k, nb * s))
    vddmu = rng.standard_normal((2, k, nb * s, nb * s))
    offset = 1 if starts == "slice" else None
    if starts == "per_problem":
        start_t = torch.as_tensor(np.stack(start_sets))
    else:
        start_t = torch.as_tensor(start_sets[0])
    got_m = tgraph.gather_marginals(start_t, nb, *map(torch.as_tensor,
                                                      (mu, cd, co)), offset)
    gmu = torch.zeros(2, n, s, dtype=torch.float64)
    gprec = BlockTridiag.zeros((2,), n, s, torch.float64)
    tgraph.scatter_gradients(start_t, nb, torch.as_tensor(vdmu),
                             torch.as_tensor(vddmu), gmu, gprec, offset)
    for i in range(2):
        st = jnp.asarray(start_sets[i])
        wm = jgraph.gather_marginals(st, nb, mu[i], cd[i], co[i], offset)
        for g, w in zip(got_m, wm):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(w), atol=0)
        wmu, wprec = jgraph.scatter_gradients(
            st, nb, jnp.asarray(vdmu[i]), jnp.asarray(vddmu[i]),
            jnp.zeros((n, s)), JBT.zeros(n, s), offset)
        np.testing.assert_allclose(gmu[i].numpy(), np.asarray(wmu), atol=1e-14)
        np.testing.assert_allclose(gprec.diag[i].numpy(),
                                   np.asarray(wprec.diag), atol=1e-14)
        np.testing.assert_allclose(gprec.off[i].numpy(),
                                   np.asarray(wprec.off), atol=1e-14)


def test_stack_problems_aligns_metadata():
    g1, s1, _ = tce.build_chain_estimation(num_states=4, seed=0)
    g2, s2, _ = tce.build_chain_estimation(num_states=4, seed=1)
    gb, sb = stack_problems([g1, g2], [s1, s2])
    fb = gb.nonlinear[0]
    assert fb.start.shape == (4,) and fb.slice_offset == 0 and fb.shared_start
    assert fb.kernel_params.shape == (2, 4, 3)
    assert fb.params["r"].shape == (2, 4)
    assert gb.linear[1].lam.shape == (2, 3, 2, 4) and gb.linear[1].uniform
    assert sb.mu.shape == (2, 4, 2) and sb.precision.off.shape == (2, 3, 2, 2)
    g3, s3, _ = tce.build_chain_estimation(num_states=4, gh_degree=3)
    with pytest.raises(ValueError, match="nodes"):
        stack_problems([g1, g3], [s1, s3])


def test_factor_costs_and_ngd_gradients_match_jax():
    """gvi.factor_costs / gvi.ngd_gradients on two stacked flagship
    problems at their initial marginals, per-problem temperatures."""
    from gaussianvi_tpu.inference import gvi as jgvi
    from gaussianvi_tpu.ops.blocktridiag import gbp_covariance_logdet
    from gaussianvi_tpu.parallel.sharding import stack_problems as jstack
    from gaussianvi_tpu_torch.inference import gvi as tgvi
    from gaussianvi_tpu_torch.ops.blocktridiag import (
        gbp_covariance_logdet as tgbp,
    )

    kw = dict(num_states=6, dim_x=2, gh_degree=4)
    jp = [jce.build_chain_estimation(seed=s, **kw)[:2] for s in (0, 1)]
    tp = [tce.build_chain_estimation(seed=s, **kw)[:2] for s in (0, 1)]
    jg, js = jstack(*map(list, zip(*jp)))
    tg, ts = stack_problems(*map(list, zip(*tp)))
    temps = np.array([1.0, 10.0])

    def one(g, s, t):
        cd, co, _ = gbp_covariance_logdet(s.precision)
        return (jgvi.factor_costs(g, s.mu, cd, co, t),
                *jgvi.ngd_gradients(g, s.mu, cd, co, t))

    jfc, jvd, jvdd = jax.vmap(one)(jg, js, jnp.asarray(temps))
    cd, co, _ = tgbp(ts.precision)
    t = torch.as_tensor(temps)
    fc = tgvi.factor_costs(tg, ts.mu, cd, co, t)
    vd, vdd = tgvi.ngd_gradients(tg, ts.mu, cd, co, t)
    np.testing.assert_allclose(fc.numpy(), np.asarray(jfc), rtol=1e-12)
    np.testing.assert_allclose(vd.numpy(), np.asarray(jvd), atol=ATOL)
    np.testing.assert_allclose(vdd.diag.numpy(), np.asarray(jvdd.diag),
                               atol=1e-8, rtol=1e-12)
    np.testing.assert_allclose(vdd.off.numpy(), np.asarray(jvdd.off),
                               atol=1e-8, rtol=1e-12)
