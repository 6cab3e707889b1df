"""PyTorch port, LTV estimation (``factors/priors.py``'s LTV half,
``examples/ltv_estimation.py``) against the JAX package on the CPU (f64):
the integrated transition matrix and Gramian, the priors, the oracle of
``tests/test_ltv_oracle.py`` (scipy's DOP853 at 1e-13), the example's
graph and its NGD and prox runs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gaussianvi_tpu.examples import ltv_estimation as jax_ltv  # noqa: E402
from gaussianvi_tpu.factors import priors as jax_priors  # noqa: E402
from gaussianvi_tpu_torch.examples import (  # noqa: E402
    build_ltv_estimation,
    run_ltv_estimation,
)
from gaussianvi_tpu_torch.examples.ltv_estimation import (  # noqa: E402
    pendulum_ltv_system,
)
from gaussianvi_tpu_torch.factors import priors  # noqa: E402
from gaussianvi_tpu_torch.inference import optimize  # noqa: E402
from gaussianvi_tpu_torch.inference.engine import LocalEngine  # noqa: E402
from test_ltv_oracle import _oracle, _tv_system  # noqa: E402

CPU = torch.device("cpu")
FIELDS = ("lam", "psi", "target_mu", "target_prec", "constant")


def _same_batch(got, want, rtol=1e-12, atol=1e-12):
    np.testing.assert_array_equal(got.start.numpy(), np.asarray(want.start))
    assert (got.nb, got.slice_offset, got.uniform) == (
        want.nb, want.slice_offset, want.uniform)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=rtol,
                                   atol=atol, err_msg=f)


@pytest.mark.parametrize("nsteps", [200, 199, 16])
def test_transition_and_gramian_match_jax(nsteps):
    """A genuinely time-varying segment (a different random A on every
    sub-interval), the JAX package's own matrices to 1e-12."""
    a_seg, b_seg = _tv_system(seed=nsteps)
    phi, q = priors.ltv_transition_and_gramian(a_seg, b_seg, 0.37, nsteps)
    jphi, jq = jax_priors.ltv_transition_and_gramian(a_seg, b_seg, 0.37,
                                                     nsteps)
    np.testing.assert_allclose(phi, np.asarray(jphi), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(q, np.asarray(jq), rtol=1e-12, atol=1e-12)


def test_transition_and_gramian_match_the_adaptive_oracle():
    """``tests/test_ltv_oracle.py``: RK4 at 200 steps against DOP853 at
    1e-13, 1e-10."""
    a_seg, b_seg = _tv_system(seed=0)
    phi_o, q_o = _oracle(a_seg, b_seg, 0.37)
    phi, q = priors.ltv_transition_and_gramian(a_seg, b_seg, 0.37, 200)
    np.testing.assert_allclose(phi, phi_o, atol=1e-10)
    np.testing.assert_allclose(q, q_o, atol=1e-10)


def test_priors_match_jax():
    """``ltv_prior`` on the pendulum's schedule and
    ``minimum_acc_prior_integral`` (which meets the closed form
    ``minimum_acc_prior`` to 1e-9), against the JAX package's."""
    n, dt = 10, 0.2
    theta = 0.5 + 0.1 * np.arange(n) * dt
    means = [np.array([t, 0.1]) for t in theta]
    a_list, b_list = pendulum_ltv_system(n, dt, theta)
    ja, jb = jax_ltv.pendulum_ltv_system(n, dt, theta)
    for x, y in zip(a_list + b_list, ja + jb):
        np.testing.assert_array_equal(x, y)
    _same_batch(priors.ltv_prior(a_list, b_list, means, dt, n, device=CPU),
                jax_priors.ltv_prior(a_list, b_list, means, dt, n))
    qc = np.array([[1.0, 0.2], [0.2, 0.5]])
    integ = priors.minimum_acc_prior_integral(qc, 0.1, 6, device=CPU)
    _same_batch(integ, jax_priors.minimum_acc_prior_integral(qc, 0.1, 6))
    closed = priors.minimum_acc_prior(qc, 0.1, 6, device=CPU)
    np.testing.assert_allclose(integ.lam.numpy(), closed.lam.numpy(),
                               atol=1e-9)
    np.testing.assert_allclose(integ.target_prec.numpy(),
                               closed.target_prec.numpy(), rtol=1e-9)


def test_example_graph_matches_jax():
    """``build_ltv_estimation``: the JAX builder's arrays, bit for bit on
    the measurement batch, to 1e-12 on the integrated prior; the batch is
    ``cost_fn``-only in both packages, so on the card ``"auto"`` takes
    K1 / K2 at s = 2 and the plain quadrature, the JAX package's route."""
    graph, init, config = build_ltv_estimation(device=CPU)
    jgraph, jinit, jconfig = jax_ltv.build_ltv_estimation()
    assert (config.niters, config.step_size_base) == (
        jconfig.niters, jconfig.step_size_base)
    fb, jfb = graph.nonlinear[0], jgraph.nonlinear[0]
    assert fb.kernel_cost is None and jfb.lanes_cost is None
    np.testing.assert_array_equal(fb.nodes.numpy(), np.asarray(jfb.nodes))
    for k, v in fb.params.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jfb.params[k]))
    for got, want in zip(graph.linear, jgraph.linear):
        _same_batch(got, want)
    np.testing.assert_array_equal(init.mu.numpy(), np.asarray(jinit.mu))
    eng = LocalEngine(graph, config, torch.device("cuda"))
    assert (eng.chain_impl, eng.quad_batches, eng.fused_trials_ready,
            eng.fused_gradient_ready) == ("lanes", (False,), False, False)


@pytest.mark.parametrize("method", ["ngd", "prox"])
def test_run_matches_jax(method):
    """The example's run (N = 10, 15 iterations) against the JAX
    package's, f64: the golden-run class of agreement (1e-11 on the costs,
    the same accepted steps)."""
    final, hist = run_ltv_estimation(method, device=CPU)
    jfinal, jhist = jax_ltv.run_ltv_estimation(method)
    np.testing.assert_allclose(hist.cost.numpy(), np.asarray(jhist.cost),
                               rtol=1e-11)
    np.testing.assert_array_equal(hist.accepted_step.numpy(),
                                  np.asarray(jhist.accepted_step))
    np.testing.assert_allclose(final.mu.numpy(), np.asarray(jfinal.mu),
                               atol=1e-11)
    cost = hist.cost.numpy()
    assert np.isfinite(cost).all()
    # prox at the example's step base 0.9 rejects every trial, in the JAX
    # package too (as on the flagship); NGD descends
    assert cost[-1] < cost[0] if method == "ngd" else (cost == cost[0]).all()
    w = np.linalg.eigvalsh(final.precision.to_dense().numpy())
    assert w.min() > 0


def test_float32_escalates_before_float64():
    """In float32 the search fails, and the temperature escalates, several
    iterations before float64's does (as in the JAX package with x64 off):
    the records agree until then and the final means to 1e-5."""
    s64, h64 = run_ltv_estimation(device=CPU)
    s32, h32 = optimize(*build_ltv_estimation(dtype=torch.float32,
                                              device=CPU))
    fail32 = (h32.accepted_step == 0).nonzero().flatten().tolist()
    assert fail32 and (h64.accepted_step > 0).all()
    k = fail32[0]
    np.testing.assert_allclose(h32.cost[:k].double().numpy(),
                               h64.cost[:k].numpy(), rtol=1e-5)
    np.testing.assert_allclose(s32.mu.double().numpy(), s64.mu.numpy(),
                               atol=1e-5)


def test_fused_residual_form_covers_the_general_psi():
    """The LTV prior's Psi = [Phi, -I] is not the minimum-acceleration
    structure: the fused kernels' residual form (``linear_residual_form``,
    pm = Psi mu_t) covers it.  With the measurement batch given the range
    functor (a 1-D beacon on a 2-D state: d = 2, P = 3), both fused
    kernels (their plain versions here) follow the separate path."""
    from dataclasses import replace

    from gaussianvi_tpu_torch.factors.base import pack_params
    from gaussianvi_tpu_torch.inference import GVIConfig
    from gaussianvi_tpu_torch.inference.engine import fused_operands

    graph, init, config = build_ltv_estimation(device=CPU)
    fb = graph.nonlinear[0]
    graph = replace(graph, nonlinear=(replace(
        fb, kernel_cost="range", kernel_params=pack_params(fb.params)),))
    assert not isinstance(fused_operands(graph), str)
    cfg = GVIConfig(niters=6, niters_lowtemp=6, step_size_base=0.9)
    ref_state, ref = optimize(graph, init, cfg)
    state, hist = optimize(graph, init, GVIConfig(
        niters=6, niters_lowtemp=6, step_size_base=0.9, fused_trials="on",
        fused_gradient="on"))
    np.testing.assert_allclose(hist.cost.numpy(), ref.cost.numpy(),
                               rtol=1e-10)
    np.testing.assert_array_equal(hist.accepted_step.numpy(),
                                  ref.accepted_step.numpy())
    np.testing.assert_allclose(state.mu.numpy(), ref_state.mu.numpy(),
                               atol=1e-10)
    assert config.niters == 15
