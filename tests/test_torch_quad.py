"""PyTorch port, quadrature: moments, guarded E[phi] and the quadrature
kernel's plain versions against the JAX package (CPU, f64 unless a guard
needs f32).  The JAX kernel runs in Pallas interpret mode."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gaussianvi_tpu.examples.chain_estimation import (  # noqa: E402
    build_chain_estimation as jax_build,
    range_cost_lanes,
)
from gaussianvi_tpu.factors import moments as jmm  # noqa: E402
from gaussianvi_tpu.kernels.quad_lanes import quad_lanes  # noqa: E402
from gaussianvi_tpu_torch.examples.chain_estimation import (  # noqa: E402
    build_chain_estimation as torch_build,
)
from gaussianvi_tpu_torch.factors import moments as tmm  # noqa: E402
from gaussianvi_tpu_torch.kernels import quad as tquad  # noqa: E402

ATOL = 1e-10


@pytest.fixture(scope="module")
def problem():
    """The flagship's range batch (29-node marginal rule, d=4) and B=3
    different sets of marginals and params."""
    jfb = jax_build(num_states=8, dim_x=2, gh_degree=4, seed=0)[0].nonlinear[0]
    tfb = torch_build(num_states=8, dim_x=2, gh_degree=4, seed=0)[0].nonlinear[0]
    rng = np.random.default_rng(0)
    b, k, d = 3, 8, 4
    mu = rng.standard_normal((b, k, d))
    a = rng.standard_normal((b, k, d, d)) * 0.3
    cov = a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(d)
    leaves = {name: np.stack([np.asarray(v) * (1 + 0.1 * i) for i in range(b)])
              for name, v in jfb.params.items()}
    return jfb, tfb, mu, cov, leaves


def _jax_moments(jfb, mu, cov, leaves, phi_only=False):
    def one(m, c, p):
        if phi_only:
            return jmm.expectation_phi(jfb.nodes, jfb.weights, m, c,
                                       jfb.cost_fn, p, nonneg=True)
        return jmm.gh_moments(jfb.nodes, jfb.weights, m, c, jfb.cost_fn, p,
                              rdim=jfb.quad_rdim)

    out = jax.vmap(one)(jnp.asarray(mu), jnp.asarray(cov),
                        {k: jnp.asarray(v) for k, v in leaves.items()})
    return [np.asarray(o) for o in (out if not phi_only else (out,))]


def _torch_params(leaves):
    return {k: torch.as_tensor(v) for k, v in leaves.items()}


def test_gh_moments_rdim_lift_matches_jax(problem):
    jfb, tfb, mu, cov, leaves = problem
    assert tfb.quad_rdim == jfb.quad_rdim == 2
    want = _jax_moments(jfb, mu, cov, leaves)
    got = tmm.gh_moments(tfb.nodes, tfb.weights, torch.as_tensor(mu),
                         torch.as_tensor(cov), tfb.cost_fn,
                         _torch_params(leaves), rdim=tfb.quad_rdim)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL)


def test_expectation_phi_matches_jax(problem):
    jfb, tfb, mu, cov, leaves = problem
    (want,) = _jax_moments(jfb, mu, cov, leaves, phi_only=True)
    got = tmm.expectation_phi(tfb.nodes, tfb.weights, torch.as_tensor(mu),
                              torch.as_tensor(cov), tfb.cost_fn,
                              _torch_params(leaves), nonneg=True)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


# tot = -1e-4 against sum|w phi| ~ 2: inside the nonneg rounding band
# (poisoned only under the contract); tot = -0.5: genuine quadrature error
# far outside it (kept); [1, -1 + 1e-7]: cancelled below 64 ulps (always
# poisoned).  f32: the bands scale with the working dtype's eps.
@pytest.mark.parametrize("weights,nonneg", [
    ([1.0, -1.0001, 0.0, 0.0], True),
    ([1.0, -1.0001, 0.0, 0.0], False),
    ([1.0, -0.5, -0.5, -0.5], True),
    ([1.0, -1.0 + 1e-7, 0.0, 0.0], False),
    ([0.25, 0.25, 0.25, 0.25], True),
])
def test_phi_guards_match_jax(weights, nonneg):
    f32 = jnp.float32
    nodes = np.zeros((4, 2), np.float32)
    mu = np.zeros((3, 2), np.float32)
    cov = np.broadcast_to(np.eye(2, dtype=np.float32), (3, 2, 2))
    want = np.asarray(jmm.expectation_phi(
        jnp.asarray(nodes), jnp.asarray(weights, f32), jnp.asarray(mu),
        jnp.asarray(cov), lambda x, p: jnp.asarray(1.0, f32), None,
        nonneg=nonneg))
    got = tmm.expectation_phi(
        torch.as_tensor(nodes), torch.tensor(weights, dtype=torch.float32),
        torch.as_tensor(mu), torch.as_tensor(np.array(cov)),
        lambda x, p: torch.ones(x.shape[:-1], dtype=x.dtype), None,
        nonneg=nonneg)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("with_moments", [False, True])
def test_kernel_plain_matches_jax_kernel(problem, with_moments):
    """K3's plain versions (what the wrappers run for CPU tensors, with the
    packed params of the "range" functor) against the JAX Pallas kernel in
    interpret mode, both variants."""
    jfb, tfb, mu, cov, leaves = problem
    jleaves = tuple(jnp.asarray(leaves[k]) for k in sorted(leaves))
    want = quad_lanes(
        jnp.asarray(mu), jnp.asarray(cov), jfb.nodes, jfb.weights,
        range_cost_lanes, jleaves, with_moments=with_moments,
        interpret=True, nonneg=jfb.nonneg_cost, rdim=jfb.quad_rdim,
    )
    packed = torch.cat([torch.as_tensor(leaves[k]).reshape(3, 8, -1)
                        for k in sorted(leaves)], dim=-1)
    args = (torch.as_tensor(mu), torch.as_tensor(cov), tfb.nodes,
            tfb.weights, "range", packed)
    if with_moments:
        got = tquad.quad_lanes_moments(*args, rdim=tfb.quad_rdim)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    else:
        got = tquad.quad_lanes_phi(*args, nonneg=tfb.nonneg_cost)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert tquad.quad_lanes_phi.launches == tquad.quad_lanes_moments.launches == 0


def test_batch_dispatch_kernel_and_plain_agree(problem):
    """batch_phi/batch_moments: the kernel route (plain version on the CPU,
    packed params) equals the cost_fn route."""
    _, tfb, mu, cov, _ = problem
    mu_t = torch.as_tensor(mu[0])
    cov_t = torch.as_tensor(cov[0])
    for use_kernel in (False, True):
        phi = tmm.batch_phi(tfb, mu_t, cov_t, use_kernel)
        mom = tmm.batch_moments(tfb, mu_t, cov_t, use_kernel)
        if not use_kernel:
            ref_phi, ref_mom = phi, mom
    np.testing.assert_allclose(phi.numpy(), ref_phi.numpy(), atol=1e-12)
    for g, w in zip(mom, ref_mom):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-12)


def test_kernel_path_requires_a_named_cost(problem):
    _, tfb, mu, cov, _ = problem
    from dataclasses import replace

    with pytest.raises(ValueError, match="kernel_cost"):
        tmm.batch_phi(replace(tfb, kernel_cost=None), torch.as_tensor(mu[0]),
                      torch.as_tensor(cov[0]), use_kernel=True)
