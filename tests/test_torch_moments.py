"""PyTorch port, the block-form moments kernel's plain version (K4), the
PSD matrix functions and the proximal optimizer's gradient math against
the JAX package (CPU, f64, numpy-seeded inputs)."""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gaussianvi_tpu.examples import chain_estimation as jce  # noqa: E402
from gaussianvi_tpu.factors import moments as jmm  # noqa: E402
from gaussianvi_tpu.inference import gvi as jgvi  # noqa: E402
from gaussianvi_tpu.kernels.fused_moments import (  # noqa: E402
    fused_moments as jax_fused_moments,
)
from gaussianvi_tpu.ops import psd as jpsd  # noqa: E402
from gaussianvi_tpu.ops.blocktridiag import (  # noqa: E402
    gbp_covariance_logdet as jgbp,
)
from gaussianvi_tpu.parallel.sharding import stack_problems as jstack  # noqa: E402
from gaussianvi_tpu_torch import stack_problems  # noqa: E402
from gaussianvi_tpu_torch.examples import chain_estimation as tce  # noqa: E402
from gaussianvi_tpu_torch.factors import moments as tmm  # noqa: E402
from gaussianvi_tpu_torch.factors.base import param_leaves  # noqa: E402
from gaussianvi_tpu_torch.inference import gvi as tgvi  # noqa: E402
from gaussianvi_tpu_torch.kernels import fused_moments as tfm  # noqa: E402
from gaussianvi_tpu_torch.ops import psd as tpsd  # noqa: E402
from gaussianvi_tpu_torch.ops.blocktridiag import (  # noqa: E402
    gbp_covariance_logdet as tgbp,
)

CPU = torch.device("cpu")

# the tolerances of tests/test_pallas_kernel.py (interpret-mode parity)
RTOL, ATOL = 1e-9, 1e-10
K = 6


def _batches(dim_x, marginal):
    """The flagship's range batch in both packages, with numpy-seeded
    marginals ``mu [K, d]``, ``cov [K, d, d]``."""
    kw = dict(num_states=K, dim_x=dim_x, gh_degree=4, seed=2,
              marginal_quad=marginal)
    jfb = jce.build_chain_estimation(**kw)[0].nonlinear[0]
    tfb = tce.build_chain_estimation(**kw, device=CPU)[0].nonlinear[0]
    d = 2 * dim_x
    rng = np.random.default_rng(10 * dim_x + marginal)
    mu = 1.5 + 0.3 * rng.standard_normal((K, d))
    a = 0.2 * rng.standard_normal((K, d, d))
    cov = a @ np.swapaxes(a, -1, -2) + 0.05 * np.eye(d)
    return jfb, tfb, mu, cov


def _assert_moments(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("route", ["block_cost", "functor"])
@pytest.mark.parametrize("dim_x", [1, 2])
def test_fused_moments_plain_matches_jax_kernel(dim_x, route):
    """K4's plain version on a full rule against the JAX Pallas kernel in
    interpret mode: with the batch's block-form cost and its param leaves,
    and through the wrapper (CPU tensors: the "range" functor's PyTorch
    form on the packed params)."""
    jfb, tfb, mu, cov = _batches(dim_x, marginal=False)
    assert jfb.quad_rdim is None and tfb.block_cost is not None
    want = jax_fused_moments(jfb.nodes, jfb.weights, jnp.asarray(mu),
                             jnp.asarray(cov), jfb.block_cost,
                             tuple(jax.tree.leaves(jfb.params)),
                             interpret=True)
    mu_t, cov_t = torch.as_tensor(mu), torch.as_tensor(cov)
    if route == "block_cost":
        got = tfm.fused_moments_plain(tfb.nodes, tfb.weights, mu_t, cov_t,
                                      tfb.block_cost,
                                      param_leaves(tfb.params))
    else:
        got = tfm.fused_moments(tfb.nodes, tfb.weights, mu_t, cov_t,
                                tfb.kernel_cost, tfb.kernel_params)
        assert tfm.fused_moments.launches == 0
    _assert_moments(got, want)


@pytest.mark.parametrize("dim_x", [1, 2])
def test_fused_moments_rdim_matches_jax_gh_moments(dim_x):
    """On the marginal rule K4's plain version applies the lift: it gives
    the moments of the JAX ``gh_moments(rdim=...)``, with leading axes
    flattened onto the factor axis and restored."""
    jfb, tfb, mu, cov = _batches(dim_x, marginal=True)
    assert tfb.quad_rdim == dim_x
    want = jmm.gh_moments(jfb.nodes, jfb.weights, jnp.asarray(mu),
                          jnp.asarray(cov), jfb.cost_fn, jfb.params,
                          rdim=jfb.quad_rdim)
    got = tfm.fused_moments(tfb.nodes, tfb.weights, torch.as_tensor(mu),
                            torch.as_tensor(cov), tfb.kernel_cost,
                            tfb.kernel_params, rdim=tfb.quad_rdim)
    _assert_moments(got, want)
    # leading axes [2, 3, d] flatten onto the factor axis and come back
    lead = tfm.fused_moments(
        tfb.nodes, tfb.weights, torch.as_tensor(mu).reshape(2, 3, -1),
        torch.as_tensor(cov).reshape(2, 3, 2 * dim_x, 2 * dim_x),
        tfb.kernel_cost, tfb.kernel_params.reshape(2, 3, -1),
        rdim=tfb.quad_rdim)
    for a, b in zip(lead, got):
        np.testing.assert_array_equal(a.reshape(b.shape).numpy(), b.numpy())


def test_jax_use_pallas_drops_the_lift_reference_fault():
    """Reference fault, not reproduced: on a marginal rule the JAX
    ``batch_moments(use_pallas=True)`` branch drops ``quad_rdim``, so its
    second moment lacks the velocity-block mass; the port's
    ``use_pallas`` route equals its other routes and the JAX
    ``use_pallas=False`` result."""
    jfb, tfb, mu, cov = _batches(2, marginal=True)
    jmu, jcov = jnp.asarray(mu), jnp.asarray(cov)
    right = jmm.batch_moments(jfb, jmu, jcov, use_pallas=False)
    faulty = jmm.batch_moments(jfb, jmu, jcov, use_pallas=True)
    np.testing.assert_allclose(np.asarray(faulty[0]), np.asarray(right[0]),
                               rtol=RTOL)
    np.testing.assert_allclose(np.asarray(faulty[1]), np.asarray(right[1]),
                               rtol=RTOL, atol=ATOL)
    gap = np.abs(np.asarray(faulty[2]) - np.asarray(right[2]))
    assert gap[:, :2, :].max() < ATOL          # position rows agree
    assert gap[:, 2:, 2:].max() > 1e-3         # the velocity block does not
    mu_t, cov_t = torch.as_tensor(mu), torch.as_tensor(cov)
    for use_kernel in (False, True):
        got = tmm.batch_moments(tfb, mu_t, cov_t, use_pallas=True,
                                use_kernel=use_kernel)
        _assert_moments(got, right)
    # without a block form the flag changes nothing (the JAX dispatch order)
    plain = tmm.batch_moments(replace(tfb, block_cost=None), mu_t, cov_t,
                              use_pallas=True)
    _assert_moments(plain, right)


def test_use_pallas_ignores_eval_dtype_as_jax_does():
    """Reference defect, reproduced: K4's body has no ``eval_dtype``, so the
    JAX ``batch_moments(use_pallas=True)`` branch ignores bfloat16 offset
    rounding, and the port's block-form route does the same (its other
    routes round)."""
    jfb, tfb, mu, cov = _batches(2, marginal=False)
    jmu, jcov = jnp.asarray(mu), jnp.asarray(cov)
    bf16 = jnp.bfloat16
    ignored = jmm.batch_moments(jfb, jmu, jcov, use_pallas=True,
                                eval_dtype=bf16)
    full = jmm.batch_moments(jfb, jmu, jcov, use_pallas=True)
    rounded = jmm.batch_moments(jfb, jmu, jcov, use_pallas=False,
                                eval_dtype=bf16)
    for a, b in zip(ignored, full):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert not np.allclose(np.asarray(rounded[0]), np.asarray(full[0]),
                           rtol=1e-9, atol=0)
    mu_t, cov_t = torch.as_tensor(mu), torch.as_tensor(cov)
    got = tmm.batch_moments(tfb, mu_t, cov_t, use_pallas=True,
                            eval_dtype="bfloat16")
    _assert_moments(got, full)
    other = tmm.batch_moments(tfb, mu_t, cov_t, use_pallas=False,
                              eval_dtype="bfloat16")
    _assert_moments(other, rounded)


def test_use_pallas_needs_a_functor():
    _, tfb, mu, cov = _batches(2, marginal=True)
    with pytest.raises(ValueError, match="kernel_cost"):
        tmm.batch_moments(replace(tfb, kernel_cost=None), torch.as_tensor(mu),
                          torch.as_tensor(cov), use_pallas=True)


def test_bw_local_gradients_match_jax():
    _, tfb, mu, cov = _batches(2, marginal=True)
    rng = np.random.default_rng(5)
    e_phi = rng.uniform(0.5, 2.0, (3, K))
    e_xmu = rng.standard_normal((3, K, 4))
    q = rng.standard_normal((3, K, 4, 4))
    e_xxt = q + np.swapaxes(q, -1, -2)
    covs = np.broadcast_to(cov, (3, K, 4, 4))
    want = jax.vmap(jmm.bw_local_gradients)(
        jnp.asarray(e_phi), jnp.asarray(e_xmu), jnp.asarray(e_xxt),
        jnp.asarray(covs))
    got = tmm.bw_local_gradients(*(torch.as_tensor(np.array(x))
                                   for x in (e_phi, e_xmu, e_xxt, covs)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-10)


def _spd(rng, shape, d, kappa):
    """SPD matrices with eigenvalues log-spaced over ``[1, kappa]``."""
    q, _ = np.linalg.qr(rng.standard_normal((*shape, d, d)))
    w = np.logspace(0.0, np.log10(kappa), d)
    a = (q * w) @ np.swapaxes(q, -1, -2)
    return 0.5 * (a + np.swapaxes(a, -1, -2))


@pytest.mark.parametrize("d", [4, 8])
def test_bw_jko_step_matches_jax(d):
    rng = np.random.default_rng(d)
    cov = 0.1 * _spd(rng, (2, 5), d, 50.0)
    s_k = _spd(rng, (2, 5), d, 20.0) - 2.0 * np.eye(d)   # indefinite
    b_k = rng.standard_normal((2, 5, d))
    want = jax.vmap(lambda b, s, c: jgvi._bw_jko_step(b, s, c, 0.3))(
        jnp.asarray(b_k), jnp.asarray(s_k), jnp.asarray(cov))
    got = tgvi._bw_jko_step(torch.as_tensor(b_k), torch.as_tensor(s_k),
                            torch.as_tensor(cov), 0.3)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    scale = np.abs(np.asarray(want[1])).max()
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-10, atol=1e-10 * scale)


def test_prox_gradients_match_jax():
    """The joint JKO pseudo-gradients on two stacked flagship problems at a
    perturbed iterate: nonlinear moments (marginal rule, lift) and both
    closed-form linear batches (the GP prior's 8x8 blocks)."""
    kw = dict(num_states=6, dim_x=2, gh_degree=4)
    jp = [jce.build_chain_estimation(seed=s, **kw)[:2] for s in (0, 1)]
    tp = [tce.build_chain_estimation(seed=s, **kw, device=CPU)[:2] for s in (0, 1)]
    jg, js = jstack(*map(list, zip(*jp)))
    tg, ts = stack_problems(*map(list, zip(*tp)))
    rng = np.random.default_rng(11)
    shift = 0.05 * rng.standard_normal(np.asarray(js.mu).shape)

    def one(g, s, dm):
        cd, co, _ = jgbp(s.precision)
        return jgvi.prox_gradients(g, s.mu + dm, cd, co, 0.2)

    jdmu, jdprec = jax.vmap(one)(jg, js, jnp.asarray(shift))
    cd, co, _ = tgbp(ts.precision)
    dmu, dprec = tgvi.prox_gradients(tg, ts.mu + torch.as_tensor(shift), cd,
                                     co, 0.2)
    np.testing.assert_allclose(dmu.numpy(), np.asarray(jdmu), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(jdmu)).max())
    # the GP prior is stiff (S_k eigenvalues up to ~1e5 at dt = 0.1), and
    # (Sig_new^-1 - Prec_k) / s amplifies the eigensolvers' rounding: entries
    # that are zero by structure come out as +-2e-9 in BOTH packages, so the
    # floor is 1e-8 of the range here; 1e-10 holds on well-conditioned
    # blocks (test_bw_jko_step_matches_jax)
    for got, want in ((dprec.diag, jdprec.diag), (dprec.off, jdprec.off)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                                   atol=1e-8 * np.abs(want).max())


_PSD = {
    "psd_sqrtm": (tpsd.psd_sqrtm, jpsd.psd_sqrtm),
    "psd_inv_sqrtm": (tpsd.psd_inv_sqrtm, jpsd.psd_inv_sqrtm),
    "sqrtm_product-eigh": (
        lambda a: tpsd.sqrtm_product(a, 0.3, method="eigh"),
        lambda a: jpsd.sqrtm_product(a, 0.3, method="eigh")),
    "sqrtm_product-newton": (
        lambda a: tpsd.sqrtm_product(a, 0.3, method="newton"),
        lambda a: jpsd.sqrtm_product(a, 0.3, method="newton")),
}


@pytest.mark.parametrize("kappa", [1.0, 1e4])
@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(_PSD))
def test_psd_functions_match_jax(name, d, kappa):
    """The roots, never the eigenvectors: ``V f(w) V^T`` does not depend on
    their sign or order.  ``method`` is pinned on both sides."""
    a = _spd(np.random.default_rng(d), (3, 7), d, kappa)
    tfn, jfn = _PSD[name]
    want = np.asarray(jfn(jnp.asarray(a)))
    got = tfn(torch.as_tensor(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("kappa", [1.0, 1e4])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_sqrtm_product_newton_against_eigh_oracle(d, kappa):
    """The Denman-Beavers root against the eigenbasis form (f64): the
    oracle gate of the prox step's root, up to kappa(A) = 1e4."""
    a = torch.as_tensor(_spd(np.random.default_rng(100 + d), (16,), d, kappa))
    for s in (0.05, 0.9):
        oracle = tpsd.sqrtm_product(a, s, method="eigh")
        newton = tpsd.sqrtm_product(a, s, method="newton")
        rel = ((newton - oracle).abs().amax((-2, -1))
               / oracle.abs().amax((-2, -1))).max().item()
        assert rel < 1e-11, rel
        # it is the root: X X = A (A + 4 s I)
        b = a @ a + 4.0 * s * a
        np.testing.assert_allclose((newton @ newton).numpy(), b.numpy(),
                                   rtol=1e-10, atol=1e-10 * float(b.max()))


def test_sqrtm_product_auto_goes_by_the_tensor(monkeypatch):
    """``auto`` takes the device of the tensor it is given, not a global
    backend: eigh (bitwise) on CPU tensors whatever the CUDA choice."""
    a = torch.as_tensor(_spd(np.random.default_rng(0), (4,), 4, 10.0))
    eigh = tpsd.sqrtm_product(a, 0.3, method="eigh")
    for cuda_choice in ("eigh", "newton"):
        monkeypatch.setitem(tpsd.AUTO_METHOD, "cuda", cuda_choice)
        assert torch.equal(tpsd.sqrtm_product(a, 0.3), eigh)
    with pytest.raises(ValueError, match="unknown"):
        tpsd.sqrtm_product(a, 0.3, method="schur")


def test_kernel_is_handed_the_covariance(monkeypatch):
    """K4's launch hands the C entry the caller's mu, cov and params (no
    copy, no expansion, no Cholesky factor: the kernel takes it), in one
    call with no PyTorch op before it, and returns the outputs the entry
    writes, contiguous in their final shapes.  A recording stub stands in
    for the kernel library."""
    from gaussianvi_tpu_torch.kernels import _build
    from gaussianvi_tpu_torch.kernels import quad as tquad

    calls = []

    class Entries:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(_build, "load", Entries)
    monkeypatch.setattr(_build, "current_stream", lambda device: 0)

    def no_cholesky(*args):
        raise AssertionError("the kernel route took a PyTorch Cholesky")

    monkeypatch.setattr(tfm, "chol_small", no_cholesky)
    _, tfb, mu, cov = _batches(2, marginal=True)
    mu_t = torch.as_tensor(np.stack([mu, mu + 0.1]))           # [2, K, 4]
    cov_t = torch.as_tensor(np.stack([cov, cov]))
    params = tfb.kernel_params                                 # [K, 4]
    got = tfm._launch(tfb.nodes, tfb.weights, mu_t, cov_t, "range", params,
                      tfb.quad_rdim)
    ((name, args),) = calls
    assert name == "gvi_fused_moments"
    (dtype, d, cost, p_mu, mu_sb, mu_sk, p_cov, cov_sb, cov_sk, p_nodes, p_w,
     p_par, period, p_field, rows, cols, depth, p_phi, p_xmu, p_xxt, count,
     k, m, n_par, rdim, shift, threads, _) = args
    assert (dtype, d, cost, rdim) == (1, 4, 0, 2)
    # the range cost has no field
    assert (p_field, rows, cols, depth) == (None, 0, 0, 0)
    assert (p_mu, p_cov, p_par, p_nodes, p_w) == tuple(
        x.data_ptr() for x in (mu_t, cov_t, params, tfb.nodes, tfb.weights))
    assert (mu_sb, mu_sk, cov_sb, cov_sk, period) == (4 * K, 4, 16 * K, 16, K)
    assert (count, k, m, n_par) == (2 * K, K, 29, 4)
    plan = tquad.quad_plan(29, 4, True, torch.float64)
    assert (1 << shift, threads) == (plan.group, plan.threads)
    for out, ptr, shape in zip(got, (p_phi, p_xmu, p_xxt),
                               ((2, K), (2, K, 4), (2, K, 4, 4))):
        assert out.shape == shape and out.is_contiguous()
        assert out.data_ptr() == ptr
