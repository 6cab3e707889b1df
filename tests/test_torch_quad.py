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
    tfb = torch_build(num_states=8, dim_x=2, gh_degree=4, seed=0,
                      device="cpu")[0].nonlinear[0]
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
        mom = tmm.batch_moments(tfb, mu_t, cov_t, use_kernel=use_kernel)
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


# ---- what the wrappers hand the kernels (no card: a recording stub) ----

class _Entries:
    """Stands in for the kernel library: records each C entry's arguments
    and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def entries(monkeypatch):
    from gaussianvi_tpu_torch.kernels import _build

    lib = _Entries()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "current_stream", lambda device: 0)
    return lib


def _read(ptr, count, dtype=np.float64):
    import ctypes

    ctype = {np.float64: ctypes.c_double, np.float32: ctypes.c_float}[dtype]
    return np.ctypeslib.as_array((ctype * count).from_address(ptr)).copy()


def _marginals(shape, d, seed=0):
    rng = np.random.default_rng(seed)
    a = 0.3 * rng.standard_normal((*shape, d, d))
    return (torch.as_tensor(rng.standard_normal((*shape, d))),
            torch.as_tensor(a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(d)))


@pytest.mark.parametrize("moments", [False, True])
@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("m", [7, 29, 137])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_quad_plan(m, d, moments, dtype):
    """The layout a launch takes (the measured choice, PERF.md): one lane
    per factor for phi, two for the moments, on every rule; whole warps of
    whole groups; the rule (nodes and weights) in shared memory, and for
    the moments each warp's staging area of 1 + d + d^2 values a
    factor."""
    plan = tquad.quad_plan(m, d, moments, dtype)
    assert plan.group == (2 if moments else 1)
    assert plan.threads % 32 == 0 and plan.threads % plan.group == 0
    staged = plan.threads // plan.group * (1 + d + d * d) if moments else 0
    assert plan.smem == (m * (d + 1) + staged) * dtype.itemsize
    assert tquad.covers("range", d, d // 2 + 2, m, dtype) is None


@pytest.mark.parametrize("moments", [False, True])
def test_wrappers_hand_over_the_operands_in_place(entries, problem, moments):
    """On contiguous operands in the flagship's trial layout (mu
    [T, B, K, d], cov [T, B, K, d, d], params [B, K, P] broadcast over the
    trials) the C entry gets the operands' own storage, the params
    unexpanded (period B K), and the outputs it writes are the wrapper's
    results, contiguous in their final shapes."""
    _, tfb, _, _, _ = problem
    mu, cov = _marginals((3, 2, 8), 4)
    params = tfb.kernel_params.expand(2, 8, 4).contiguous()
    got = tquad._launch("quad_lanes", mu, cov, tfb.nodes, tfb.weights,
                        "range", params, moments, True, 2)
    ((name, args),) = entries.calls
    assert name == "gvi_quad"
    (dtype, d, cost, with_moments, p_mu, mu_sb, mu_sk, p_cov, cov_sb,
     cov_sk, p_nodes, p_w, p_par, period, p_field, rows, cols, depth, p_phi,
     p_xmu, p_xxt, count, k, m, n_par, nonneg, rdim, quant, shift, threads,
     _) = args
    assert (dtype, d, cost, with_moments) == (1, 4, 0, int(moments))
    assert quant == 0    # no eval_dtype: the offsets are not rounded
    # the range cost has no field
    assert (p_field, rows, cols, depth) == (None, 0, 0, 0)
    assert (p_mu, p_cov, p_par) == (mu.data_ptr(), cov.data_ptr(),
                                    params.data_ptr())
    assert (p_nodes, p_w) == (tfb.nodes.data_ptr(), tfb.weights.data_ptr())
    assert (mu_sb, mu_sk, cov_sb, cov_sk) == (32, 4, 128, 16)
    assert (period, count, k, m, n_par) == (16, 48, 8, 29, 4)
    plan = tquad.quad_plan(29, 4, moments, torch.float64)
    assert (1 << shift, threads) == (plan.group, plan.threads)
    assert (nonneg, rdim) == (1, 2)
    outs = got if moments else (got,)
    shapes = [(3, 2, 8), (3, 2, 8, 4), (3, 2, 8, 4, 4)]
    for out, ptr, shape in zip(outs, (p_phi, p_xmu, p_xxt), shapes):
        assert out.shape == shape and out.is_contiguous()
        assert out.data_ptr() == ptr
    if not moments:
        assert p_xmu is None and p_xxt is None


# name -> (mu / cov, params): layouts the kernel reads in place, and two
# it gets a copy of
READ_BACK = {
    "contiguous, params [B, K, P]": ("plain", (4,)),
    "params [K, P]": ("plain", ()),
    "params [1, K, P]": ("plain", (1,)),
    "state slice": ("slice", (4,)),
    "leading axis expanded: copied": ("expanded", (4,)),
    "transposed (T, B): copied": ("transposed", (4,)),
    "params [T, 1, K, P]: expanded": ("plain", (3, 1)),
}


@pytest.mark.parametrize("name", sorted(READ_BACK))
def test_operands_read_back(name):
    """A reader that indexes the pointers as ``csrc/quad.cuh`` does
    (factor f = b K + k at b * stride_b + k * stride_k, params row f %
    period) gets back each factor's mu, cov and params; storage is shared
    wherever the layout allows it."""
    view, plead = READ_BACK[name]
    t, b, k, d, p = 3, 4, 5, 4, 4
    if view == "slice":
        mu_s, cov_s = _marginals((t, b, k + 3), d)
        mu, cov = mu_s.narrow(-2, 2, k), cov_s.narrow(-3, 2, k)
    elif view == "expanded":
        mu_s, cov_s = _marginals((1, b, k), d)
        mu, cov = mu_s.expand(t, b, k, d), cov_s.expand(t, b, k, d, d)
    elif view == "transposed":
        mu_s, cov_s = _marginals((b, t, k), d)
        mu, cov = mu_s.transpose(0, 1), cov_s.transpose(0, 1)
    else:
        mu, cov = _marginals((t, b, k), d)
        mu_s = mu
    params = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (*plead, k, p)))
    nodes, weights = torch.zeros(3, d, dtype=mu.dtype), torch.ones(3)
    call = tquad._operands("read back", mu, cov, nodes, weights.double(),
                           "range", params, True)
    (p_mu, mu_sb, mu_sk, p_cov, cov_sb, cov_sk, _, _, p_par, period, *_,
     count, kk, _, n_par) = call.args
    assert (count, kk, n_par) == (t * b * k, k, p)
    copied = view in ("transposed", "expanded")
    assert (p_mu == mu_s.data_ptr() + 8 * mu.storage_offset()) != copied
    assert (p_par == params.data_ptr()) == (plead != (3, 1))
    want_par = params.expand(t, b, k, p).reshape(-1, p)
    for f in range(count):
        row, col = divmod(f, k)
        np.testing.assert_array_equal(
            _read(p_mu + 8 * (row * mu_sb + col * mu_sk), d),
            mu.reshape(-1, k, d)[row, col].numpy())
        np.testing.assert_array_equal(
            _read(p_cov + 8 * (row * cov_sb + col * cov_sk), d * d),
            cov.reshape(-1, k, d * d)[row, col].numpy())
        np.testing.assert_array_equal(
            _read(p_par + 8 * (f % period) * p, p), want_par[f].numpy())


def test_flagship_path_operands_are_contiguous(monkeypatch):
    """On the flagship (the engine resolved for the card on CPU tensors),
    the operands every path hands K3 and K4 are contiguous: the initial
    costs and the separate path's trial costs (K3 phi), the NGD
    gradient's moments (K3 moments, or K4 under ``use_pallas``) and the
    prox gradient's (K3 moments).  No operand is copied."""
    from gaussianvi_tpu_torch import GVIConfig, stack_problems
    from gaussianvi_tpu_torch.inference import gvi
    from gaussianvi_tpu_torch.inference.engine import LocalEngine
    from gaussianvi_tpu_torch.kernels import fused_moments as tfm
    from gaussianvi_tpu_torch.ops.blocktridiag import (
        BlockTridiag,
        gbp_covariance_logdet,
    )

    graph, state = stack_problems(*map(list, zip(*(
        torch_build(num_states=8, dim_x=2, gh_degree=4, seed=i,
                    device="cpu")[:2] for i in range(3)))))
    engine = LocalEngine(graph, GVIConfig(), torch.device("cuda"))
    assert engine.quad_batches == (True,)
    seen = []

    def spy(name, plain, moments):
        def run(*args, **kw):
            if name == "fused_moments":
                nodes, weights, mu, cov, cost, params = args
            else:
                mu, cov, nodes, weights, cost, params = args
            call = tquad._operands(name, mu, cov, nodes, weights, cost,
                                   params, moments)
            held = call.held[:3]
            assert all(x.is_contiguous() for x in (mu, cov, params))
            assert [x.data_ptr() for x in held] == [
                x.data_ptr() for x in (mu, cov, params)]
            seen.append((name, tuple(mu.shape)))
            return plain(*args, **kw)
        return run

    monkeypatch.setattr(tquad, "quad_lanes_phi", spy(
        "quad_phi", tquad.quad_lanes_phi, False))
    monkeypatch.setattr(tquad, "quad_lanes_moments", spy(
        "quad_moments", tquad.quad_lanes_moments, True))
    monkeypatch.setattr(tfm, "fused_moments", spy(
        "fused_moments", tfm.fused_moments, True))
    mu, prec = state.mu, state.precision
    cd, co, _ = gbp_covariance_logdet(prec)
    engine.factor_costs_raw(mu, cd, co)
    steps = 0.9 * 0.75 ** torch.arange(1, 12, dtype=mu.dtype)
    t_mu = mu + steps[:, None, None, None] * 0.1 * torch.ones_like(mu)
    t_prec = BlockTridiag(prec.diag.expand(11, *prec.diag.shape).clone(),
                          prec.off.expand(11, *prec.off.shape).clone())
    t_cd, t_co, _ = gbp_covariance_logdet(t_prec)
    engine.factor_costs_raw(t_mu, t_cd, t_co)
    temp = torch.ones(3, dtype=mu.dtype)
    for use_pallas in (False, True):
        gvi.ngd_gradients(graph, mu, cd, co, temp, use_pallas,
                          engine.quad_batches)
    gvi.prox_gradients(graph, mu, cd, co, 0.1, engine.quad_batches)
    assert seen == [("quad_phi", (3, 8, 4)), ("quad_phi", (11, 3, 8, 4)),
                    ("quad_moments", (3, 8, 4)), ("fused_moments", (3, 8, 4)),
                    ("quad_moments", (3, 8, 4))]
