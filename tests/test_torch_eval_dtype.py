"""PyTorch port, ``moments_eval_dtype``: sigma offsets rounded through
bfloat16 or float16 and back (centered quantization), against the JAX
package on the CPU (f64): the rounding itself, the moments, the plain
versions of the kernels that take it (K3 both variants, K5, K6 in its
three modes) against the JAX kernels in Pallas interpret mode, and the
NGD loop against ``jax.vmap(optimize)``."""

import functools
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gaussianvi_tpu.examples.chain_estimation import range_cost_lanes  # noqa: E402
from gaussianvi_tpu.factors import moments as jmm  # noqa: E402
from gaussianvi_tpu.inference import GVIConfig as JaxConfig  # noqa: E402
from gaussianvi_tpu.kernels import fused_gradient as jfg  # noqa: E402
from gaussianvi_tpu.kernels import fused_trials as jft  # noqa: E402
from gaussianvi_tpu.kernels.quad_lanes import quad_lanes  # noqa: E402
from gaussianvi_tpu_torch.factors import moments as tmm  # noqa: E402
from gaussianvi_tpu_torch.inference.engine import fused_operands  # noqa: E402
from gaussianvi_tpu_torch.kernels import fused_gradient as tfg  # noqa: E402
from gaussianvi_tpu_torch.kernels import fused_trials as tft  # noqa: E402
from gaussianvi_tpu_torch.kernels import quad as tquad  # noqa: E402
from test_torch_fused import (  # noqa: E402
    _close,
    _inputs,
    _jax_operands,
    _port,
    _problems,
)
from test_torch_quad import problem  # noqa: E402,F401
from test_torch_slice import build_chain_estimation, run_both  # noqa: E402

BF16 = torch.bfloat16
JAX_DTYPES = {"bfloat16": jnp.bfloat16, "float16": jnp.float16}


def test_float64_rounds_to_bfloat16_through_float32_as_jax_does():
    """Doubles just off a bfloat16 tie: a direct rounding takes the nearer
    neighbour, a rounding through float32 lands on the tie and takes the
    even one.  The port (and the kernels' float64 instances) round as the
    JAX package does, through float32; the direct rounding differs on
    about half of these values."""
    rng = np.random.default_rng(0)
    base = rng.uniform(1.0, 2.0, 2000).astype(np.float32)
    lo = torch.as_tensor(base).to(BF16).to(torch.float64).numpy()
    hi = lo + 2.0**-7                        # the next bfloat16 in [1, 2)
    side = rng.choice([-1.0, 1.0], lo.size)
    x = (lo + 2.0**-8) * (1 + side * 2.0**-40)
    direct = np.where(side > 0, hi, lo)      # the nearer neighbour
    scale = rng.choice([-1.0, 1.0], x.size) * 2.0 ** rng.integers(-20, 20,
                                                                  x.size)
    x, direct = x * scale, direct * scale    # exact: powers of two
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float64))
    got = tmm.quantize(torch.as_tensor(x), "bfloat16").numpy()
    np.testing.assert_array_equal(got, want)
    differ = np.mean(direct != got)
    assert 0.3 < differ < 0.7, differ


@pytest.mark.parametrize("name", ["bfloat16", "float16"])
def test_quantized_moments_match_jax(problem, name):  # noqa: F811
    """``_sigma_diffs``, ``gh_moments`` (the moments accumulate the rounded
    offsets, the lift on) and the guarded E[phi] with the offsets rounded
    through ``name``: the same f64 values as the JAX package, to 1e-13;
    the rounding moves E[phi] by what JAX's envelope allows (bfloat16
    < 5e-3, float16 < 5e-4 relative)."""
    jfb, tfb, mu, cov, leaves = problem
    jd = JAX_DTYPES[name]
    params = {k: torch.as_tensor(v) for k, v in leaves.items()}
    mu_t, cov_t = torch.as_tensor(mu), torch.as_tensor(cov)

    def jax_one(m, c, p, phi_only):
        if phi_only:
            return jmm.expectation_phi(jfb.nodes, jfb.weights, m, c,
                                       jfb.cost_fn, p, jd, nonneg=True)
        return jmm.gh_moments(jfb.nodes, jfb.weights, m, c, jfb.cost_fn, p,
                              jd, rdim=jfb.quad_rdim)

    jl = {k: jnp.asarray(v) for k, v in leaves.items()}
    want_d = np.asarray(jax.vmap(lambda c: jmm._sigma_diffs(
        jfb.nodes, c, jd))(jnp.asarray(cov)))                 # [B, K, M, d]
    got_d = tmm._sigma_diffs(tfb.nodes, cov_t, name)[0]        # [M, B, K, d]
    np.testing.assert_allclose(got_d.permute(1, 2, 0, 3).numpy(), want_d,
                               rtol=0, atol=1e-13)
    want = jax.vmap(lambda m, c, p: jax_one(m, c, p, False))(
        jnp.asarray(mu), jnp.asarray(cov), jl)
    got = tmm.gh_moments(tfb.nodes, tfb.weights, mu_t, cov_t, tfb.cost_fn,
                         params, name, rdim=tfb.quad_rdim)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-13,
                                   atol=1e-13)
    want_phi = np.asarray(jax.vmap(lambda m, c, p: jax_one(m, c, p, True))(
        jnp.asarray(mu), jnp.asarray(cov), jl))
    tfb = replace(tfb, params=params)
    got_phi = tmm.batch_phi(tfb, mu_t, cov_t, False, name)
    np.testing.assert_allclose(got_phi.numpy(), want_phi, rtol=1e-13)
    full = tmm.batch_phi(tfb, mu_t, cov_t, False)
    rel = (got_phi - full).abs() / full.abs()
    assert 0 < rel.max() < (5e-3 if name == "bfloat16" else 5e-4)


@pytest.mark.parametrize("with_moments", [False, True])
def test_quad_plain_matches_jax_kernel_bf16(problem, with_moments):  # noqa: F811
    """K3's plain versions with ``eval_dtype=bfloat16`` (offsets summed in
    the kernel's order, then rounded) against the JAX kernel in interpret
    mode with the same option."""
    jfb, tfb, mu, cov, leaves = problem
    jleaves = tuple(jnp.asarray(leaves[k]) for k in sorted(leaves))
    want = quad_lanes(
        jnp.asarray(mu), jnp.asarray(cov), jfb.nodes, jfb.weights,
        range_cost_lanes, jleaves, with_moments=with_moments,
        interpret=True, eval_dtype=jnp.bfloat16, nonneg=jfb.nonneg_cost,
        rdim=jfb.quad_rdim)
    packed = torch.cat([torch.as_tensor(leaves[k]).reshape(3, 8, -1)
                        for k in sorted(leaves)], dim=-1)
    args = (torch.as_tensor(mu), torch.as_tensor(cov), tfb.nodes,
            tfb.weights, "range", packed)
    if with_moments:
        got = tquad.quad_lanes_moments(*args, rdim=tfb.quad_rdim,
                                       eval_dtype=BF16)
        plain = tquad.quad_lanes_moments(*args, rdim=tfb.quad_rdim)
    else:
        got = (tquad.quad_lanes_phi(*args, nonneg=True, eval_dtype=BF16),)
        plain = (tquad.quad_lanes_phi(*args, nonneg=True),)
        want = (want,)
    for g, w, p in zip(got, want, plain):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-10)
        assert not torch.equal(g, p)


def test_kernel_offsets_sum_in_the_kernel_order():
    """``kernel_offsets``: each product and sum rounded in the order of
    ``csrc/sigma.cuh`` (checked here against a scalar loop), then the
    round trip."""
    rng = np.random.default_rng(3)
    nodes = torch.as_tensor(rng.standard_normal((5, 4)), dtype=torch.float32)
    l = torch.as_tensor(np.tril(rng.standard_normal((2, 4, 4))),
                        dtype=torch.float32)
    got = tmm.kernel_offsets(nodes, l, BF16)
    for m in range(5):
        for b in range(2):
            for i in range(4):
                t = np.float32(nodes[m, 0]) * np.float32(l[b, i, 0])
                for j in range(1, i + 1):
                    t = np.float32(t + np.float32(nodes[m, j])
                                   * np.float32(l[b, i, j]))
                want = torch.tensor(t).to(BF16).float()
                assert got[m, b, i] == want


@pytest.fixture(scope="module")
def fused_setup():
    n, dim_x = 8, 2
    problems = _problems(n, dim_x, range(3))
    jops = _jax_operands(problems, JaxConfig(chain_impl="lanes"))
    graph, state = _port(problems)
    return problems, jops, graph, state, fused_operands(graph), n, 2 * dim_x


def test_trial_costs_plain_matches_jax_kernel_bf16(fused_setup):
    """K5's plain version with bfloat16 offsets against the JAX kernel in
    interpret mode with ``eval_dtype=bfloat16`` (the JAX kernel leaves a
    negative linear cost unpoisoned: poisoned here before comparing)."""
    problems, jops, _, _, tops, n, s = fused_setup
    x = _inputs(problems, n, s, np.random.default_rng(n))
    ld, fc_nl, fc_lin = jft.trial_costs_lanes(
        *map(jnp.asarray, x), *jops, interpret=True, eval_dtype=jnp.bfloat16)
    t_ld, t_fc = tft.trial_costs_lanes(*map(torch.as_tensor, x), *tops,
                                       eval_dtype=BF16)
    _close(t_ld.numpy(), np.asarray(ld).T)
    _close(t_fc[0].numpy(), np.moveaxis(np.asarray(fc_nl[0]), 1, 0))
    for got, want in zip(t_fc[1:], fc_lin):
        want = np.moveaxis(np.asarray(want), 1, 0)
        _close(got.numpy(), np.where(want < 0, np.nan, want))
    full = tft.trial_costs_plain(*map(torch.as_tensor, x), *tops)[1][0]
    assert not torch.equal(t_fc[0].nan_to_num(), full.nan_to_num())


def _gradient_inputs(state, n, s):
    rng = np.random.default_rng(n)
    mu = state.mu.numpy() + 0.05 * rng.standard_normal(state.mu.shape)
    q = rng.standard_normal((3, n, s, s))
    pd = state.precision.diag.numpy() + 0.2 * q @ np.swapaxes(q, -1, -2)
    po = 0.3 * rng.standard_normal((3, n - 1, s, s))
    return mu, pd, po, np.array([1.0, 2.0, 10.0])


def test_gradient_plain_matches_jax_kernel_bf16(fused_setup):
    """K6's plain version with bfloat16 offsets in its three modes against
    the JAX kernel in interpret mode: ``full``, then ``accum`` over the
    nonlinear factors and ``solve`` on that partial sum."""
    _, jops, _, state, tops, n, s = fused_setup
    x = _gradient_inputs(state, n, s)
    jx, tx = tuple(map(jnp.asarray, x)), tuple(map(torch.as_tensor, x))
    want = jfg.gradient_lanes(*jx, *jops, interpret=True,
                              eval_dtype=jnp.bfloat16)
    got = tfg.gradient_lanes(*tx, *tops, eval_dtype=BF16)
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w))
    jnl_specs, jlin_specs, jnl, jlin = jops
    nl_specs, lin_specs, nl, lin = tops
    jpart = jfg.gradient_lanes(*jx, jnl_specs, (), jnl, (), interpret=True,
                               eval_dtype=jnp.bfloat16, mode="accum")
    tpart = tfg.gradient_lanes(*tx, nl_specs, (), nl, (), mode="accum",
                               eval_dtype=BF16)
    for g, w in zip(tpart, jpart):
        _close(g.numpy(), np.asarray(w))
    want = jfg.gradient_lanes(*jx, (), jlin_specs, (), jlin, interpret=True,
                              mode="solve", seeds=jpart)
    got = tfg.gradient_lanes(*tx, (), lin_specs, (), lin, mode="solve",
                             seeds=tuple(tpart))
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w))
    plain = tfg.gradient_lanes(*tx, nl_specs, (), nl, (), mode="accum")
    assert not torch.equal(plain[0], tpart[0])


@functools.lru_cache(maxsize=None)
def _problems4():
    return tuple(build_chain_estimation(num_states=6, dim_x=2, gh_degree=4,
                                        seed=seed)[:2] for seed in range(3))


@functools.lru_cache(maxsize=None)
def _runs(name, port_fields=()):
    cfg = dict(niters=4, niters_lowtemp=2, step_size_base=0.9,
               moments_eval_dtype=name)
    return run_both(list(_problems4()), cfg, dict(cfg, **dict(port_fields)))


@pytest.mark.parametrize("name,port_fields", [
    ("bfloat16", ()),
    # the fused kernels' plain versions, offsets in the kernel's order
    ("bfloat16", (("fused_trials", "on"), ("fused_gradient", "on"))),
    ("float16", ()),
])
def test_quantized_loop_matches_jax(name, port_fields):
    """The NGD loop with ``moments_eval_dtype`` against
    ``jax.vmap(optimize)`` with the same option (three problems, a
    scheduled switch at iteration 2): the same costs and accepted steps."""
    jstate, jhist, state, hist = _runs(name, port_fields)
    np.testing.assert_allclose(hist.cost.numpy(), np.asarray(jhist.cost),
                               rtol=1e-9)
    np.testing.assert_array_equal(hist.accepted_step.numpy(),
                                  np.asarray(jhist.accepted_step))
    np.testing.assert_allclose(state.mu.numpy(), np.asarray(jstate.mu),
                               atol=1e-9)
    np.testing.assert_allclose(state.precision.diag.numpy(),
                               np.asarray(jstate.precision.diag), atol=1e-9)


@pytest.mark.parametrize("method", ["cholesky", "eigh"])
def test_sigma_points_and_eval_phi_match_jax(problem, method):  # noqa: F811
    """``sigma_points`` (Cholesky or symmetric-root placement) and
    ``eval_phi`` over them, against the JAX package's (sigma axis first
    in the port, [K, M, d] in JAX)."""
    jfb, tfb, mu, cov, leaves = problem
    jl = {k: jnp.asarray(v) for k, v in leaves.items()}
    want = jax.vmap(lambda m, c: jmm.sigma_points(jfb.nodes, m, c, method))(
        jnp.asarray(mu), jnp.asarray(cov))                    # [B, K, M, d]
    got = tmm.sigma_points(tfb.nodes, torch.as_tensor(mu),
                           torch.as_tensor(cov), method)      # [M, B, K, d]
    np.testing.assert_allclose(got.permute(1, 2, 0, 3).numpy(),
                               np.asarray(want), rtol=1e-12, atol=1e-12)
    phi = tmm.eval_phi(tfb.cost_fn, got,
                       {k: torch.as_tensor(v) for k, v in leaves.items()})
    jphi = jax.vmap(lambda p, q: jmm.eval_phi(jfb.cost_fn, p, q))(want, jl)
    np.testing.assert_allclose(phi.permute(1, 2, 0).numpy(), np.asarray(jphi),
                               rtol=1e-12, atol=1e-12)
