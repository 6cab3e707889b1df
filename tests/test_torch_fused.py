"""PyTorch port, the fused NGD path: the plain versions of the fused trial
kernel (K5) and the fused gradient kernel (K6) against the JAX kernels in
Pallas interpret mode, the fused slice against the JAX package's
interpreted fused path, the guards the port keeps where the JAX fused
kernel drops them, and the eligibility errors (CPU, f64)."""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gaussianvi_tpu.examples.chain_estimation import (  # noqa: E402
    build_chain_estimation as jax_build,
)
from gaussianvi_tpu.factors import moments as jmm  # noqa: E402
from gaussianvi_tpu.inference import GVIConfig as JaxConfig  # noqa: E402
from gaussianvi_tpu.inference.engine import LocalEngine as JaxEngine  # noqa: E402
from gaussianvi_tpu.inference.optimize import optimize as jax_optimize  # noqa: E402
from gaussianvi_tpu.kernels import fused_gradient as jfg  # noqa: E402
from gaussianvi_tpu.kernels import fused_trials as jft  # noqa: E402
from gaussianvi_tpu.parallel.sharding import stack_problems as jax_stack  # noqa: E402
from gaussianvi_tpu_torch import GVIConfig, optimize, stack_problems  # noqa: E402
from gaussianvi_tpu_torch.convert import (  # noqa: E402
    graph_from_arrays,
    state_from_arrays,
)
from gaussianvi_tpu_torch.inference.engine import fused_operands  # noqa: E402
from gaussianvi_tpu_torch.kernels import fused_gradient as tfg  # noqa: E402
from gaussianvi_tpu_torch.kernels import fused_trials as tft  # noqa: E402
from test_torch_slice import CONFIGS, describe  # noqa: E402

CPU = torch.device("cpu")

ATOL = 1e-10
B = 3


def _problems(n, dim_x, seeds):
    return [jax_build(num_states=n, dim_x=dim_x, gh_degree=4, seed=seed)[:2]
            for seed in seeds]


def _port(problems):
    """The port's stacked graph and state for the JAX problems."""
    described = [describe(g, s) for g, s in problems]
    return stack_problems([graph_from_arrays(d, device=CPU) for d, _ in described],
                          [state_from_arrays(s, device=CPU) for _, s in described])


def _jax_operands(problems, jcfg):
    """JAX fused operands of every problem, stacked over the problem axis
    as its batched kernels take them: ``(nl_specs, lin_specs, nl_arrays,
    lin_arrays)``; starts, nodes and weights are shared."""
    caches = [JaxEngine(g, jcfg)._fused_spec_cache for g, _ in problems]
    nl_specs, lin_specs = caches[0][:2]
    flats = [list(c[2]) for c in caches]

    def take(shared):
        col = [f.pop(0) for f in flats]
        return col[0] if shared else jnp.stack(col)

    nl_arrays, lin_arrays = [], []
    for sp in nl_specs:
        st = take(True) if sp.slice_offset is None else None
        nodes, w = take(True), take(True)
        leaves = tuple(take(False) for _ in sp.param_shapes)
        nl_arrays.append((st, nodes, w, leaves))
    for sp in lin_specs:
        st = take(True) if sp.slice_offset is None else None
        lin_arrays.append((st, *(take(False) for _ in range(4))))
    return nl_specs, lin_specs, tuple(nl_arrays), tuple(lin_arrays)


def _assert_same_operands(jops, tops):
    """The port's engine builds the JAX engine's fused operands."""
    _, _, jnl, jlin = jops
    _, _, tnl, tlin = tops
    for (_, jn, jw, jleaves), (_, tn, tw, tp) in zip(jnl, tnl):
        np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=0)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=0)
        packed = np.concatenate(
            [np.asarray(x).reshape(*x.shape[:2], -1) for x in jleaves], -1)
        np.testing.assert_allclose(tp.numpy(), packed, atol=0)
    for j, t in zip(jlin, tlin):
        for jx, tx in zip(j[1:], t[1:]):
            np.testing.assert_allclose(tx.numpy(), np.asarray(jx),
                                       rtol=1e-14, atol=1e-12)


def _inputs(problems, n, s, rng):
    """An iterate near each problem's start and a direction large enough
    that the longest trial steps leave the SPD cone on some problems."""
    mu = np.stack([np.asarray(p[1].mu) for p in problems])
    mu = mu + 0.1 * rng.standard_normal(mu.shape)
    q = rng.standard_normal((B, n, s, s))
    pd = 10.0 * np.eye(s) + 0.5 * q @ np.swapaxes(q, -1, -2)
    po = 0.5 * rng.standard_normal((B, n - 1, s, s))
    dmu = 0.5 * rng.standard_normal((B, n, s))
    dq = rng.standard_normal((B, n, s, s))
    dpd = 4.0 * (dq + np.swapaxes(dq, -1, -2))
    dpo = rng.standard_normal((B, n - 1, s, s))
    trials = 0.9 * 0.75 ** np.arange(1, 12)
    return mu, dmu, pd, po, dpd, dpo, trials


def _close(got, want, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("n,dim_x", [(8, 2), (5, 1)])
def test_trial_costs_plain_matches_jax_kernel(n, dim_x):
    """K5's plain version against the JAX kernel (interpret mode) on three
    problems, T = 11.  The JAX kernel leaves a negative linear cost as is;
    the port poisons it (the separate path's guard), applied here to the
    JAX values before comparing."""
    s = 2 * dim_x
    problems = _problems(n, dim_x, range(B))
    jops = _jax_operands(problems, JaxConfig(chain_impl="lanes"))
    graph, _ = _port(problems)
    tops = fused_operands(graph)
    _assert_same_operands(jops, tops)
    x = _inputs(problems, n, s, np.random.default_rng(n))

    ld, fc_nl, fc_lin = jft.trial_costs_lanes(
        *map(jnp.asarray, x), *jops, interpret=True)
    t_ld, t_fc = tft.trial_costs_plain(*map(torch.as_tensor, x), *tops)

    assert t_ld.shape == (11, B) and len(t_fc) == 3
    _close(t_ld.numpy(), np.asarray(ld).T)
    assert np.isnan(t_ld.numpy()).any() and np.isfinite(t_ld.numpy()).any()
    want_nl = np.moveaxis(np.asarray(fc_nl[0]), 1, 0)
    _close(t_fc[0].numpy(), want_nl)
    for got, want in zip(t_fc[1:], fc_lin):
        want = np.moveaxis(np.asarray(want), 1, 0)
        _close(got.numpy(), np.where(want < 0, np.nan, want))


@pytest.mark.parametrize("n,dim_x", [(8, 2), (5, 1)])
def test_gradient_plain_matches_jax_kernel(n, dim_x):
    """K6's plain version against the JAX kernel (interpret mode, mode
    "full"): three problems, one at its initial iterate (indefinite Vddmu:
    the main solve's NaN pattern must agree), per-problem temperatures."""
    s = 2 * dim_x
    problems = _problems(n, dim_x, range(B))
    jops = _jax_operands(problems, JaxConfig(chain_impl="lanes"))
    graph, state = _port(problems)
    tops = fused_operands(graph)
    rng = np.random.default_rng(n)
    mu = state.mu.numpy().copy()
    mu[1:] += 0.05 * rng.standard_normal(mu[1:].shape)
    q = rng.standard_normal((B, n, s, s))
    pd = state.precision.diag.numpy() + 0.2 * q @ np.swapaxes(q, -1, -2)
    pd[0] = state.precision.diag[0].numpy()
    po = 0.3 * rng.standard_normal((B, n - 1, s, s))
    po[0] = 0.0
    temp = np.array([1.0, 2.0, 10.0])
    x = (mu, pd, po, temp)

    want = jfg.gradient_lanes(*map(jnp.asarray, x), *jops, interpret=True)
    got = tfg.gradient_plain(*map(torch.as_tensor, x), *tops)
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w))
    assert np.isfinite(got[6].numpy()).all()
    if dim_x == 2:      # the flagship's initial Vddmu is indefinite
        assert np.isnan(got[5][0].numpy()).all()


def _jax_run(problems, cfg):
    graph_b, state_b = jax_stack([p[0] for p in problems],
                                 [p[1] for p in problems])
    jcfg = JaxConfig(chain_impl="lanes", **cfg)
    return jax.jit(jax.vmap(lambda g, s: jax_optimize(g, s, jcfg)))(
        graph_b, state_b)


def _assert_runs_match(state, hist, jstate, jhist):
    np.testing.assert_allclose(hist.cost.numpy(), np.asarray(jhist.cost),
                               rtol=1e-9)
    np.testing.assert_allclose(hist.factor_costs.numpy(),
                               np.asarray(jhist.factor_costs), rtol=1e-9)
    np.testing.assert_array_equal(hist.accepted_step.numpy(),
                                  np.asarray(jhist.accepted_step))
    np.testing.assert_allclose(hist.cov_diag.numpy(),
                               np.asarray(jhist.cov_diag), atol=1e-9)
    np.testing.assert_allclose(state.mu.numpy(), np.asarray(jstate.mu),
                               atol=1e-9)
    np.testing.assert_allclose(state.precision.diag.numpy(),
                               np.asarray(jstate.precision.diag), atol=1e-9)
    np.testing.assert_allclose(state.precision.off.numpy(),
                               np.asarray(jstate.precision.off), atol=1e-9)


@pytest.fixture(scope="module")
def slice_problems():
    return _problems(8, 2, range(4))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fused_slice_matches_jax_fused_path(slice_problems, name):
    """``optimize`` with both fused kernels (their plain versions on the
    CPU) against ``jax.vmap(optimize)`` on the JAX package's interpreted
    fused path (``chain_impl="lanes"``), four different problems."""
    cfg = CONFIGS[name]
    jstate, jhist = _jax_run(slice_problems, cfg)
    graph, state0 = _port(slice_problems)
    state, hist = optimize(graph, state0, GVIConfig(
        fused_trials="on", fused_gradient="on", **cfg))
    _assert_runs_match(state, hist, jstate, jhist)
    assert len({tuple(r) for r in np.asarray(jhist.cost).round(6)}) == 4


@pytest.mark.parametrize("trials,gradient", [("on", "off"), ("off", "on")])
def test_one_fused_kernel_matches_separate_path(slice_problems, trials,
                                                gradient):
    """Trials-only (the accepted iterate's covariance recomputed by one
    chain call) and gradient-only (the trial covariances carried, the
    kernel's recorded) against the port's separate path."""
    cfg = dict(niters=6, niters_lowtemp=3, step_size_base=0.9)
    graph, state0 = _port(slice_problems)
    ref_state, ref = optimize(graph, state0, GVIConfig(**cfg))
    state, hist = optimize(graph, state0, GVIConfig(
        fused_trials=trials, fused_gradient=gradient, **cfg))
    _assert_runs_match(state, hist, ref_state, ref)


def test_guards_depart_from_jax_fused_kernel():
    """Where the JAX fused trial kernel returns an unguarded value the port
    agrees with the JAX separate path instead: a negative closed-form
    linear cost (anchor constant -1) and a nonnegative cost's E[phi] inside
    the 4096-ulp band (a rule of two nodes at the mean, weights 1 and
    -1 - 1e-13) are NaN."""
    n, dim_x, delta = 3, 1, 1e-13
    (graph, init), = _problems(n, dim_x, [0])
    anchor = replace(graph.linear[0], constant=-graph.linear[0].constant)
    fb = graph.nonlinear[0]
    m = fb.nodes.shape[0]
    weights = jnp.zeros((m,)).at[0].set(1.0).at[1].set(-1.0 - delta)
    fb = replace(fb, nodes=jnp.zeros_like(fb.nodes), weights=weights)
    graph = replace(graph, nonlinear=(fb,), linear=(anchor,) + graph.linear[1:])
    problems = [(graph, init)] * B
    jops = _jax_operands(problems, JaxConfig(chain_impl="lanes"))
    tops = fused_operands(_port(problems)[0])
    x = list(_inputs(problems, n, 2 * dim_x, np.random.default_rng(1)))
    x[4] = 0.01 * x[4]                     # trial precisions stay SPD
    x[6] = x[6][:2]

    ld, jnl, jlin = jft.trial_costs_lanes(*map(jnp.asarray, x), *jops,
                                          interpret=True)
    t_ld, t_fc = tft.trial_costs_plain(*map(torch.as_tensor, x), *tops)
    assert np.isfinite(np.asarray(ld)).all()
    _close(t_ld.numpy(), np.asarray(ld).T)
    # nonneg band: the JAX kernel returns -delta * phi(mu) < 0
    assert (np.asarray(jnl[0]) < 0).all()
    assert np.isnan(t_fc[0].numpy()).all()
    mu_t = x[0][0, :, :] + x[6][0] * x[1][0]
    want = jmm.expectation_phi(fb.nodes, fb.weights, jnp.asarray(mu_t),
                               jnp.broadcast_to(jnp.eye(2), (n, 2, 2)),
                               fb.cost_fn, fb.params, nonneg=True)
    assert np.isnan(np.asarray(want)).all()
    # negative anchor cost: JAX kernel finite and negative, port NaN, as
    # the separate path's guarded linear_cost
    assert (np.asarray(jlin[0]) < 0).all()
    assert np.isnan(t_fc[1].numpy()).all()
    want = jmm.linear_cost(anchor.lam, anchor.psi, anchor.target_mu,
                           anchor.target_prec, anchor.constant,
                           jnp.asarray(mu_t[:1]), jnp.eye(2)[None])
    assert np.isnan(np.asarray(want)).all()
    _close(t_fc[2].numpy(), np.moveaxis(np.asarray(jlin[1]), 1, 0))


def _without_kernel_cost(graph):
    return replace(graph, nonlinear=tuple(
        replace(fb, kernel_cost=None, kernel_params=None)
        for fb in graph.nonlinear))


def _jax_without_lanes_cost(graph):
    return replace(graph, nonlinear=tuple(
        replace(fb, lanes_cost=None) for fb in graph.nonlinear))


@pytest.mark.parametrize("fields,strip", [
    (dict(fused_trials="on", chain_impl="seq"), False),
    (dict(fused_gradient="on", chain_impl="seq"), False),
    (dict(fused_trials="on", quad_impl="xla"), False),
    (dict(fused_gradient="on", quad_impl="xla"), False),
    (dict(fused_trials="on"), True),
    (dict(fused_gradient="on"), True),
    (dict(fused_trials="on", linesearch="seq"), False),
])
def test_fused_on_raises_where_jax_raises(slice_problems, fields, strip):
    """``"on"`` asserts eligibility: ValueError where the JAX engine
    raises (chain or quadrature forced to the plain path, a nonlinear
    batch without a kernel cost, trials with the sequential search)."""
    g, s = slice_problems[0]
    jcfg = dict(fields)
    jcfg.setdefault("chain_impl", "lanes")
    with pytest.raises(ValueError):
        JaxEngine(_jax_without_lanes_cost(g) if strip else g,
                  JaxConfig(niters=1, **jcfg))
    d, st = describe(g, s)
    graph = graph_from_arrays(d, device=CPU)
    with pytest.raises(ValueError, match="fused"):
        optimize(_without_kernel_cost(graph) if strip else graph,
                 state_from_arrays(st, device=CPU), GVIConfig(niters=1, **fields))


def test_auto_keeps_the_separate_path_on_cpu(slice_problems):
    """``"auto"`` takes the fused kernels only where the chain and
    quadrature run the kernels (GPU tensors), as JAX only off-TPU."""
    from gaussianvi_tpu_torch.inference.engine import LocalEngine

    graph, _ = _port(slice_problems)
    eng = LocalEngine(graph, GVIConfig(), torch.device("cpu"))
    assert not eng.fused_trials_ready and not eng.fused_gradient_ready
    eng = LocalEngine(graph, GVIConfig(fused_trials="on"), torch.device("cpu"))
    assert eng.fused_trials_ready and not eng.fused_gradient_ready
    with pytest.raises(ValueError, match="unknown mode"):
        tfg.gradient_lanes(None, None, None, None, (), (), (), (),
                           mode="half")


# ---------------------------------------------------------------------------
# what the wrappers hand the kernels: layout, per-state index, block plans
# ---------------------------------------------------------------------------

def _read(ptr, count, dtype):
    """``count`` values at address ``ptr``, as a kernel reads them."""
    import ctypes

    ctype = {np.float64: ctypes.c_double, np.int32: ctypes.c_int}[dtype]
    return np.ctypeslib.as_array((ctype * count).from_address(ptr)).copy()


def _dynamic_operands(graph):
    """The fused operands with the nonlinear batch cut to five factors in
    another order than their states (dynamic starts, bare states)."""
    nl_specs, lin_specs, nl_arrays, lin_arrays = fused_operands(graph)
    sp, (start, nodes, weights, params) = nl_specs[0], nl_arrays[0]
    keep = torch.tensor([4, 1, 5, 0, 4])
    return ((sp._replace(k=len(keep), slice_offset=None),), lin_specs,
            ((start[keep], nodes, weights, params[:, keep]),), lin_arrays)


def _check_index(sp, start, p_index, n):
    """A batch's support as ``for_factors_at`` finds it: the per-state
    index, ascending k within a state, for a slice of states too."""
    index = _read(p_index, n + 1 + sp.k, np.int32)
    for i in range(n):
        got = index[n + 1 + index[i]:n + 1 + index[i + 1]]
        assert got.tolist() == [kk for kk in range(sp.k)
                                if int(start[kk]) == i]


@pytest.mark.parametrize("dynamic", [False, True])
def test_packed_factor_operands_read_back(slice_problems, dynamic):
    """``factor_args`` hands the kernels the engine's tensors as they are
    (problem-major, no copy) plus each batch's per-state index.  A
    reader that indexes the packed pointers as ``csrc/fused.cuh`` does
    (``load_params``, ``lin_residual``, ``load_a``, ``for_factors_at``)
    gets back exactly what the plain versions are given."""
    graph, state = _port(slice_problems)
    ops = _dynamic_operands(graph) if dynamic else fused_operands(graph)
    nl_specs, lin_specs, nl_arrays, lin_arrays = ops
    b, n, s = state.mu.shape
    nt = 3
    fa = tft.factor_args("t", state.mu, *ops, rows=nt * b)
    assert (fa.n_nl, fa.n_lin) == (len(nl_specs), len(lin_specs))
    fixed = 0
    for j, (sp, (start, nodes, weights, params)) in enumerate(
            zip(nl_specs, nl_arrays)):
        np_, ni = tft.NL_PTRS, tft.NL_INTS
        p_nodes, p_w, p_params, p_index, p_fc, p_field = (
            fa.nl_ptrs[np_ * j:np_ * j + 6])
        k, m, nonneg, rdim, rows, cols, depth = fa.nl_ints[ni * j:ni * j + 7]
        assert (k, m, nonneg, rdim) == (sp.k, sp.m, int(sp.nonneg),
                                        s if sp.rdim is None else sp.rdim)
        # the range cost reads no field
        assert (p_field, rows, cols, depth) == (None, 0, 0, 0)
        # no re-laying: the kernel reads the caller's memory
        assert p_params == params.contiguous().data_ptr() or not \
            params.is_contiguous()
        assert p_nodes == nodes.data_ptr() and p_w == weights.data_ptr()
        n_par = params.shape[-1]
        flat = _read(p_params, b * k * n_par, np.float64)
        for bi in range(b):
            for kk in range(k):      # load_params: (b * K + k) * P + j
                at = (bi * k + kk) * n_par
                np.testing.assert_array_equal(flat[at:at + n_par],
                                              params[bi, kk].numpy())
        assert fa.fc[j].shape == (nt * b, k) and p_fc == fa.fc[j].data_ptr()
        fixed += m * (s + 1) * 8
        _check_index(sp, start, p_index, n)
    for j, (sp, (start, a, lam, pm, prec_c)) in enumerate(
            zip(lin_specs, lin_arrays)):
        p_a, p_lam, p_pm, p_prec, p_index, p_fc = fa.lin_ptrs[6 * j:6 * j + 6]
        span, k, ka, r = fa.lin_ints[4 * j:4 * j + 4]
        assert (span, k, ka, r) == (sp.nb, sp.k, sp.ka, sp.r)
        _check_index(sp, start, p_index, n)
        blocks, de = (3 if span == 2 else 1), span * s
        flat_a = _read(p_a, b * ka * blocks * s * s, np.float64)
        flat_lam = _read(p_lam, b * ka * r * de, np.float64)
        flat_pm = _read(p_pm, b * ka * r, np.float64)
        flat_prec = _read(p_prec, b * ka * r * r, np.float64)
        for bi in range(b):
            for kk in range(ka):
                for blk in range(blocks):   # load_a
                    at = ((bi * ka + kk) * blocks + blk) * s * s
                    np.testing.assert_array_equal(
                        flat_a[at:at + s * s].reshape(s, s),
                        a[bi, kk, blk].numpy())
                row0 = (bi * ka + kk) * r   # lin_residual
                np.testing.assert_array_equal(
                    flat_pm[row0:row0 + r], pm[bi, kk].numpy())
                np.testing.assert_array_equal(
                    flat_lam[row0 * de:(row0 + r) * de].reshape(r, de),
                    lam[bi, kk].numpy())
                np.testing.assert_array_equal(
                    flat_prec[row0 * r:(row0 + r) * r].reshape(r, r),
                    prec_c[bi, kk].numpy())
    assert fa.fixed_bytes == fixed


def test_state_index_is_built_once_per_start_tensor():
    start = torch.tensor([3, 0, 3, 1])
    index = tft.state_index(start, 5)
    assert index.dtype == torch.int32
    assert index.tolist() == [0, 1, 2, 2, 4, 4, 1, 3, 0, 2]
    assert tft.state_index(start, 5) is index
    assert tft.state_index(start, 6) is not index       # another chain
    start[0] = 2                                         # edited in place
    assert tft.state_index(start, 5).tolist() == [0, 1, 2, 3, 4, 4,
                                                  1, 3, 0, 2]


def test_the_iterate_reaches_the_kernels_as_it_is():
    """The engine's iterate is contiguous and problem-major already: the
    wrappers' ``.contiguous()`` hands the kernels the caller's memory, and
    the accumulators are views of the one buffer an all-reduce sums."""
    n = 6
    state = _port(_problems(n, 2, range(B)))[1]
    for x in (state.mu, state.precision.diag, state.precision.off):
        assert x.contiguous().data_ptr() == x.data_ptr()
    acc = tfg.Partials(B, n, 4, torch.float64, CPU, zero=True)
    assert [tuple(t.shape) for t in acc] == [
        (B, n, 4), (B, n, 4, 4), (B, n - 1, 4, 4)]
    assert all(t.is_contiguous() for t in acc)
    acc.buffer.add_(1.0)
    assert all(bool((t == 1.0).all()) for t in acc)
    assert acc[0].data_ptr() == acc.buffer.data_ptr()


# (n, s, itemsize, fixed bytes) -> (warps, scratch): the flagship in
# float32 and float64, a chain that fills shared memory alone, one too long
# for it
@pytest.mark.parametrize("n,s,size,fixed,warps,scratch", [
    (32, 4, 4, 580, 4, False),
    (32, 4, 8, 1160, 2, False),
    (32, 2, 8, 200, 4, False),
    (400, 4, 4, 580, 1, False),
    (600, 4, 4, 580, 4, True),
    (300, 4, 8, 1160, 4, True),
])
def test_gradient_block_plan(n, s, size, fixed, warps, scratch):
    plan = tfg.grad_plan("t", n, s, size, fixed)
    chain = n * (6 * (s * s + 1) + 4 * (s + 1))
    assert tfg.grad_chain_elems(n, s) == chain == plan.arena
    assert (plan.warps, plan.scratch) == (warps, scratch)
    if scratch:
        assert plan.smem == fixed
        assert fixed + chain * size > tft.SMEM_LIMIT
    else:
        assert plan.smem == fixed + warps * chain * size <= tft.SMEM_LIMIT
        if warps > 1:
            assert plan.smem <= tft.SMEM_TARGET


@pytest.mark.parametrize("n,s,nt,size,fixed,chunk,scratch", [
    (32, 4, 11, 4, 580, 11, False),      # the flagship: four blocks per SM
    (32, 4, 11, 8, 1160, 11, False),
    (32, 4, 40, 8, 1160, 24, False),     # more trials than fit: chunks
    (5, 2, 3, 8, 200, 3, False),
    (2000, 4, 11, 4, 580, 11, True),
])
def test_trial_block_plan(n, s, nt, size, fixed, chunk, scratch):
    plan = tft.trial_plan("t", n, s, nt, size, fixed)
    arena = (4 + 2 * chunk) * n * (s * s + 1)
    assert tft.trial_arena_elems(n, s, chunk) == arena == plan.arena
    assert (plan.warps, plan.chunk, plan.scratch) == (
        tft.TRIAL_WARPS, chunk, scratch)
    if scratch:
        assert plan.smem == fixed
        assert fixed + tft.trial_arena_elems(n, s, 1) * size > tft.SMEM_LIMIT
    else:
        assert plan.smem == fixed + arena * size <= tft.SMEM_LIMIT
        if chunk < nt:
            assert fixed + tft.trial_arena_elems(
                n, s, chunk + 1) * size > tft.SMEM_LIMIT
    if (n, s, nt, size) == (32, 4, 11, 4):
        # four blocks, each with its reserved KB, share an SM's 228 KB
        assert 4 * (plan.smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("plan", [
    lambda: tfg.grad_plan("K6", 32, 4, 4, tft.SMEM_LIMIT + 4),
    lambda: tft.trial_plan("K5", 32, 4, 11, 4, tft.SMEM_LIMIT + 4),
])
def test_rules_beyond_shared_memory_raise_with_the_numbers(plan):
    with pytest.raises(ValueError, match=str(tft.SMEM_LIMIT)):
        plan()
