"""PyTorch port, the log-depth chain (``ops/parallel_chain.py``,
``chain_impl="assoc"``): the Hillis-Steele scan's pivots, covariance, log
det and solve against the JAX package's ``lax.associative_scan`` versions
and against the port's sequential sweeps; ``optimize`` with
``chain_impl="assoc"`` against ``jax.vmap(optimize)``; how ``"auto"``
resolves the chain, as JAX's ``resolve_chain_impl`` does (CPU, f64)."""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gaussianvi_tpu.inference import GVIConfig as JaxConfig  # noqa: E402
from gaussianvi_tpu.inference.optimize import resolve_chain_impl  # noqa: E402
from gaussianvi_tpu.ops import parallel_chain as jpc  # noqa: E402
from gaussianvi_tpu.ops.blocktridiag import BlockTridiag as JaxBlockTridiag  # noqa: E402
from gaussianvi_tpu_torch import GVIConfig, optimize, parallel  # noqa: E402
from gaussianvi_tpu_torch.inference.engine import LocalEngine  # noqa: E402
from gaussianvi_tpu_torch.ops import parallel_chain as pc  # noqa: E402
from gaussianvi_tpu_torch.ops.blocktridiag import (  # noqa: E402
    BlockTridiag,
    gbp_covariance_logdet,
    logdet,
    solve,
)
from gaussianvi_tpu_torch.parallel.sharding import FactorShardEngine  # noqa: E402
from test_torch_slice import CPU, assert_same_run, run_both  # noqa: E402

CARD = torch.device("cuda")
SIZES = [1, 2, 5, 33]
BLOCKS = [1, 2, 4, 6]


def spd_chain(n, s, seed, lead=()):
    """An SPD block-tridiagonal ``A = J J^T`` (J block lower bidiagonal,
    diagonal blocks of unit to two scale, small couplings) and a rhs."""
    rng = np.random.default_rng(seed)
    lo = (np.eye(s) * rng.uniform(1.0, 2.0, (*lead, n, 1, s))
          + 0.2 * np.tril(rng.standard_normal((*lead, n, s, s)), -1))
    c = 0.3 * rng.standard_normal((*lead, max(n - 1, 0), s, s))
    diag = lo @ np.swapaxes(lo, -1, -2)
    diag[..., 1:, :, :] += c @ np.swapaxes(c, -1, -2)
    off = lo[..., :-1, :, :] @ np.swapaxes(c, -1, -2)
    return diag, off, rng.standard_normal((*lead, n, s))


@pytest.mark.parametrize("s", BLOCKS)
@pytest.mark.parametrize("n", SIZES)
def test_assoc_matches_jax_and_seq(n, s):
    """Pivots, covariance blocks, log det and solve: against JAX's
    associative scans to 1e-12 (another reduction order) and against the
    port's sequential sweeps to the JAX package's own assoc-vs-seq
    tolerances (tests/test_parallel_chain.py)."""
    diag, off, rhs = spd_chain(n, s, 10 * n + s)
    a = BlockTridiag(torch.as_tensor(diag), torch.as_tensor(off))
    ja = JaxBlockTridiag(jnp.asarray(diag), jnp.asarray(off))
    got = dict(fwd=pc.forward_pivots(a), bwd=pc.backward_pivots(a),
               logdet=pc.logdet_assoc(a),
               x=pc.solve_assoc(a, torch.as_tensor(rhs)))
    got["cov_diag"], got["cov_off"], got["ld"] = (
        pc.gbp_covariance_logdet_assoc(a))
    want = dict(fwd=jpc.forward_pivots(ja), bwd=jpc.backward_pivots(ja),
                logdet=jpc.logdet_assoc(ja),
                x=jpc.solve_assoc(ja, jnp.asarray(rhs)))
    want["cov_diag"], want["cov_off"], want["ld"] = (
        jpc.gbp_covariance_logdet_assoc(ja))
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-12, err_msg=k)
    cd, co, ld = gbp_covariance_logdet(a)
    torch.testing.assert_close(got["cov_diag"], cd, rtol=0, atol=1e-12)
    torch.testing.assert_close(got["cov_off"], co, rtol=0, atol=1e-12)
    torch.testing.assert_close(got["ld"], ld, rtol=0, atol=1e-10)
    torch.testing.assert_close(got["logdet"], logdet(a), rtol=0, atol=1e-10)
    torch.testing.assert_close(got["x"], solve(a, torch.as_tensor(rhs)),
                               rtol=0, atol=1e-10)


def test_assoc_leading_axes_are_independent_problems():
    """A [2, 3] batch of chains through the scans equals each chain on its
    own, bit for bit: nothing reduces over a leading axis."""
    diag, off, rhs = (torch.as_tensor(x) for x in spd_chain(9, 4, 3, (2, 3)))
    a = BlockTridiag(diag, off)
    batched = (*pc.gbp_covariance_logdet_assoc(a), pc.solve_assoc(a, rhs))
    for i in range(2):
        for j in range(3):
            one = BlockTridiag(diag[i, j], off[i, j])
            single = (*pc.gbp_covariance_logdet_assoc(one),
                      pc.solve_assoc(one, rhs[i, j]))
            for b, o in zip(batched, single):
                assert torch.equal(b[i, j], o)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 9])
def test_associative_scan_is_an_inclusive_prefix(n):
    """The doubling scan of a non-commutative composition (matrix
    products, later applied after earlier) against the sequential fold."""
    rng = np.random.default_rng(n)
    m = torch.as_tensor(rng.standard_normal((2, n, 3, 3)))

    def compose(a, b):
        return (b[0] @ a[0],)

    (got,) = pc.associative_scan(compose, (m,), (-3,))
    acc = m[:, 0]
    torch.testing.assert_close(got[:, 0], acc, rtol=0, atol=0)
    for i in range(1, n):
        acc = m[:, i] @ acc
        torch.testing.assert_close(got[:, i], acc, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def problems():
    from test_torch_slice import build_chain_estimation

    return [build_chain_estimation(num_states=8, dim_x=2, gh_degree=4,
                                   seed=seed)[:2] for seed in range(4)]


_LOOP = dict(niters=5, niters_lowtemp=5)


def _assoc_cfg(method):
    return dict(_LOOP, chain_impl="assoc",
                step_size_base=0.9 if method == "ngd" else 0.1)


@pytest.fixture(scope="module")
def assoc_runs(problems):
    """``run_both`` with ``chain_impl="assoc"`` in both packages, per
    method (computed on demand)."""
    cache = {}

    def run(method):
        if method not in cache:
            cfg = _assoc_cfg(method)
            cache[method] = run_both(problems, cfg, cfg, method)
        return cache[method]

    return run


@pytest.mark.parametrize("method", ["ngd", "prox"])
def test_optimize_assoc_matches_jax(assoc_runs, method):
    """``chain_impl="assoc"`` in both packages: four flagship problems, the
    bench's settings (prox at a step it accepts)."""
    assert_same_run(*assoc_runs(method), _LOOP["niters"])


def test_auto_with_a_low_threshold_runs_assoc_as_jax(problems, assoc_runs):
    """``"auto"`` with ``assoc_threshold`` at or below N resolves to the
    scans off the card in both packages (JAX's ``resolve_chain_impl``):
    the port's run is its ``"assoc"`` run bit for bit, and JAX's
    ``"assoc"`` run to the slice's tolerances."""
    cfg = dict(_assoc_cfg("ngd"), chain_impl="auto", assoc_threshold=8)
    assert resolve_chain_impl(JaxConfig(**cfg), 8) == "assoc"
    graph_b, state_b = _batch(problems)
    state, hist = optimize(graph_b, state_b, GVIConfig(**cfg))
    jstate, jhist, _, ref = assoc_runs("ngd")
    assert_same_run(jstate, jhist, state, hist, _LOOP["niters"])
    for a, b in zip(hist, ref):
        assert torch.equal(a, b)


def _batch(problems):
    from test_torch_slice import describe

    from gaussianvi_tpu_torch import stack_problems
    from gaussianvi_tpu_torch.convert import graph_from_arrays, state_from_arrays

    described = [describe(g, s) for g, s in problems]
    return stack_problems(
        [graph_from_arrays(d, device=CPU) for d, _ in described],
        [state_from_arrays(s, device=CPU) for _, s in described])


def _graph(problems, block=None):
    """One flagship problem's graph, or (``block``) an s = ``block`` chain
    of eight states with linear factors only."""
    from test_torch_engine_resolution import _six_dim_problem
    from test_torch_slice import describe

    from gaussianvi_tpu_torch.convert import graph_from_arrays

    problem = (problems[0] if block is None
               else _six_dim_problem(8, 0, dim_x=block // 2))
    return graph_from_arrays(describe(*problem)[0], device=CPU)


@pytest.mark.parametrize("device,threshold,block,want", [
    # off the card: the threshold decides, as JAX's rule does off the TPU
    ("cpu", 8, None, "assoc"),
    ("cpu", 9, None, "seq"),
    # on the card the chain kernels where they cover the block size...
    ("cuda", 8, None, "lanes"),
    # ... else the threshold again (s = 8 has no chain kernel)
    ("cuda", 8, 8, "assoc"),
    ("cuda", 9, 8, "seq"),
])
def test_auto_chain_resolution(problems, device, threshold, block, want):
    """The engine's resolution (built for the card on CPU tensors: it
    launches nothing), the quadrature following the resolved chain, and
    the factor-parallel engine resolving the same way; off the card
    against JAX's ``resolve_chain_impl``."""
    graph = _graph(problems, block)
    assert graph.state_dim == (block or 4)
    cfg = GVIConfig(assoc_threshold=threshold)
    eng = LocalEngine(graph, cfg, torch.device(device))
    assert eng.chain_impl == want
    # the quadrature follows the chain, and the fused kernels it
    assert eng.quad_batches == (want == "lanes",) * len(graph.nonlinear)
    assert (eng.plan(cfg, "ngd").trials == "fused") == (
        want == "lanes" and block is None)
    shard = FactorShardEngine(graph, cfg, torch.device(device),
                              SimpleNamespace(fp=2))
    assert shard.chain_impl == want
    if device == "cpu":
        assert resolve_chain_impl(
            JaxConfig(assoc_threshold=threshold), graph.num_states) == want


def test_assoc_keeps_the_plain_quadrature_and_refuses_fused_on(problems):
    """As in JAX: ``chain_impl="assoc"`` with ``quad_impl="auto"`` takes
    the plain quadrature, so ``fused_*="on"`` raises; an unknown chain
    implementation raises ``ValueError``."""
    graph = _graph(problems)
    eng = LocalEngine(graph, GVIConfig(chain_impl="assoc"), CARD)
    assert (eng.chain_impl, eng.quad_batches, eng.fused_trials_ready,
            eng.fused_gradient_ready) == (
                "assoc", (False,) * len(graph.nonlinear), False, False)
    for field in ("fused_trials", "fused_gradient"):
        with pytest.raises(ValueError, match="'assoc'"):
            LocalEngine(graph, GVIConfig(chain_impl="assoc", **{field: "on"}),
                        CARD)
    with pytest.raises(ValueError, match="unknown chain_impl"):
        LocalEngine(graph, GVIConfig(chain_impl="scan"), CPU)


def test_optimize_sharded_assoc_is_the_local_assoc_run(problems):
    """On the 1 x 1 mesh ``optimize_sharded(chain_impl="assoc")`` is
    ``optimize(chain_impl="assoc")`` bit for bit."""
    graph_b, state_b = _batch(problems)
    cfg = GVIConfig(niters=3, step_size_base=0.9, chain_impl="assoc")
    _, got = parallel.optimize_sharded(graph_b, state_b, cfg,
                                       parallel.make_mesh(1, 1))
    _, want = optimize(graph_b, state_b, cfg)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
