"""PyTorch port, the Barfoot 1-D example (``examples/barfoot_1d.py``, N = 1,
s = 1) and the rest of ``ops/blocktridiag.py`` against the JAX package
(CPU, f64): the golden trajectories of ``tests/test_golden_1d.py`` (the
reference's committed 1-D results, atol 1e-9) and the JAX run itself, the
ported block-tridiagonal functions at s in {1, 2, 4, 14} and N in {1, 3, 8}
(1e-12), the plain GBP at s = 14 against the dense inverse, the chain
wrappers' arena arithmetic at s = 1 and s = 14, and ``"auto"`` resolving
the Barfoot graph to the chain kernels on the card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gaussianvi_tpu.examples import run_barfoot_1d as jax_run_barfoot  # noqa: E402
from gaussianvi_tpu.ops import blocktridiag as jbt  # noqa: E402
from gaussianvi_tpu_torch import GVIConfig  # noqa: E402
from gaussianvi_tpu_torch.examples import (  # noqa: E402
    build_barfoot_1d,
    run_barfoot_1d,
    run_chain_estimation,
)
from gaussianvi_tpu_torch.inference.engine import LocalEngine  # noqa: E402
from gaussianvi_tpu_torch.kernels import chain as tchain  # noqa: E402
from gaussianvi_tpu_torch.ops import blocktridiag as tbt  # noqa: E402
from test_golden_1d import (  # noqa: E402
    REF_NGD_COST,
    REF_NGD_COV,
    REF_NGD_MEAN,
    REF_PROX_COST,
    REF_PROX_COV,
    REF_PROX_MEAN,
)

CPU = torch.device("cpu")
GOLDEN = {"ngd": (REF_NGD_MEAN, REF_NGD_COV, REF_NGD_COST),
          "prox": (REF_PROX_MEAN, REF_PROX_COV, REF_PROX_COST)}


@pytest.mark.parametrize("method", ["ngd", "prox"])
def test_barfoot_matches_golden_and_jax(method):
    """NGD and prox reproduce the reference's golden mean, variance and
    cost (atol 1e-9, the JAX test's gate) and the JAX package's run (mean,
    covariance, precision, cost, factor costs, steps: 1e-12)."""
    _, hist = run_barfoot_1d(method, device=CPU)
    mean, cov, cost = GOLDEN[method]
    np.testing.assert_allclose(hist.mu[:, 0, 0].numpy(), mean, atol=1e-9)
    np.testing.assert_allclose(hist.cov_diag[:, 0, 0, 0].numpy(), cov,
                               atol=1e-9)
    np.testing.assert_allclose(hist.cost.numpy(), cost, atol=1e-9)
    _, jhist = jax_run_barfoot(method)
    for name in ("mu", "cov_diag", "prec_diag", "cost", "factor_costs",
                 "accepted_step"):
        np.testing.assert_allclose(getattr(hist, name).numpy(),
                                   np.asarray(getattr(jhist, name)),
                                   rtol=1e-12, atol=1e-12, err_msg=name)


def test_barfoot_ngd_cost_monotone_and_entropy():
    """The JAX golden test's other two checks: NGD's cost falls at every
    iteration, and the first cost is the factor cost plus 0.5 log det of
    the precision."""
    _, hist = run_barfoot_1d("ngd", device=CPU)
    assert bool((hist.cost[1:] < hist.cost[:-1]).all())
    assert hist.factor_costs.shape == (10, 1)
    np.testing.assert_allclose(
        float(hist.cost[0]),
        float(hist.factor_costs[0, 0]) + 0.5 * np.log(1.0 / 9.0), atol=1e-12)


def test_run_chain_estimation_matches_jax():
    """``run_chain_estimation`` (N = 4, three iterations) against the JAX
    package's at 1e-10."""
    from gaussianvi_tpu.examples import run_chain_estimation as jax_run

    kw = dict(num_states=4, dim_x=1, gh_degree=4, seed=3)
    _, hist = run_chain_estimation(device=CPU, **kw)
    _, jhist = jax_run(**kw)
    np.testing.assert_allclose(hist.cost.numpy(), np.asarray(jhist.cost),
                               rtol=1e-10)
    np.testing.assert_allclose(hist.mu.numpy(), np.asarray(jhist.mu),
                               rtol=1e-10, atol=1e-12)


def _random_btd(n, s, seed):
    """A random SPD block-tridiagonal matrix (diagonally dominated), as
    ``tests/test_blocktridiag.py`` draws it, in both packages."""
    rng = np.random.default_rng(seed)
    diag = rng.standard_normal((n, s, s))
    diag = diag @ diag.transpose(0, 2, 1) + (3.0 * s) * np.eye(s)
    off = 0.5 * rng.standard_normal((max(n - 1, 0), s, s))
    return (jbt.BlockTridiag(jnp.asarray(diag), jnp.asarray(off)),
            tbt.BlockTridiag(torch.tensor(diag), torch.tensor(off)))


@pytest.mark.parametrize("s", [1, 2, 4, 14])
@pytest.mark.parametrize("n", [1, 3, 8])
def test_blocktridiag_rest_matches_jax(n, s):
    """``logdet``, ``gbp_covariance``, ``from_dense``, ``matvec``, ``dim``
    and ``marginal_covariance_dense`` against the JAX functions at 1e-12
    (relative to each output's scale)."""
    ja, ta = _random_btd(n, s, 100 * n + s)
    x = np.random.default_rng(n + s).standard_normal(n * s)

    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * max(
            1.0, float(np.abs(want).max()) if want.size else 1.0))

    assert ta.dim == ja.dim == n * s
    close(tbt.logdet(ta), jbt.logdet(ja))
    for got, want in zip(tbt.gbp_covariance(ta), jbt.gbp_covariance(ja)):
        close(got, want)
    dense = tbt.marginal_covariance_dense(ta)
    close(dense, jbt.marginal_covariance_dense(ja))
    back = tbt.BlockTridiag.from_dense(ta.to_dense(), n)
    jback = jbt.BlockTridiag.from_dense(ja.to_dense(), n)
    close(back.diag, jback.diag)
    close(back.off, jback.off)
    close(ta.matvec(torch.tensor(x)), ja.matvec(jnp.asarray(x)))
    close(ta.matvec(torch.tensor(x.reshape(n, s))),
          ja.matvec(jnp.asarray(x.reshape(n, s))))
    # batched: two problems at once equal each alone
    both = tbt.BlockTridiag(torch.stack([ta.diag, 2 * ta.diag]),
                            torch.stack([ta.off, ta.off]))
    xb = torch.tensor(np.stack([x, -x]))
    close(both.matvec(xb)[1], tbt.BlockTridiag(2 * ta.diag, ta.off).matvec(
        torch.tensor(-x)).numpy())
    close(tbt.logdet(both)[0], jbt.logdet(ja))


@pytest.mark.parametrize("n", [1, 2, 20])
def test_plain_gbp_at_s14_matches_dense_inverse(n):
    """The plain version of K1 at s = 14 (its 28 x 28 edge joints through
    ``torch.linalg`` above the unroll limit) against the dense inverse,
    the reference's GBP harness (block dim 14, 20 states; atol 1e-10), and
    its log det against ``slogdet``."""
    _, ta = _random_btd(n, 14, 42 + n)
    cov_d, cov_o, ld = tbt.gbp_covariance_logdet(ta)
    dense = tbt.marginal_covariance_dense(ta).numpy()
    for i in range(n):
        blk = slice(14 * i, 14 * i + 14)
        np.testing.assert_allclose(cov_d[i].numpy(), dense[blk, blk],
                                   atol=1e-10)
        if i < n - 1:
            nxt = slice(14 * i + 14, 14 * i + 28)
            np.testing.assert_allclose(cov_o[i].numpy(), dense[blk, nxt],
                                       atol=1e-10)
    np.testing.assert_allclose(
        float(ld), np.linalg.slogdet(ta.to_dense().numpy())[1], rtol=1e-12)


# (n, s, itemsize) -> (K1, K2 arena bytes of a warp, K1, K2 work bytes):
# s = 1 carries 16 chains (32 systems) a warp on 2 lanes each, its arrays
# slot_pitch apart; s = 14 one chain or pair a warp, column-major blocks
# with columns 15 apart beside a fixed work area
WIDE_ARENAS = {(1, 1, 4): (256, 17024, 0, 0), (5, 1, 8): (4352, 20480, 0, 0),
               (10, 14, 4): (16800, 19200, 6840, 1680),
               (10, 14, 8): (33600, 38400, 13680, 3360)}


@pytest.mark.parametrize("n,s,size", sorted(WIDE_ARENAS))
def test_chain_arenas_at_s1_and_s14(n, s, size):
    """The wrappers' arena arithmetic at the new block sizes agrees with
    csrc/chain.cuh and chain_wide.cu: chains a warp, arena and work sizes,
    the scratch decision (the work area counted at s = 14), and both in
    ``BLOCK_SIZES``."""
    gbp, solve, gwork, swork = WIDE_ARENAS[n, s, size]
    assert s in tchain.BLOCK_SIZES and tchain.covers(s, torch.float64) is None
    assert tchain.chains_per_warp(s) == (16 if s == 1 else 1)
    assert tchain.gbp_warp_elems(n, s, size) * size == gbp
    assert tchain.solve_warp_elems(n, s, size) * size == solve
    assert tchain.chain_work_elems(s, False) * size == gwork
    assert tchain.chain_work_elems(s, True) * size == swork
    for arena, work in ((gbp, gwork), (solve, swork)):
        plan = tchain.chain_plan(arena // size, size, work // size)
        assert not plan.scratch and plan.smem == arena + work
    # the longest chain whose K1 arena fits shared memory beside the work
    # area takes shared memory, one state more the scratch route
    work = tchain.chain_work_elems(s, False)
    fit = max(m for m in range(1, 4000) if (
        work + tchain.gbp_warp_elems(m, s, size)) * size <= tchain.SMEM_LIMIT)
    for m, scratch in ((fit, False), (fit + 1, True)):
        plan = tchain.chain_plan(tchain.gbp_warp_elems(m, s, size), size,
                                 work)
        assert plan.scratch == scratch
        assert plan.smem == (work if scratch else work + plan.arena) * size


def test_auto_resolves_barfoot_to_the_chain_kernels():
    """On a card ``"auto"`` takes K1 / K2 at s = 1 and the plain quadrature
    (the factor is ``cost_fn``-only), as JAX's ``"lanes"`` does on the
    TPU; on the CPU the plain routes; ``"lanes"`` accepts the graph on the
    card and refuses the CPU."""
    graph, _, config = build_barfoot_1d(device=CPU)
    card = LocalEngine(graph, config, torch.device("cuda"))
    assert card.chain_impl == "lanes" and card.quad_batches == (False,)
    assert not card.fused_trials_ready and not card.fused_gradient_ready
    assert LocalEngine(graph, config, CPU).chain_impl != "lanes"
    lanes = GVIConfig(chain_impl="lanes")
    assert LocalEngine(graph, lanes,
                       torch.device("cuda")).chain_impl == "lanes"
    with pytest.raises(ValueError, match="CUDA kernels"):
        LocalEngine(graph, lanes, CPU)
