"""PyTorch port, K1's trial form at s = 14 (``kernels/chain.py``
``gbp_trials_lanes``, ``csrc/chain_wide.cu``
``gbp_wide_kernel<.., true>``): every line-search trial's chain from the
iterate, its direction and the steps, and the linear factors' costs from
the covariance blocks it writes.

On the CPU (float64): the plain form against the separate route's trial
step on the arm's linear batches, the arm's loop on the trial form against
the separate route, where the engine takes the trial form, and the linear
operands it shares with the fused kernels.  On a card (no JAX needed), the
kernel against K1 on the separate route's trial precisions, bit for bit,
and its costs against the separate route's:

    python -m pytest --noconftest -o addopts="" tests/test_torch_chain_trials.py -q
"""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gaussianvi_tpu_torch.examples import arm_planning as arm  # noqa: E402
from gaussianvi_tpu_torch.factors import moments as mm  # noqa: E402
from gaussianvi_tpu_torch.factors.priors import (  # noqa: E402
    fixed_prior,
    minimum_acc_prior,
)
from gaussianvi_tpu_torch.inference.config import GVIConfig  # noqa: E402
from gaussianvi_tpu_torch.inference.engine import (  # noqa: E402
    LocalEngine,
    fused_operands,
    linear_operands,
)
from gaussianvi_tpu_torch.inference.graph import (  # noqa: E402
    FactorGraph,
    GaussianState,
    take_states,
)
from gaussianvi_tpu_torch.kernels.fused_trials import (  # noqa: E402
    edge_means,
    linear_residual_form,
)
from gaussianvi_tpu_torch.ops.blocktridiag import BlockTridiag  # noqa: E402
from gaussianvi_tpu_torch.parallel.restarts import _batch_graph  # noqa: E402

CPU = torch.device("cpu")
CARD = torch.device("cuda")
S = 14
# the arm's trial steps: 0.9 * 0.75^t, t = 1..11
TRIALS = 0.9 * 0.75 ** np.arange(1, 12)


def _linear_graph(n, b, dtype, device, seed=0):
    """The arm's linear batches over ``b`` problems at N = ``n``: the start
    and goal anchors with each problem's own target (rows per problem) and
    the GP prior, one row every problem reads (a stride-0 view); at N = 1
    both anchors sit at state 0 and there is no GP prior."""
    rng = np.random.default_rng(seed)
    anchors = [fixed_prior(k, np.zeros(S), 0.01 * np.eye(S), dtype=dtype,
                           device=device) for k in (0, n - 1)]
    gp = ([minimum_acc_prior(np.eye(S // 2), 2.0 / (n - 1), n, dtype=dtype,
                             device=device)] if n > 1 else [])
    graph = _batch_graph(FactorGraph(num_states=n, state_dim=S,
                                     nonlinear=(), linear=(*anchors, *gp)), b)
    own = [replace(lb, target_mu=torch.tensor(
        rng.standard_normal((b, 1, S)), dtype=dtype, device=device))
        for lb in graph.linear[:2]]
    assert graph.linear[-1].lam.stride(0) == 0
    return replace(graph, linear=(*own, *graph.linear[2:]))


def _cast(graph, dtype):
    """``graph``'s linear batches in ``dtype``."""
    leaves = ("lam", "psi", "target_mu", "target_prec", "constant")
    return replace(graph, linear=tuple(
        replace(lb, **{k: getattr(lb, k).to(dtype) for k in leaves})
        for lb in graph.linear))


def _iterate(n, b, dtype, device, seed=0):
    """``(state, dmu, dprec)``: a well-conditioned precision chain and a
    direction whose diagonal blocks are not symmetric (the trial form
    symmetrizes them); problem 1's longest steps are indefinite (a NaN log
    det), its shortest not."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((b, n, S, S))
    pd = a @ np.swapaxes(a, -1, -2) + 3 * S * np.eye(S)
    po = 0.5 * rng.standard_normal((b, n - 1, S, S))
    dpd = 0.2 * rng.standard_normal((b, n, S, S)) - 0.5 * pd
    dpo = 0.2 * rng.standard_normal((b, n - 1, S, S)) - 0.5 * po
    dpd[1] = -2.5 * pd[1]
    mu, dmu = rng.standard_normal((2, b, n, S))

    def t(x):
        return torch.tensor(x, dtype=dtype, device=device)

    return (GaussianState(t(mu), BlockTridiag(t(pd), t(po))), t(dmu),
            BlockTridiag(t(dpd), t(dpo)))


def _separate_route(engine, state, dmu, dprec, trials):
    """The separate route's trial step (``inference/optimize.py``
    ``trial_costs``): K1 (or its plain version) on the formed trial
    precisions and the linear batches' costs on its blocks."""
    steps = trials.reshape(-1, 1)
    t_prec = (state.precision + dprec.scale(steps)).symmetrize()
    cd, co, ld = engine.cov_logdet(t_prec)
    t_mu = state.mu + steps[..., None, None] * dmu
    fc = tuple(mm.batch_linear_cost(lb, t_mu, cd, co)
               for lb in engine.graph.linear)
    return cd, co, ld, fc, t_mu


def _magnitudes(graph, t_mu, cd, co):
    """Per factor, the size of the terms its cost sums: sum |A| . |Sig|
    (the off-diagonal block twice) + |r|^T |prec_c| |r|."""
    out = []
    for lb in graph.linear:
        off = lb.slice_offset
        a, pm, prec_c = linear_residual_form(lb.lam, lb.psi, lb.target_mu,
                                             lb.target_prec, lb.constant)
        if lb.nb == 1:
            mu_e = take_states(t_mu, lb.start, off, 1)
            tr = (a.abs() * take_states(cd, lb.start, off, 2).abs()).sum(
                (-2, -1))
        else:
            mu_e = edge_means(t_mu, lb.start, off)
            sig = torch.cat([
                torch.cat([take_states(cd, lb.start, off, 2),
                           take_states(co, lb.start, off, 2)], -1),
                torch.cat([take_states(co, lb.start, off, 2).transpose(-1, -2),
                           take_states(cd, lb.start, off, 2, 1)], -1)], -2)
            tr = (a.abs() * sig.abs()).sum((-2, -1))
        res = (lb.lam @ mu_e[..., None])[..., 0] - pm
        out.append(tr + (res.abs()[..., None, :] @ prec_c.abs()
                         @ res.abs()[..., None])[..., 0, 0])
    return out


def _assert_costs_close(got, want, mag, rtol):
    """The same NaNs, the rest within ``rtol`` of the terms' size."""
    for g, w, m in zip(got, want, mag):
        assert g.shape == w.shape
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        fin = ~torch.isnan(w)
        assert bool(((g[fin] - w[fin]).abs() <= rtol * m[fin]).all())


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 10])
def test_plain_trial_form_equals_the_separate_route(n):
    """The engine's trial step on CPU tensors (``gbp_trials_plain``, as
    resolved for the card) equals the separate route's on the arm's
    linear batches: the covariance and log det bit for bit (the same
    trial precisions through the same plain K1), the residual-form costs
    within 1e-12 of their terms' size, NaN where the trial is indefinite."""
    graph = _linear_graph(n, 3, torch.float64, CPU)
    engine = LocalEngine(graph, GVIConfig(), CARD)
    assert engine.gbp_trials_ready
    state, dmu, dprec = _iterate(n, 3, torch.float64, CPU)
    trials = torch.tensor(TRIALS)
    cd, co, ld, fc = engine.gbp_trials(state, dmu, dprec, trials)
    w_cd, w_co, w_ld, w_fc, t_mu = _separate_route(engine, state, dmu, dprec,
                                                   trials)
    assert ld.shape == (11, 3) and cd.shape == (11, 3, n, S, S)
    for got, want in ((cd, w_cd), (co, w_co), (ld, w_ld)):
        assert torch.equal(got.nan_to_num(), want.nan_to_num())
    assert torch.isnan(ld[:, 1]).any() and not torch.isnan(ld[:, 1]).all()
    assert not torch.isnan(ld[:, 0]).any()
    _assert_costs_close(fc, w_fc, _magnitudes(graph, t_mu, w_cd, w_co), 1e-12)


def test_arm_loop_on_the_trial_form_follows_the_separate_route():
    """The arm's loop (N = 4, three restarts, float64) on the engine
    resolved for the card, its wrappers on their plain versions: the
    trial form against the separate route, costs within 1e-12, the same
    steps."""
    from gaussianvi_tpu_torch.inference.optimize import run_gvi_carry
    from gaussianvi_tpu_torch.parallel import perturb_inits

    graph, init, cfg, _ = arm.build_arm_planning(num_states=4, device=CPU)
    states = perturb_inits(init, torch.Generator().manual_seed(0), 3,
                           mean_scale=0.3)
    graph = _batch_graph(graph, 3)
    cfg = replace(cfg, niters=4, niters_lowtemp=4)
    engine = LocalEngine(graph, cfg, CARD)
    assert engine.gbp_trials_ready
    hist = {}
    with torch.no_grad():
        for route in (True, False):
            engine.gbp_trials_ready = route
            hist[route] = run_gvi_carry(engine, states, cfg)[1]
    torch.testing.assert_close(hist[True].cost, hist[False].cost, rtol=1e-12,
                               atol=0)
    assert torch.equal(hist[True].accepted_step, hist[False].accepted_step)


def test_the_engine_takes_the_trial_form_only_at_s14_on_k1():
    """``gbp_trials_ready`` follows the shape and the batches: the arm on
    the card's K1 takes it, with its linear operands as ``_fused_ops``'
    linear half; not on the CPU, not on the plain chain, not where a linear
    batch's starts are per problem, not at s = 1 (Barfoot, K1 of the other
    layout), nor where K5 is taken (chain estimation at s = 4, the point
    planner at s = 6)."""
    from gaussianvi_tpu_torch.examples.barfoot_1d import build_barfoot_1d
    from gaussianvi_tpu_torch.examples.chain_estimation import (
        build_chain_estimation,
    )
    from gaussianvi_tpu_torch.examples.point3d_planning import (
        build_point3d_planning,
    )

    graph, _, cfg, _ = arm.build_arm_planning(num_states=4, device=CPU)
    card = LocalEngine(graph, cfg, CARD)
    assert card.chain_kernel and card.gbp_trials_ready
    assert not card.fused_trials_ready and not card.fused_gradient_ready
    nl, lin_specs, nl_arrays, lin_arrays = card._fused_ops
    assert nl == nl_arrays == () and lin_specs == linear_operands(graph)[0]
    assert len(lin_arrays) == len(graph.linear)
    assert not LocalEngine(graph, cfg, CPU).gbp_trials_ready
    for plain in ("seq", "assoc"):
        assert not LocalEngine(graph, replace(cfg, chain_impl=plain),
                               CARD).gbp_trials_ready
    gp = graph.linear[-1]
    own = replace(gp, start=gp.start.expand(2, -1), shared_start=False,
                  slice_offset=None)
    two = replace(_batch_graph(graph, 2), linear=(*graph.linear[:-1], own))
    assert isinstance(linear_operands(two), str)
    assert not LocalEngine(two, cfg, CARD).gbp_trials_ready
    barfoot, _, bcfg = build_barfoot_1d(device=CPU)
    assert LocalEngine(barfoot, bcfg, CARD).chain_kernel
    assert not LocalEngine(barfoot, bcfg, CARD).gbp_trials_ready
    chain_graph = build_chain_estimation(num_states=8, dim_x=2, gh_degree=4,
                                         device=CPU)[0]
    point3d = build_point3d_planning(device=CPU)[0]
    for g in (chain_graph, point3d):
        engine = LocalEngine(g, GVIConfig(), CARD)
        assert engine.fused_trials_ready and not engine.gbp_trials_ready
        off = LocalEngine(g, GVIConfig(fused_trials="off"), CARD)
        assert not off.gbp_trials_ready


def _residual_operands(graph):
    """The linear operands as ``fused_operands`` built them before its
    linear half was a function of its own."""
    s = graph.state_dim
    specs, arrays = [], []
    for lb in graph.linear:
        rows = slice(0, 1) if lb.uniform else slice(None)
        lam = lb.lam[..., rows, :, :]
        a, pm, prec_c = linear_residual_form(
            lam, lb.psi[..., rows, :, :], lb.target_mu[..., rows, :],
            lb.target_prec[..., rows, :, :], lb.constant[..., rows])
        a = (torch.stack([a[..., :s, :s], a[..., s:, s:], a[..., :s, s:]],
                         dim=-3) if lb.nb == 2 else a[..., None, :, :])
        specs.append((lb.nb, lb.num_factors, a.shape[-4], lam.shape[-2],
                      lb.slice_offset))
        arrays.append((lb.start, a, lam, pm, prec_c))
    return specs, arrays


@pytest.mark.parametrize("model", ["chain_est", "point3d_plan"])
def test_linear_operands_leave_the_fused_operands_as_they_were(model):
    """``fused_operands``' linear half, now ``linear_operands``, gives the
    K5 / K6 operands of the chain-estimation and point-planner graphs bit
    for bit as before, and the nonlinear half is unchanged around it."""
    from gaussianvi_tpu_torch.examples.chain_estimation import (
        build_chain_estimation,
    )
    from gaussianvi_tpu_torch.examples.point3d_planning import (
        build_point3d_planning,
    )
    from gaussianvi_tpu_torch.parallel.restarts import _batch_graph as batch

    if model == "chain_est":
        graph = build_chain_estimation(num_states=8, dim_x=2, gh_degree=4,
                                       device=CPU)[0]
    else:
        graph = batch(build_point3d_planning(device=CPU)[0], 3)
    nl_specs, lin_specs, nl_arrays, lin_arrays = fused_operands(graph)
    assert len(nl_specs) == len(graph.nonlinear) == len(nl_arrays) >= 1
    specs, arrays = _residual_operands(graph)
    assert [tuple(sp) for sp in lin_specs] == specs
    assert linear_operands(graph)[0] == lin_specs
    assert len(lin_arrays) == len(arrays) == len(graph.linear) >= 1
    for got, want in zip(lin_arrays, arrays):
        assert got[0] is want[0]
        assert all(torch.equal(g, w) for g, w in zip(got[1:], want[1:]))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only there)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [1, 2, 10])
def test_trial_form_matches_k1_and_the_separate_route(dev, n, dtype):
    """K1's trial form on 64 problems of the arm's linear batches, 11
    trials: its covariance and log det equal K1's on the separate route's
    trial precisions bit for bit (NaN where a trial is indefinite); its
    costs the separate route's (``moments.batch_linear_cost`` on K1's
    blocks) within 1e-11 of their terms' size in float64, and in float32
    held to float64 as the card's other kernels are (``_close_vs_f64``);
    one launch a call, twice for the same bits."""
    from gaussianvi_tpu_torch.kernels import launch_counts
    from test_torch_cuda import _assert_same_bits, _close_vs_f64

    b = 64
    graph = _cast(_linear_graph(n, b, torch.float64, dev), dtype)
    engine = LocalEngine(graph, GVIConfig(), dev)
    assert engine.chain_kernel and engine.gbp_trials_ready
    state, dmu, dprec = _iterate(n, b, dtype, dev)
    trials = torch.tensor(TRIALS, dtype=dtype, device=dev)

    def call():
        cd, co, ld, fc = engine.gbp_trials(state, dmu, dprec, trials)
        return (cd, co, ld, *fc)

    before = launch_counts()
    got = call()
    _assert_same_bits(got, call())
    after = launch_counts()
    assert after["gbp_trials"] - before["gbp_trials"] == 2
    assert after["gbp_covariance_logdet"] == before["gbp_covariance_logdet"]
    w_cd, w_co, w_ld, w_fc, t_mu = _separate_route(engine, state, dmu, dprec,
                                                   trials)
    _assert_same_bits(got[:3], (w_cd, w_co, w_ld))
    ld = got[2]
    assert torch.isnan(ld[:, 1]).any() and not torch.isnan(ld[:, 1]).all()
    assert not torch.isnan(ld[:, 0]).any()
    fc = got[3:]
    assert len(fc) == len(graph.linear)
    if dtype == torch.float64:
        _assert_costs_close(fc, w_fc, _magnitudes(graph, t_mu, w_cd, w_co),
                            1e-11)
        return
    e64 = LocalEngine(_cast(graph, torch.float64), GVIConfig(), dev)
    prec = state.precision
    up = (GaussianState(state.mu.double(), BlockTridiag(
        prec.diag.double(), prec.off.double())), dmu.double(),
        BlockTridiag(dprec.diag.double(), dprec.off.double()), trials.double())
    want64 = _separate_route(e64, *up)[3]
    for g, w, w64 in zip(fc, w_fc, want64):
        _close_vs_f64(g, w, w64)
