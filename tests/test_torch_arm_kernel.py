"""PyTorch port, the 7-DOF arm planner on the quadrature kernel: the
``"arm_sdf"`` functor's plain form (``kernels/quad.py``) against the arm
factor's ``cost_fn``, the arm batch's kernel fields and what K3 covers,
and the routes ``"auto"`` resolves on the CPU and for the card (CPU,
float64).  On a card (no JAX needed), the arm's K3 instance
(``csrc/quad_arm.cu``) against the plain form, the float32 guard against
the plain route's, ``optimize`` on the kernels against the plain path, and
its loop replayed as a CUDA graph bit for bit:

    python -m pytest --noconftest -o addopts="" tests/test_torch_arm_kernel.py -q
"""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gaussianvi_tpu_torch.examples import arm_planning as arm  # noqa: E402
from gaussianvi_tpu_torch.factors.moments import kernel_covers  # noqa: E402
from gaussianvi_tpu_torch.factors.robots import (  # noqa: E402
    DHForwardKinematics,
    make_arm_obstacle_factor,
)
from gaussianvi_tpu_torch.inference.engine import LocalEngine  # noqa: E402
from gaussianvi_tpu_torch.kernels import (  # noqa: E402
    launch_counts,
    quad,
    quad_route_counts,
    reset_launch_counts,
)

CPU = torch.device("cpu")


def _arm(dtype=torch.float64, device=CPU, **kw):
    return arm.build_arm_planning(dtype=dtype, device=device, **kw)


def _angles(init, count, scale, seed):
    """``count`` states near the straight line, each entry moved by
    N(0, scale^2)."""
    rng = np.random.default_rng(seed)
    mu = init.mu.cpu().numpy()
    return mu + scale * rng.standard_normal((count, *mu.shape))


@pytest.mark.parametrize("scale", [0.0, 0.3, 1.0])
def test_plain_form_equals_the_factor_cost(scale):
    """The packed plain form of ``ArmSdfCost`` on the batch's own params
    and field equals the factor's ``cost_fn`` (DH kinematics, the sphere
    SDF, the hinge) at seeded joint angles to 1e-12, zeros where it has
    them, and a NaN angle gives NaN."""
    graph, init, _, _ = _arm()
    fb = graph.nonlinear[0]
    x = torch.tensor(_angles(init, 32, scale, seed=7))
    x[0, 3, 2] = float("nan")
    want = fb.cost_fn(x, None)
    got = quad.cost_form("arm_sdf", fb.kernel_field)(x, fb.kernel_params)
    assert (want > 0).any() and (want == 0).any()
    assert torch.isnan(got[0, 3]) and torch.isnan(want[0, 3])
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12,
                               equal_nan=True)
    assert torch.equal(got == 0, want == 0)


def test_the_arm_batch_names_the_functor():
    """The example's collision batch names ``"arm_sdf"`` with one row of
    77 params every factor reads (an expanded view), the field, the
    joint-marginal rule; K3 covers it at d = 14 on 15 nodes in both
    dtypes and refuses another rule, P or d; the matmul lookup, a chain
    whose frames decrease and a chain of other length stay
    ``cost_fn``-only."""
    graph, _, _, (fk, sdf) = _arm()
    fb = graph.nonlinear[0]
    assert fb.kernel_cost == "arm_sdf" and fb.quad_rdim == 7
    assert fb.kernel_params.shape == (10, quad.ARM_NP)
    assert fb.kernel_params.stride() == (0, 1)
    assert fb.kernel_field is sdf.data or torch.equal(fb.kernel_field,
                                                      sdf.data)
    assert kernel_covers(fb) is None
    field = fb.kernel_field
    for dt in (torch.float32, torch.float64):
        assert quad.covers("arm_sdf", 14, quad.ARM_NP, 15, dt,
                           field.to(dt), 7) is None
    assert "marginal rule" in quad.covers("arm_sdf", 14, quad.ARM_NP, 15,
                                          torch.float64, field, None)
    assert "not instantiated" in quad.covers("arm_sdf", 14, 70, 15,
                                             torch.float64, field, 7)
    assert "not instantiated" in quad.covers("arm_sdf", 12, quad.ARM_NP, 15,
                                             torch.float64, field, 7)
    kw = dict(state_dim=14, cost_sigma=20.0, epsilon=0.1, gh_degree=2,
              n_joints=7, device=CPU)
    radii = np.full(7, 0.05)
    matmul = make_arm_obstacle_factor(sdf, fk, radii, np.arange(10),
                                      interp="matmul", **kw)
    assert matmul.kernel_cost is None
    swapped = replace(fk, frames=fk.frames[[2, 0, 1, 3, 4, 5, 6]].flip(0))
    assert make_arm_obstacle_factor(sdf, swapped, radii, np.arange(10),
                                    **kw).kernel_cost is None
    short = DHForwardKinematics(*(getattr(fk, k)[:6] for k in (
        "a", "alpha", "d", "theta_bias")), fk.frames[:6] % 6,
        fk.centers[:6])
    assert make_arm_obstacle_factor(sdf, short, radii[:6], np.arange(10),
                                    **{**kw, "state_dim": 12, "n_joints": 6}
                                    ).kernel_cost is None


def test_the_params_are_read_in_place():
    """The problem-batched params, an expanded view of one row, reach the
    kernel as that row with a period of one: nothing is copied a call."""
    graph, _, _, _ = _arm()
    params = graph.nonlinear[0].kernel_params.expand(1024, 10, quad.ARM_NP)
    rows, period = quad._param_rows(params, (1024, 10), "test")
    assert period == 1 and rows.shape == (quad.ARM_NP,)
    assert torch.equal(rows, params[0, 0])
    own = torch.arange(10 * 8, dtype=torch.float64).reshape(10, 8)
    rows, period = quad._param_rows(own.expand(64, 10, 8), (64, 10), "test")
    assert period == 10 and torch.equal(rows, own)


def test_auto_resolves_the_arm_batch_to_the_kernel():
    """For the card ``"auto"`` takes K1 / K2 and K3 for the arm's batch
    (its own layout, ``quad.GROUP_COSTS``), no fused kernel; on the CPU
    the plain quadrature.  ``quad_route_counts()`` counts each batch by
    the route it was resolved to, and ``quad_impl="xla"`` counts it
    plain."""
    graph, _, config, _ = _arm(num_states=4)
    reset_launch_counts()
    card = LocalEngine(graph, config, torch.device("cuda"))
    assert card.chain_kernel and card.quad_batches == (True,)
    assert not card.fused_trials_ready and not card.fused_gradient_ready
    assert quad_route_counts() == {"kernel": 1, "plain": 0}
    assert LocalEngine(graph, config, CPU).quad_batches == (False,)
    LocalEngine(graph, replace(config, quad_impl="xla"),
                torch.device("cuda"))
    assert quad_route_counts() == {"kernel": 1, "plain": 2}
    reset_launch_counts()
    assert quad_route_counts() == {"kernel": 0, "plain": 0}
    plan = quad.quad_plan(15, 14, True, torch.float64, "arm_sdf")
    assert plan.group == quad.ARM_GROUP and plan.smem <= 48 * 1024


def test_a_run_on_the_plain_quadrature_is_counted():
    """An ``optimize`` on CPU tensors resolves the arm's batch to the
    plain quadrature and counts it so (``quad_route_counts()``), which is
    how a traced run shows a batch that fell back to it; it launches no
    kernel."""
    from gaussianvi_tpu_torch import optimize

    graph, init, config, _ = _arm(num_states=4)
    reset_launch_counts()
    optimize(graph, init, replace(config, niters=2, niters_lowtemp=2))
    counts = quad_route_counts()
    assert counts["kernel"] == 0 and counts["plain"] >= 1
    assert not any(launch_counts().values())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only there)")
    return torch.device("cuda", 0)


def _marginals(dtype, dev, count, seed):
    """The arm batch's operands at ``count`` problems of K = 10 factors:
    seeded means near the straight line and covariances of the size the
    planner's iterates reach."""
    graph, init, _, _ = _arm(dtype, dev)
    fb = graph.nonlinear[0]
    rng = np.random.default_rng(seed)
    mu = torch.tensor(_angles(init, count, 0.3, seed), dtype=dtype,
                      device=dev)
    a = 0.1 * rng.standard_normal((count, 10, 14, 14))
    cov = torch.tensor(a @ np.swapaxes(a, -1, -2) + 0.02 * np.eye(14),
                       dtype=dtype, device=dev)
    params = fb.kernel_params.expand(count, 10, quad.ARM_NP)
    return fb, mu, cov, params


def _rel(got, want):
    scale = want.abs().max()
    return float((got - want).abs().max() / scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_arm_quad_kernel_matches_plain(dev, dtype):
    """K3's arm instance, phi and moments, on 1,000 problems of the arm's
    shapes (and at a ragged 3 x 7 factors) against the plain form on the
    card: float64 within 1e-11 of the largest magnitude, float32 within
    1e-4 (the products' order; each output's float32 rounding is 6e-8);
    twice for the same bits; a covariance that is not positive definite
    gives NaN where the plain form does; bfloat16 offsets as the plain
    form rounds them."""
    from gaussianvi_tpu_torch.kernels import launch_counts

    tol = 1e-11 if dtype == torch.float64 else 1e-4
    for count, k in ((1000, 10), (3, 7)):
        fb, mu, cov, params = _marginals(dtype, dev, count, seed=count)
        mu, cov, params = mu[:, :k], cov[:, :k], params[:, :k]
        cov[0, 1] = -cov[0, 1]
        args = (mu, cov, fb.nodes, fb.weights, "arm_sdf", params)
        before = launch_counts()
        phi = quad.quad_lanes_phi(*args, nonneg=True, field=fb.kernel_field)
        again = quad.quad_lanes_phi(*args, nonneg=True, field=fb.kernel_field)
        mom = quad.quad_lanes_moments(*args, rdim=7, field=fb.kernel_field)
        mom2 = quad.quad_lanes_moments(*args, rdim=7, field=fb.kernel_field)
        after = launch_counts()
        assert after["quad_arm_phi"] - before["quad_arm_phi"] == 2
        assert after["quad_arm_moments"] - before["quad_arm_moments"] == 2
        assert after["quad_phi"] == before["quad_phi"]
        assert torch.equal(phi.nan_to_num(), again.nan_to_num())
        assert all(torch.equal(a.nan_to_num(), b.nan_to_num())
                   for a, b in zip(mom, mom2))
        want_phi = quad.quad_phi_plain(*args, True, fb.kernel_field)
        want = quad.quad_moments_plain(*args, 7, fb.kernel_field)
        assert torch.equal(torch.isnan(phi), torch.isnan(want_phi))
        assert torch.isnan(phi[0, 1]) and torch.isnan(mom[0][0, 1])
        ok = ~torch.isnan(want_phi)
        assert _rel(phi[ok], want_phi[ok]) <= tol
        good = ~torch.isnan(want[0])
        for got, w in zip(mom, want):
            assert _rel(got[good], w[good]) <= tol
    bf = quad.quad_lanes_moments(*args, rdim=7, field=fb.kernel_field,
                                 eval_dtype=torch.bfloat16)
    want = quad.quad_moments_plain(*args, 7, fb.kernel_field, torch.bfloat16)
    for got, w in zip(bf, want):
        assert _rel(got[good], w[good]) <= max(tol, 1e-6)


def _restarts(dtype, dev, count, scale, seed):
    from gaussianvi_tpu_torch.parallel import perturb_inits
    from gaussianvi_tpu_torch.parallel.restarts import _batch_graph

    graph, init, cfg, aux = _arm(dtype, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    states = perturb_inits(init, gen, count, mean_scale=scale)
    return _batch_graph(graph, count), states, cfg, aux


@pytest.mark.cuda
def test_arm_float32_guard_poisons_the_same_restarts(dev):
    """In float32 the quadrature's guards poison the first E[phi] of some
    of 1,024 restarts (``perturb_inits``, mean_scale 0.3, seed 0); the
    kernel route poisons the same factors of the same restarts as the
    plain route, never restart 0, and none in float64."""
    from gaussianvi_tpu_torch import optimize

    got = {}
    for route in ("kernel", "plain"):
        graph, states, cfg, _ = _restarts(torch.float32, dev, 1024, 0.3, 0)
        cfg = replace(cfg, niters=1, niters_lowtemp=1,
                      **({} if route == "kernel" else {"quad_impl": "xla"}))
        _, hist = optimize(graph, states, cfg)
        got[route] = ~torch.isfinite(hist.factor_costs[:, 0])
    assert 0 < int(got["plain"].any(-1).sum()) < 64
    assert torch.equal(got["kernel"], got["plain"])
    assert not got["kernel"][0].any()
    graph, states, cfg, _ = _restarts(torch.float64, dev, 1024, 0.3, 0)
    _, hist = optimize(graph, states, replace(cfg, niters=1, niters_lowtemp=1))
    assert torch.isfinite(hist.factor_costs[:, 0]).all()


def _no_plain_cost(graph):
    """``graph`` whose nonlinear batches raise if the plain quadrature
    calls their ``cost_fn``."""
    def refuse(x, params):
        raise AssertionError("the plain quadrature ran")

    return replace(graph, nonlinear=tuple(
        replace(fb, cost_fn=refuse) for fb in graph.nonlinear))


@pytest.mark.cuda
def test_arm_optimize_runs_on_the_kernels(dev):
    """``optimize`` on the arm (64 restarts, float64, all 15 iterations)
    under the defaults resolves its batch to K3, never calls the plain
    quadrature's ``cost_fn`` (so no forward kinematics of 4 x 4 products),
    launches K1 at init, its trial form and K2 every iteration and the
    arm's K3 (phi at init and on every trial batch, the moments every
    iteration) and nothing fused, and follows the
    plain path (``chain_impl="seq"``, ``quad_impl="xla"``): costs within
    1e-9, the same steps."""
    from gaussianvi_tpu_torch import optimize
    from gaussianvi_tpu_torch.inference import loop_graph
    from gaussianvi_tpu_torch.kernels import launch_counts

    graph, states, cfg, _ = _restarts(torch.float64, dev, 64, 0.3, 1)
    loop_graph.clear()
    reset_launch_counts()
    _, hk = optimize(_no_plain_cost(graph), states, cfg)
    counts = {k: v for k, v in launch_counts().items() if v}
    assert quad_route_counts() == {"kernel": 1, "plain": 0}
    assert counts == {"gbp_covariance_logdet": 1,
                      "gbp_trials": cfg.niters,
                      "solve": cfg.niters,
                      "quad_arm_phi": cfg.niters + 1,
                      "quad_arm_moments": cfg.niters}, counts
    _, hp = optimize(graph, states, replace(cfg, chain_impl="seq",
                                            quad_impl="xla"))
    torch.testing.assert_close(hk.cost, hp.cost, rtol=1e-9, atol=0)
    assert torch.equal(hk.accepted_step, hp.accepted_step)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_arm_loop_graph_replays_the_eager_loop_to_the_bit(dev, dtype):
    """Three ``optimize_from`` calls on the arm's restarts, sets A, B, A
    (256 restarts each): eager, captured and replayed, replayed
    (``loop_graph_counts()``); each call's history, final state and loop
    values equal the eager loop's (``run_gvi_carry``) on its set bit for
    bit, and the launch counts grow by the eager loop's each call: K1's
    trial form once an iteration, K1 once, at init."""
    from gaussianvi_tpu_torch.inference import loop_graph
    from gaussianvi_tpu_torch.inference.optimize import (
        optimize_from,
        run_gvi_carry,
    )
    from gaussianvi_tpu_torch.kernels import launch_counts, loop_graph_counts
    from gaussianvi_tpu_torch.ops.precision import set_precision_policy
    from test_torch_cuda import _assert_same_bits as same

    def flat(state, hist, loop):
        return (state.mu, state.precision.diag, state.precision.off, *hist,
                *loop)

    sets = [_restarts(dtype, dev, 256, 0.3, seed)[:3] for seed in (2, 3)]
    set_precision_policy()
    eager, grown = [], []
    for graph, states, cfg in sets:
        before = launch_counts()
        with torch.no_grad():
            carry, hist = run_gvi_carry(LocalEngine(graph, cfg, dev), states,
                                        cfg)
        after = launch_counts()
        grown.append({n: after[n] - before[n] for n in after})
        eager.append(flat(carry.state, hist, (carry.temperature,
                                              carry.is_lowtemp,
                                              carry.converged)))
    niters = sets[0][2].niters
    assert grown[0]["quad_arm_moments"] == grown[0]["gbp_trials"] == niters
    assert grown[0]["gbp_covariance_logdet"] == 1
    loop_graph.clear()
    reset_launch_counts()
    kinds, outs = [], []
    for k in (0, 1, 0):
        graph, states, cfg = sets[k]
        before, seen = launch_counts(), loop_graph_counts()
        state, hist, loop = optimize_from(graph, states, cfg)
        out = flat(state, hist, (loop.temperature, loop.is_lowtemp,
                                 loop.converged))
        after, now = launch_counts(), loop_graph_counts()
        kinds += [n for n in now if now[n] > seen[n]]
        assert {n: after[n] - before[n] for n in after} == grown[k]
        same(out, eager[k])
        outs.append(out)
        if k == 0 and len(outs) == 1:
            first = tuple(x.clone() for x in out)
    assert kinds == ["eager", "captured", "replayed"]
    # the first call's outputs are its own, untouched by the replays
    same(outs[0], first)
