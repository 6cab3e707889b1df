"""PyTorch port, the 7-DOF arm planner (``examples/arm_planning.py``,
s = 14) against the JAX package (CPU, f64 unless named): the WAM forward
kinematics' sphere centers, the sphere-obstacle SDF, the built graph and
initial state, ``optimize`` over the whole 15-iteration run at N = 4 (the
planner keeps rounding in check: the nudge test), the JAX arm test's end
checks, float32's guard poisoning the same restarts as the JAX package in
float32, and ``"auto"`` resolving the arm to the chain kernels and its
quadrature kernel on the card."""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gaussianvi_tpu.examples import arm_planning as jarm  # noqa: E402
from gaussianvi_tpu.inference.graph import GaussianState as JaxState  # noqa: E402
from gaussianvi_tpu.inference.optimize import optimize as jax_optimize  # noqa: E402
from gaussianvi_tpu.ops import BlockTridiag as JaxBlockTridiag  # noqa: E402
from gaussianvi_tpu_torch import GVIConfig, optimize  # noqa: E402
from gaussianvi_tpu_torch.examples import arm_planning as tarm  # noqa: E402
from gaussianvi_tpu_torch.inference.engine import LocalEngine  # noqa: E402
from gaussianvi_tpu_torch.inference.graph import GaussianState  # noqa: E402
from gaussianvi_tpu_torch.ops.blocktridiag import BlockTridiag  # noqa: E402
from gaussianvi_tpu_torch.parallel import perturb_inits  # noqa: E402
from test_torch_point3d import _same_linear  # noqa: E402

CPU = torch.device("cpu")
N, R = 4, 4


def test_wam_fk_sphere_centers_match_jax():
    """Sphere centers of the WAM arm at seeded joint angles (and at zero)
    equal the JAX kinematics' at 1e-12."""
    theta = np.random.default_rng(0).uniform(-np.pi, np.pi, (16, 7))
    theta[0] = 0.0
    got = tarm.wam_fk(device=CPU).sphere_centers(torch.tensor(theta))
    jfk = jarm.wam_fk(jnp.float64)
    want = np.asarray(jax.vmap(jfk.sphere_centers)(jnp.asarray(theta)))
    assert got.shape == (16, 7, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_sphere_sdf_matches_jax():
    """The 40^3 sphere-obstacle field equals the JAX builder's bit for
    bit, and its lookups at seeded points (inside, outside and beyond the
    grid) agree at 1e-12."""
    tf = tarm.sphere_obstacle_sdf3d(device=CPU)
    jf = jarm.sphere_obstacle_sdf3d(dtype=jnp.float64)
    np.testing.assert_array_equal(tf.data.numpy(), np.asarray(jf.data))
    np.testing.assert_array_equal(tf.origin.numpy(), np.asarray(jf.origin))
    assert float(tf.cell_size) == float(jf.cell_size)
    pts = np.random.default_rng(1).uniform(-1.4, 1.4, (500, 3))
    np.testing.assert_allclose(
        tf.signed_distance(torch.tensor(pts)).numpy(),
        np.asarray(jf.signed_distance(jnp.asarray(pts))), rtol=0, atol=1e-12)


def test_graph_matches_jax_builder():
    """The port's graph, initial state and config equal the JAX
    builder's: the (7, 2) joint-marginal rule of 15 nodes, anchors and GP
    prior bit for bit, the collision ``cost_fn`` at seeded states to
    1e-12; N = 10, s = 14, 15 iterations, step base 0.9."""
    jg, ji, jc, _ = jarm.build_arm_planning(dtype=jnp.float64)
    tg, ti, tc, _ = tarm.build_arm_planning(device=CPU)
    assert (tg.num_states, tg.state_dim) == (jg.num_states, jg.state_dim) == (
        10, 14)
    jb, tb = jg.nonlinear[0], tg.nonlinear[0]
    assert tb.nodes.shape == (15, 14) and tb.kernel_cost == "arm_sdf"
    np.testing.assert_array_equal(tb.nodes.numpy(), np.asarray(jb.nodes))
    np.testing.assert_array_equal(tb.weights.numpy(), np.asarray(jb.weights))
    np.testing.assert_array_equal(tb.start.numpy(), np.asarray(jb.start))
    assert (tb.quad_rdim, tb.nonneg_cost, tb.slice_offset) == (
        jb.quad_rdim, jb.nonneg_cost, jb.slice_offset) == (7, True, 0)
    for tl, jl in zip(tg.linear, jg.linear, strict=True):
        _same_linear(tl, jl)
    np.testing.assert_array_equal(ti.mu.numpy(), np.asarray(ji.mu))
    np.testing.assert_array_equal(ti.precision.diag.numpy(),
                                  np.asarray(ji.precision.diag))
    np.testing.assert_array_equal(ti.precision.off.numpy(),
                                  np.asarray(ji.precision.off))
    assert (tc.niters, tc.niters_lowtemp, tc.step_size_base) == (
        jc.niters, jc.niters_lowtemp, jc.step_size_base) == (15, 15, 0.9)
    pts = np.asarray(ji.mu) + 0.5 * np.random.default_rng(5).standard_normal(
        (3, 10, 14))
    want = np.asarray(jax.vmap(jax.vmap(lambda x: jb.cost_fn(x, None)))(
        jnp.asarray(pts)))
    got = tb.cost_fn(torch.tensor(pts), None).numpy()
    assert (want > 0).any() and (want == 0).any()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def _restarts(init, scale=0.3, seed=1):
    """R initial means: restart 0 the nominal straight line (through the
    obstacle), the others jittered (numpy, so both packages get them)."""
    noise = scale * np.random.default_rng(seed).standard_normal(
        (R, *np.shape(init.mu)))
    noise[0] = 0.0
    return np.asarray(init.mu) + noise


def _port_states(init, mu):
    prec = init.precision
    return GaussianState(torch.as_tensor(mu), BlockTridiag(
        prec.diag.expand(len(mu), *prec.diag.shape).clone(),
        prec.off.expand(len(mu), *prec.off.shape).clone()))


def test_arm_history_matches_jax():
    """Four restarts at N = 4 over all 15 iterations on the plain routes:
    relative cost within 1e-11 of ``jax.vmap(optimize)``, the same steps,
    factor costs and final means to 1e-10.  The whole run is held: 1e-15
    nudges of the means move the costs by less than 1e-13 (next test)."""
    jg, ji, jc, _ = jarm.build_arm_planning(num_states=N, dtype=jnp.float64)
    mu = _restarts(ji)
    prec = ji.precision
    jstate, jhist = jax.jit(jax.vmap(lambda s: jax_optimize(jg, s, jc)))(
        JaxState(jnp.asarray(mu), JaxBlockTridiag(
            jnp.broadcast_to(prec.diag, (R, *prec.diag.shape)),
            jnp.broadcast_to(prec.off, (R, *prec.off.shape)))))
    tg, ti, tc, _ = tarm.build_arm_planning(num_states=N, device=CPU)
    state, hist = optimize(tg, _port_states(ti, mu), tc)
    jcost = np.asarray(jhist.cost)
    assert hist.cost.shape == jcost.shape == (R, 15)
    np.testing.assert_allclose(hist.cost.numpy(), jcost, rtol=1e-11)
    np.testing.assert_array_equal(hist.accepted_step.numpy(),
                                  np.asarray(jhist.accepted_step))
    np.testing.assert_allclose(hist.factor_costs.numpy(),
                               np.asarray(jhist.factor_costs), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(state.mu.numpy(), np.asarray(jstate.mu),
                               atol=1e-10)


def test_arm_keeps_rounding_in_check():
    """The parity gate's horizon: means nudged by 1e-15 of their size move
    the four restarts' f64 costs by less than 1e-13 over all 15
    iterations (N = 4), with the same steps."""
    tg, ti, tc, _ = tarm.build_arm_planning(num_states=N, device=CPU)
    mu = _restarts(ti)
    nudged = mu * (1 + 1e-15 * np.random.default_rng(7).standard_normal(
        mu.shape))
    _, a = optimize(tg, _port_states(ti, mu), tc)
    _, b = optimize(tg, _port_states(ti, nudged), tc)
    rel = ((a.cost - b.cost).abs() / b.cost.abs()).amax(0).numpy()
    assert rel.shape == (15,) and rel.max() < 1e-13
    assert torch.equal(a.accepted_step, b.accepted_step)


def test_arm_plans_and_clears():
    """``tests/test_arm_planning.py``'s check on the port: at N = 8 and
    cost_sigma 200 the cost falls below a fifth of its start and the
    converged spheres graze the obstacle at worst (-0.05)."""
    final, hist, (fk, sdf) = tarm.run_arm_planning(
        num_states=8, cost_sigma=200.0, device=CPU)
    cost = hist.cost.numpy()
    assert np.isfinite(cost).all() and cost[-1] < cost[0] / 5
    centers = fk.sphere_centers(final.mu[:, :7])
    assert float(sdf.signed_distance(centers.reshape(-1, 3)).min()) > -0.05


def test_float32_guard_poisons_the_same_restarts_as_jax():
    """In float32 the quadrature's guard poisons the first E[phi] of two of
    128 restarts (``perturb_inits``, mean_scale 0.3, seed 0: restarts 64
    and 89, one factor each), so their costs are NaN from the first record
    and they never move; the JAX package in float32 (x64 off) poisons the
    same factors of the same restarts, and neither poisons restart 0.  In
    float64 all three are finite."""
    init64 = tarm.build_arm_planning(device=CPU)[1]
    gen = torch.Generator(device=CPU).manual_seed(0)
    picked = [0, 64, 89]
    mu = perturb_inits(init64, gen, 128, mean_scale=0.3).mu[picked]
    got = {}
    for dt in (torch.float32, torch.float64):
        tg, ti, tc, _ = tarm.build_arm_planning(dtype=dt, device=CPU)
        _, hist = optimize(tg, _port_states(ti, mu.to(dt)), replace(
            tc, niters=1, niters_lowtemp=1))
        got[dt] = ~torch.isfinite(hist.factor_costs[:, 0]).numpy()
    with jax.enable_x64(False):
        jg, ji, jc, _ = jarm.build_arm_planning(dtype=jnp.float32)
        run = jax.jit(jax.vmap(lambda m: jax_optimize(
            jg, JaxState(m, ji.precision),
            replace(jc, niters=1, niters_lowtemp=1))[1].factor_costs[0]))
        want = ~np.isfinite(np.asarray(run(jnp.asarray(mu.numpy(),
                                                       jnp.float32))))
    assert [np.nonzero(r)[0].tolist() for r in want] == [[], [6], [5]]
    np.testing.assert_array_equal(got[torch.float32], want)
    assert not got[torch.float64].any()


def test_auto_resolves_the_arm_to_the_chain_kernels():
    """On a card ``"auto"`` takes K1 / K2 at s = 14 and the arm's K3
    (``"arm_sdf"``) for the collision batch, no fused kernel; ``"lanes"``
    accepts the graph on the card."""
    graph, _, config, _ = tarm.build_arm_planning(num_states=N, device=CPU)
    card = LocalEngine(graph, config, torch.device("cuda"))
    assert card.chain_kernel and card.quad_batches == (True,)
    assert not card.fused_trials_ready and not card.fused_gradient_ready
    assert not LocalEngine(graph, config, CPU).chain_kernel
    assert LocalEngine(graph, GVIConfig(chain_impl="lanes"),
                       torch.device("cuda")).chain_kernel
