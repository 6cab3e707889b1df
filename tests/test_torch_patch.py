"""PyTorch port, the planners' patch mode (``patch_size``) against the JAX
package (CPU, f64).

In the JAX package the patch mode is its own function: the obstacle cost
interpolates inside a window of P cells a side around each factor's
marginal mean (a point outside the window takes the value at its edge), on
the full-state rule, on the kernel routes (``quad_impl="lanes"``); the
plain route keeps the whole-field ``cost_fn``.  The port's window functors
(``kernels/quad.py`` ``"planar_patch"``, ``"sdf3d_patch"``) run their plain
forms here; the JAX side runs its lanes kernels in interpret mode.  Held
here: the builders, the windows' origins, the cost forms against the hat
sums, K3 (phi and moments) and K6 (``full`` and ``accum``) against the
JAX kernels, the point planner's run on the card's routes against JAX's
lanes run, the CPU plain route against JAX's ``"xla"`` route, and how the
engines resolve (K5 off, K6 on; the sequence-parallel engine).  The
factor-parallel case rides in ``tests/test_torch_sharding.py``'s rank
group."""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gaussianvi_tpu.examples import planar_planning as jpl  # noqa: E402
from gaussianvi_tpu.examples import point3d_planning as jp3  # noqa: E402
from gaussianvi_tpu.factors import moments as jmm  # noqa: E402
from gaussianvi_tpu.factors import robots as jrob  # noqa: E402
from gaussianvi_tpu.inference import GVIConfig as JaxConfig  # noqa: E402
from gaussianvi_tpu.inference.engine import LocalEngine as JaxEngine  # noqa: E402
from gaussianvi_tpu.inference.graph import GaussianState as JaxState  # noqa: E402
from gaussianvi_tpu.inference.optimize import optimize as jax_optimize  # noqa: E402
from gaussianvi_tpu.kernels import fused_gradient as jfg  # noqa: E402
from gaussianvi_tpu.ops import BlockTridiag as JaxBlockTridiag  # noqa: E402
from gaussianvi_tpu_torch import GVIConfig, optimize  # noqa: E402
from gaussianvi_tpu_torch import parallel  # noqa: E402
from gaussianvi_tpu_torch.examples import planar_planning as tpl  # noqa: E402
from gaussianvi_tpu_torch.examples import point3d_planning as tp3  # noqa: E402
from gaussianvi_tpu_torch.factors import moments as tmm  # noqa: E402
from gaussianvi_tpu_torch.factors import robots as trob  # noqa: E402
from gaussianvi_tpu_torch.inference.engine import (  # noqa: E402
    LocalEngine,
    fused_operands,
)
from gaussianvi_tpu_torch.inference.graph import (  # noqa: E402
    GaussianState,
    take_states,
)
from gaussianvi_tpu_torch.inference.optimize import run_gvi  # noqa: E402
from gaussianvi_tpu_torch.kernels import fused_gradient as tfg  # noqa: E402
from gaussianvi_tpu_torch.kernels import quad  # noqa: E402
from gaussianvi_tpu_torch.ops.blocktridiag import BlockTridiag  # noqa: E402
from gaussianvi_tpu_torch.parallel.restarts import _batch_graph  # noqa: E402

CPU = torch.device("cpu")
CUDA = torch.device("cuda")
F64 = torch.float64
N, R = 8, 3
# (JAX builder, port builder, patch size: the JAX tests' windows)
PLANNERS = {"planar": (jpl.build_planar_planning, tpl.build_planar_planning,
                       16),
            "point3d": (jp3.build_point3d_planning,
                        tp3.build_point3d_planning, 8)}
# the kernel checks' windows: small ones, so that the clamp bites often
# (and the JAX kernels, which unroll a hat sum over every cell of the
# window, compile in seconds in interpret mode)
SMALL = {"planar": 6, "point3d": 4}


def t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _build(name, patch=None, num_states=N):
    """Both packages' planner in the patch mode (the planner's window, or
    ``patch``): ``(jax (graph, init, config, sdf), port (graph, init,
    config, sdf))``."""
    jb, tb, default = PLANNERS[name]
    patch = patch or default
    return (jb(num_states=num_states, patch_size=patch, dtype=jnp.float64),
            tb(num_states=num_states, patch_size=patch, device=CPU))


def _means(sdf, rng, k, d):
    """Marginal means over and beyond the field, near the obstacle (a
    third of them, where the hinge is active), and on both of the field's
    edges along every axis."""
    data = np.asarray(sdf.data)
    sizes = np.array(data.shape[::-1], float)    # x, y (, z): cols, rows
    origin = np.asarray(sdf.origin)
    cell = float(sdf.cell_size)
    hi = origin + (sizes - 1.0) * cell
    mu = np.concatenate([
        rng.uniform(origin - 1.0, hi + 1.0, (k, sizes.size)),
        rng.standard_normal((k, d - sizes.size))], axis=1)
    near = np.argwhere(data < 0.6)[:, ::-1]      # x, y (, z) cell indices
    pick = near[rng.integers(0, len(near), k // 3)]
    mu[k - k // 3:, :sizes.size] = origin + (pick + rng.uniform(
        0.0, 1.0, pick.shape)) * cell
    for axis in range(sizes.size):
        mu[axis, axis] = origin[axis]
        mu[sizes.size + axis, axis] = hi[axis]
    return mu


@pytest.mark.parametrize("name", sorted(PLANNERS))
def test_builders_match_jax(name):
    """The planners in the patch mode: the full-state rule bit for bit, no
    marginal rule, the starts and field of the JAX builder, the window
    functor named, the whole-field ``cost_fn`` of the JAX batch."""
    (jg, _, _, jsdf), (tg, _, _, tsdf) = _build(name)
    jfb, tfb = jg.nonlinear[0], tg.nonlinear[0]
    assert jfb.lanes_prep is not None and tfb.kernel_prep is not None
    assert jfb.quad_rdim is None and tfb.quad_rdim is None
    np.testing.assert_array_equal(tfb.nodes.numpy(), np.asarray(jfb.nodes))
    np.testing.assert_array_equal(tfb.weights.numpy(),
                                  np.asarray(jfb.weights))
    np.testing.assert_array_equal(tfb.start.numpy(), np.asarray(jfb.start))
    np.testing.assert_array_equal(tfb.kernel_field.numpy(),
                                  np.asarray(jsdf.data))
    d = tfb.dim
    assert tfb.nodes.shape == ({4: 41, 6: 85}[d], d)
    assert tfb.kernel_cost == {4: "planar_patch", 6: "sdf3d_patch"}[d]
    pts = _means(jsdf, np.random.default_rng(1), 40, d)
    want = jax.vmap(lambda x: jfb.cost_fn(x, None))(jnp.asarray(pts))
    np.testing.assert_allclose(tfb.cost_fn(t(pts), None).numpy(),
                               np.asarray(want), rtol=1e-13, atol=1e-13)


def test_other_balls_ignore_patch_size():
    """A planar obstacle factor with another ``balls_fn`` (the quadrotor's
    five balls) ignores ``patch_size``, as the JAX builder does: its
    marginal rule and no kernel cost."""
    jsdf, tsdf = jpl.block_obstacle_sdf(), tpl.block_obstacle_sdf(device=CPU)
    kw = dict(state_dim=6, cost_sigma=5.0, epsilon=0.4, radius=0.2,
              patch_size=8)
    jfb = jrob.make_planar_obstacle_factor(
        jsdf, np.arange(5), balls_fn=jrob.planar_quad_balls, **kw)
    tfb = trob.make_planar_obstacle_factor(
        tsdf, np.arange(5), balls_fn=trob.planar_quad_balls, device=CPU, **kw)
    assert jfb.lanes_prep is None and jfb.quad_rdim == 3
    assert tfb.kernel_prep is None and tfb.kernel_cost is None
    assert tfb.quad_rdim == 3
    np.testing.assert_array_equal(tfb.nodes.numpy(), np.asarray(jfb.nodes))
    np.testing.assert_array_equal(tfb.weights.numpy(),
                                  np.asarray(jfb.weights))
    pts = np.random.default_rng(2).uniform(0.0, 10.0, (30, 6))
    want = jax.vmap(lambda x: jfb.cost_fn(x, None))(jnp.asarray(pts))
    np.testing.assert_allclose(tfb.cost_fn(t(pts), None).numpy(),
                               np.asarray(want), rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("name", sorted(PLANNERS))
def test_window_origins_match_jax(name):
    """``kernel_prep``'s window origins against the JAX package's
    ``make_patch_prep_*`` at random means and on the field's edges, the
    static row unchanged, the means' leading axes kept."""
    (_, _, _, jsdf), (tg, _, _, _) = _build(name)
    tfb = tg.nonlinear[0]
    patch = PLANNERS[name][2]
    d = tfb.dim
    mu = _means(jsdf, np.random.default_rng(3), 64, d)
    prep = (jrob.make_patch_prep_2d if d == 4 else jrob.make_patch_prep_3d)
    jout = prep(jsdf, patch)(jnp.asarray(mu))
    # JAX returns (patches, r0, c0) / (patches, z0, r0, c0); the port's
    # params end with the origins along x, y (, z)
    origins = np.stack([np.asarray(x) for x in jout[1:][::-1]], axis=-1)
    got = tfb.kernel_prep(t(mu).reshape(2, 32, d)).reshape(64, -1)
    np.testing.assert_array_equal(got[:, -(d // 2):].numpy(), origins)
    np.testing.assert_array_equal(
        got[:, :-(d // 2)].numpy(),
        np.broadcast_to(tfb.kernel_params[0, :-(d // 2)].numpy(),
                        (64, got.shape[1] - d // 2)))
    assert origins.min() == 0 and (origins > 0).any()


@pytest.mark.parametrize("name", sorted(PLANNERS))
def test_window_costs_match_jax_hat_sums(name):
    """The window functors' plain forms on the params ``kernel_prep``
    forms against the JAX package's hat sums on the pre-gathered windows:
    points inside and well outside each window (the clamp), on its upper
    edge exactly, and a NaN coordinate, which stays NaN.  The plain forms
    add the two nonzero hats of each axis in the hat sum's order with its
    weights, so they agree bit for bit."""
    (jg, _, _, jsdf), (tg, _, _, _) = _build(name)
    tfb = tg.nonlinear[0]
    d, patch = tfb.dim, PLANNERS[name][2]
    rng = np.random.default_rng(4)
    mu = _means(jsdf, rng, 48, d)
    jout = (jrob.make_patch_prep_2d if d == 4
            else jrob.make_patch_prep_3d)(jsdf, patch)(jnp.asarray(mu))
    x = mu + rng.standard_normal(mu.shape) * rng.choice([0.05, 0.5, 2.0],
                                                        (48, 1))
    cell = float(jsdf.cell_size)
    origin = np.asarray(jsdf.origin)
    first = [np.asarray(o) for o in jout[1:][::-1]]          # x, y (, z)
    x[0, 0] = origin[0] + (first[0][0] + patch - 1) * cell   # upper edge
    x[1, 1] = origin[1] + first[1][1] * cell                 # lower edge
    x[2, 0] = np.nan
    form = quad.cost_form(tfb.kernel_cost, tfb.kernel_field)
    got = form(t(x), tfb.kernel_prep(t(mu))).numpy()
    jcost = jg.nonlinear[0].lanes_cost
    want = np.asarray(jax.vmap(lambda xx, *leaves: jcost(tuple(xx), *leaves))(
        jnp.asarray(x), *jout))
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[2]) and (got > 0).sum() > 4


def _marginals(jsdf, rng, k, d, scale):
    """Means over the field and wide covariances: ``scale`` cells of
    spread, so that sigma points leave their windows."""
    mu = _means(jsdf, rng, k, d)
    a = rng.standard_normal((k, d, d)) * scale * float(jsdf.cell_size)
    return mu, a @ np.swapaxes(a, -1, -2) + 1e-3 * np.eye(d)


@pytest.mark.parametrize("moments", [False, True], ids=["phi", "moments"])
@pytest.mark.parametrize("name", sorted(PLANNERS))
def test_quad_plain_matches_jax_lanes(name, moments):
    """K3's plain version on a patch-mode batch (its params formed from the
    means) against the JAX package's ``batch_phi`` / ``batch_moments`` on
    the lanes route (interpret mode), wide covariances so that the clamp
    bites: rtol 1e-11, atol 1e-13."""
    (jg, _, _, jsdf), (tg, _, _, _) = _build(name, SMALL[name])
    jfb, tfb = jg.nonlinear[0], tg.nonlinear[0]
    # factors: the JAX lanes kernel refuses 3-D windows of 24 factors on
    # the CPU (its VMEM accounting), so the 3-D case takes the planner's 8
    mu, cov = _marginals(jsdf, np.random.default_rng(5),
                         {"planar": 24, "point3d": 8}[name], tfb.dim,
                         SMALL[name] / 2)
    if moments:
        want = jmm.batch_moments(jfb, jnp.asarray(mu), jnp.asarray(cov),
                                 quad_impl="lanes")
        got = tmm.batch_moments(tfb, t(mu), t(cov), use_kernel=True)
    else:
        want = (jmm.batch_phi(jfb, jnp.asarray(mu), jnp.asarray(cov), None,
                              "lanes"),)
        got = (tmm.batch_phi(tfb, t(mu), t(cov), True),)
    assert jmm._lanes_eligible(jfb, None, moments)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-11,
                                   atol=1e-13)
    # the window matters here: the whole-field cost gives other values
    plain = tmm.batch_phi(tfb, t(mu), t(cov), False)
    assert not torch.allclose(plain, got[0], rtol=1e-6, equal_nan=True)


def _restarts(init, rng, count=R):
    noise = 0.3 * rng.standard_normal((count, *np.shape(init.mu)))
    noise[0] = 0.0
    return np.asarray(init.mu) + noise


def _iterate(init, rng, count):
    """``count`` problems' iterates near the initial state."""
    mu = _restarts(init, rng, count)
    q = rng.standard_normal((count, *np.shape(init.precision.diag)))
    pd = np.asarray(init.precision.diag) + 0.2 * q @ np.swapaxes(q, -1, -2)
    po = 0.3 * rng.standard_normal((count, *np.shape(init.precision.off)))
    return mu, pd, po, np.linspace(1.0, 3.0, count)


def _jax_operands(jg, mus):
    """The JAX engine's fused gradient operands for a patch-mode graph,
    the windows spliced from each problem's means (``_splice_preps``) and
    stacked over the problems."""
    cfg = JaxConfig(chain_impl="lanes", quad_impl="lanes")
    eng = JaxEngine(jg, cfg)
    nl_specs, lin_specs, flat, _, preps = eng._build_fused_specs(
        cfg, allow_prep=True)
    flats = [list(JaxEngine._splice_preps(flat, preps, jnp.asarray(m)))
             for m in mus]

    def take(shared):
        col = [f.pop(0) for f in flats]
        return col[0] if shared else jnp.stack(col)

    nl, lin = [], []
    for sp in nl_specs:
        st = take(True) if sp.slice_offset is None else None
        nodes, w = take(True), take(True)
        nl.append((st, nodes, w, tuple(take(False) for _ in sp.param_shapes)))
    for sp in lin_specs:
        st = take(True) if sp.slice_offset is None else None
        lin.append((st, *(take(False) for _ in range(4))))
    return nl_specs, lin_specs, tuple(nl), tuple(lin)


def _port_operands(tg, mu):
    """The port engine's K6 operands for the batched graph with each
    patch-mode batch's params formed from ``mu`` (what the engine hands
    K6 in ``fused_gradient``)."""
    nl_specs, lin_specs, nl_arrays, lin_arrays = fused_operands(
        tg, trials=False)
    nl_arrays = tuple(
        (st, nd, w, fb.kernel_prep(take_states(mu, fb.start,
                                               fb.slice_offset, 1)), *field)
        for fb, (st, nd, w, _, *field) in zip(tg.nonlinear, nl_arrays))
    return nl_specs, lin_specs, nl_arrays, lin_arrays


def _close(got, want):
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want),
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("mode", ["full", "accum"])
def test_gradient_plain_matches_jax_kernel(mode):
    """K6's plain version on the planar planner's patch-mode batch (s = 4,
    windows of 4 cells, three problems moved off the initial state,
    per-problem temperatures) against the JAX kernel in interpret mode
    with the windows spliced from each problem's means: mode ``full``, and
    mode ``accum`` on the second half of the factors (rank 1's shard at
    fp = 2): 1e-10.  (The 3-D functor's K6 runs in the point planner's
    run below; each JAX compile of this kernel takes 12-25 s here.)"""
    (jg, jinit, _, _), (tg, _, _, _) = _build("planar", 4)
    x = _iterate(jinit, np.random.default_rng(6), 3)
    tx, jx = tuple(map(t, x)), tuple(map(jnp.asarray, x))
    jops = _jax_operands(jg, x[0])
    tops = _port_operands(_batch_graph(tg, 3), tx[0])
    if mode == "full":
        want = jfg.gradient_lanes(*jx, *jops, interpret=True)
        got = tfg.gradient_plain(*tx, *tops)
        for g, w in zip(got, want):
            _close(g, w)
        assert np.isfinite(got[6].numpy()).all()
        return
    (jsp,), _, ((_, jn, jw, jleaves),), _ = jops
    (tsp,), _, ((_, tn, tw, tp, tf),), _ = tops
    k = jsp.k // 2
    part = slice(k, 2 * k)
    want = jfg.gradient_lanes(
        *jx, (jsp._replace(k=k, slice_offset=None),), (),
        ((jnp.arange(k, 2 * k), jn, jw,
          tuple(leaf[:, part] for leaf in jleaves)),), (),
        interpret=True, mode="accum")
    got = tfg.gradient_plain(
        *tx, (tsp._replace(k=k, slice_offset=None),), (),
        ((torch.arange(k, 2 * k), tn, tw, tp[:, part], tf),), (),
        mode="accum")
    for g, w in zip(got, want):
        _close(g, w)
    assert float(got[1].abs().max()) > 0


def _card_routes(graph, config, init_mu):
    """The port's run on the routes the engine resolves for the card (K1,
    K2, K3 and K6; K5 off), here on CPU tensors, so every kernel wrapper
    runs its plain version: ``(state, history, engine)``."""
    prec = graph[1].precision
    count = init_mu.shape[0]
    state = GaussianState(t(init_mu), BlockTridiag(
        prec.diag.expand(count, *prec.diag.shape).clone(),
        prec.off.expand(count, *prec.off.shape).clone()))
    engine = LocalEngine(_batch_graph(graph[0], count), config, CUDA)
    return (*run_gvi(engine, state, config), engine)


def _jax_states(jinit, mu):
    prec = jinit.precision
    return JaxState(jnp.asarray(mu), JaxBlockTridiag(
        jnp.broadcast_to(prec.diag, (len(mu), *prec.diag.shape)),
        jnp.broadcast_to(prec.off, (len(mu), *prec.off.shape))))


ITERS = dict(niters=4, niters_lowtemp=4)


def test_point_planner_matches_jax_lanes_run():
    """The point planner (N = 8, windows of 4 voxels, three restarts, 4
    iterations) on the card's routes (K6 with the windows of the current means, the separate
    trial costs on K3 with the trials' windows) against ``jax.vmap``
    of JAX ``optimize`` with ``quad_impl="lanes"`` (interpret mode; its
    gradient on the lanes quadrature, ``fused_gradient="off"``, which
    equals its fused gradient kernel): relative cost 1e-9, the same
    accepted steps; and the port's fused gradient on against off, 1e-9."""
    (jg, jinit, jcfg, _), built = _build("point3d", SMALL["point3d"])
    mu = _restarts(jinit, np.random.default_rng(7))
    jcfg = replace(jcfg, **ITERS, quad_impl="lanes", fused_gradient="off")
    jstate, jhist = jax.jit(jax.vmap(lambda s: jax_optimize(jg, s, jcfg)))(
        _jax_states(jinit, mu))
    cfg = replace(built[2], **ITERS)
    state, hist, engine = _card_routes(built, cfg, mu)
    assert engine.quad_batches == (True,) and engine.chain_impl == "lanes"
    assert engine.fused_gradient_ready and not engine.fused_trials_ready
    np.testing.assert_allclose(hist.cost.numpy(), np.asarray(jhist.cost),
                               rtol=1e-9)
    np.testing.assert_array_equal(hist.accepted_step.numpy(),
                                  np.asarray(jhist.accepted_step))
    np.testing.assert_allclose(state.mu.numpy(), np.asarray(jstate.mu),
                               atol=1e-9)
    assert (hist.accepted_step > 0).any()
    _, hist_off, engine_off = _card_routes(
        built, replace(cfg, fused_gradient="off"), mu)
    assert not engine_off.fused_gradient_ready
    np.testing.assert_allclose(hist.cost.numpy(), hist_off.cost.numpy(),
                               rtol=1e-9)
    np.testing.assert_array_equal(hist.accepted_step.numpy(),
                                  hist_off.accepted_step.numpy())


def test_cpu_plain_route_matches_jax_xla_route():
    """On the CPU, ``"auto"`` takes the plain route, which evaluates the
    batch's whole-field ``cost_fn`` on the full-state rule, as JAX's
    ``"xla"`` route does with ``patch_size`` set: the planar planner (N =
    8, three restarts, 4 iterations) against ``jax.vmap(optimize)``,
    relative cost 1e-9 and the same steps."""
    (jg, jinit, jcfg, _), (tg, _, tcfg, _) = _build("planar")
    mu = _restarts(jinit, np.random.default_rng(8))
    _, jhist = jax.jit(jax.vmap(lambda s: jax_optimize(
        jg, s, replace(jcfg, **ITERS))))(_jax_states(jinit, mu))
    graph = _batch_graph(tg, R)
    prec = tpl.build_planar_planning(num_states=N, device=CPU)[1].precision
    state = GaussianState(t(mu), BlockTridiag(
        prec.diag.expand(R, *prec.diag.shape).clone(),
        prec.off.expand(R, *prec.off.shape).clone()))
    engine = LocalEngine(graph, tcfg, CPU)
    assert engine.quad_batches == (False,) and not engine.fused_gradient_ready
    _, hist = optimize(graph, state, replace(tcfg, **ITERS))
    np.testing.assert_allclose(hist.cost.numpy(), np.asarray(jhist.cost),
                               rtol=1e-9)
    np.testing.assert_array_equal(hist.accepted_step.numpy(),
                                  np.asarray(jhist.accepted_step))


@pytest.mark.parametrize("name", sorted(PLANNERS))
def test_engine_resolution(name):
    """As the JAX engine resolves a prep batch: K5 off under ``"auto"``
    and ``ValueError`` under ``"on"``, K6 taken under ``"auto"``;
    ``fused_trials.covers`` refuses the window costs with its reason,
    K6's does not; the sequence-parallel engine's ``"lanes"`` raises for
    the batch and ``"auto"`` takes its ``cost_fn``."""
    from gaussianvi_tpu_torch.kernels import fused_trials as tft
    from gaussianvi_tpu_torch.parallel.time_sharding import TimeShardEngine

    (jg, _, jcfg, _), (tg, _, tcfg, _) = _build(name)
    jeng = JaxEngine(jg, replace(jcfg, chain_impl="lanes", quad_impl="lanes"))
    assert jeng.fused_gradient_ready and not jeng.fused_trials_ready
    graph = _batch_graph(tg, 2)
    engine = LocalEngine(graph, tcfg, CUDA)
    assert engine.fused_gradient_ready and not engine.fused_trials_ready
    with pytest.raises(ValueError, match="follow the factors' means"):
        LocalEngine(graph, replace(tcfg, fused_trials="on"), CUDA)
    specs = fused_operands(graph, trials=False)[:2]
    assert "trial kernel" in tft.covers(tg.state_dim, F64, *specs)
    assert tft.covers(tg.state_dim, F64, *specs, trials=False) is None
    assert isinstance(fused_operands(graph), str)
    assert "not instantiated for cost" in tfg.covers(
        2, ("full",), {tg.nonlinear[0].kernel_cost})
    chain_graph = parallel.to_chain_layout(tg)
    mesh = parallel.make_mesh(1, 1)
    with pytest.raises(ValueError, match="takes its cost_fn"):
        TimeShardEngine(chain_graph, replace(tcfg, quad_impl="lanes"), mesh,
                        CUDA)
    assert TimeShardEngine(chain_graph, tcfg, mesh, CUDA).quad_batches == (
        False,)
