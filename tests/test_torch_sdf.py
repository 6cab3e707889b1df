"""PyTorch port, the SDF and robot modules (``factors/sdf.py``,
``factors/sdf_io.py``, ``factors/robots.py``) and the planar kernel cost's
plain form (``kernels/quad.py`` ``KERNEL_COSTS["planar_sdf"]``) against the
JAX package on the same numpy-seeded inputs (CPU, f64)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gaussianvi_tpu.examples.planar_planning import (  # noqa: E402
    block_obstacle_sdf as jax_block_sdf,
)
from gaussianvi_tpu.factors import robots as jrob  # noqa: E402
from gaussianvi_tpu.factors import sdf as jsdf  # noqa: E402
from gaussianvi_tpu.factors import sdf_io as jio  # noqa: E402
from gaussianvi_tpu_torch.examples.planar_planning import (  # noqa: E402
    block_obstacle_sdf,
)
from gaussianvi_tpu_torch.factors import robots as trob  # noqa: E402
from gaussianvi_tpu_torch.factors import sdf as tsdf  # noqa: E402
from gaussianvi_tpu_torch.factors import sdf_io as tio  # noqa: E402
from gaussianvi_tpu_torch.factors.moments import expectation_phi  # noqa: E402
from gaussianvi_tpu_torch.kernels import quad  # noqa: E402

CPU = torch.device("cpu")
F64 = torch.float64


def t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _fields(rng):
    """A 2-D field [7, 9] and a 3-D field [4, 5, 6] with their JAX twins."""
    d2 = rng.standard_normal((7, 9))
    d3 = rng.standard_normal((4, 5, 6))
    o2, o3, cell = np.array([-1.0, 0.5]), np.array([0.5, -1.0, 0.25]), 0.37
    jax_fields = (jsdf.PlanarSDF(jnp.asarray(d2), jnp.asarray(o2),
                                 jnp.asarray(cell)),
                  jsdf.SDF3D(jnp.asarray(d3), jnp.asarray(o3),
                             jnp.asarray(cell)))
    port_fields = (tsdf.PlanarSDF(t(d2), t(o2), t(cell)),
                   tsdf.SDF3D(t(d3), t(o3), t(cell)))
    return jax_fields, port_fields


def _points(field, rng, n=200):
    """Points over and beyond a field's extent: random ones (a third off
    the field), every grid node, the last row and column (and plane), and
    the far corners."""
    data, origin, cell = (np.asarray(field.data), np.asarray(field.origin),
                          float(field.cell_size))
    dims = data.ndim
    # (x, y[, z]) extents: cols, rows[, z]
    sizes = [data.shape[-1], data.shape[-2]] + ([data.shape[0]]
                                                if dims == 3 else [])
    hi = origin + (np.asarray(sizes) - 1.0) * cell
    span = hi - origin
    pts = [origin - 0.5 * span + 2.0 * span * rng.random((n, dims))]
    grids = np.meshgrid(*[origin[i] + cell * np.arange(sizes[i])
                          for i in range(dims)], indexing="ij")
    pts.append(np.stack([g.ravel() for g in grids], -1))
    edge = origin + span * rng.random((n // 4, dims))
    for axis in range(dims):           # on the last row / column / plane
        e = edge.copy()
        e[:, axis] = hi[axis]
        pts.append(e)
    pts.append(np.array([origin - 1.0, hi + 1.0, hi, origin]))
    return np.concatenate(pts)


@pytest.mark.parametrize("which", [0, 1], ids=["planar", "3d"])
@pytest.mark.parametrize("method", ["signed_distance",
                                    "signed_distance_matmul"])
def test_signed_distance_matches_jax(which, method):
    rng = np.random.default_rng(which)
    jf, pf = (f[which] for f in _fields(rng))
    pts = _points(jf, rng)
    want = np.asarray(getattr(jf, method)(jnp.asarray(pts)))
    got = getattr(pf, method)(t(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # the two interpolations agree with each other too
    other = pf.signed_distance(t(pts)).numpy()
    np.testing.assert_allclose(got, other, rtol=0, atol=1e-12)


def test_point_to_cell_matches_jax():
    rng = np.random.default_rng(3)
    jf, pf = (f[0] for f in _fields(rng))
    pts = _points(jf, rng)
    np.testing.assert_allclose(pf.point_to_cell(t(pts)).numpy(),
                               np.asarray(jf.point_to_cell(jnp.asarray(pts))),
                               rtol=0, atol=1e-13)


@pytest.mark.parametrize("radius", [0.3, [0.1, 0.2, 0.5]])
def test_hinge_obstacle_cost_matches_jax(radius):
    rng = np.random.default_rng(4)
    sd = rng.uniform(-1.0, 2.0, (5, 3))
    want = np.asarray(jsdf.hinge_obstacle_cost(jnp.asarray(sd), 0.4, radius,
                                               5.0, 1.5))
    got = tsdf.hinge_obstacle_cost(t(sd), 0.4, radius, 5.0, 1.5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)
    assert (got[(sd > 0.4 + np.max(radius)).all(-1)] == 0).all()


# ---------------------------------------------------------------------------
# sdf_io
# ---------------------------------------------------------------------------

def _brute_edt(mask):
    pts = np.argwhere(mask)
    out = np.zeros(mask.shape)
    for idx in np.ndindex(mask.shape):
        out[idx] = np.sqrt(((pts - np.asarray(idx)) ** 2).sum(-1).min())
    return out


@pytest.mark.parametrize("shape", [(13, 17), (5, 6, 7)])
def test_edt_matches_brute_force(shape):
    rng = np.random.default_rng(len(shape))
    mask = rng.random(shape) < 0.15
    mask[(0,) * len(shape)] = True
    np.testing.assert_allclose(tio._edt_numpy(mask), _brute_edt(mask),
                               atol=1e-9)
    np.testing.assert_array_equal(tio._edt_numpy(mask), jio._edt_numpy(mask))
    np.testing.assert_allclose(tio._edt(mask), _brute_edt(mask), atol=1e-9)
    assert (tio._edt(np.zeros(shape, bool)) == 0).all()


@pytest.mark.parametrize("shape", [(12, 15), (4, 6, 5)])
@pytest.mark.parametrize("use_scipy", [None, False])
def test_sdf_from_occupancy_matches_jax(shape, use_scipy):
    rng = np.random.default_rng(sum(shape))
    occ = rng.random(shape) < 0.2
    origin = rng.standard_normal(len(shape))
    want = jio.sdf_from_occupancy(occ, 0.25, origin, dtype=jnp.float64,
                                  use_scipy=use_scipy)
    got = tio.sdf_from_occupancy(occ, 0.25, origin, use_scipy=use_scipy,
                                 device=CPU)
    assert type(got).__name__ == type(want).__name__
    for name in ("data", "origin", "cell_size"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), atol=1e-12)
        assert getattr(got, name).dtype == F64


@pytest.mark.parametrize("which", [0, 1], ids=["planar", "3d"])
def test_npz_round_trips_between_packages(tmp_path, which):
    """A field saved by either package loads in the other, unchanged."""
    rng = np.random.default_rng(7)
    jf, pf = (f[which] for f in _fields(rng))
    jio.save_sdf(tmp_path / "jax.npz", jf)
    tio.save_sdf(tmp_path / "torch.npz", pf)
    from_jax = tio.load_sdf(tmp_path / "jax.npz", device=CPU)
    from_torch = jio.load_sdf(tmp_path / "torch.npz", dtype=jnp.float64)
    assert type(from_jax) is type(pf)
    assert type(from_torch) is type(jf)
    for name in ("data", "origin", "cell_size"):
        ref = getattr(pf, name).numpy()
        np.testing.assert_array_equal(getattr(from_jax, name).numpy(), ref)
        np.testing.assert_array_equal(np.asarray(getattr(from_torch, name)),
                                      ref)


# ---------------------------------------------------------------------------
# robots
# ---------------------------------------------------------------------------

def test_ball_models_match_jax():
    rng = np.random.default_rng(8)
    poses = rng.standard_normal((6, 6))
    for jfn, tfn in ((jrob.planar_point_balls, trob.planar_point_balls),
                     (jrob.planar_quad_balls, trob.planar_quad_balls),
                     (jrob.point3d_balls, trob.point3d_balls)):
        want = np.stack([np.asarray(jfn(jnp.asarray(p))) for p in poses])
        got = tfn(t(poses)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        # batched poses [2, 3, d] give the per-pose balls
        np.testing.assert_allclose(tfn(t(poses.reshape(2, 3, 6))).numpy(),
                                   want.reshape(2, 3, *want.shape[1:]),
                                   rtol=0, atol=1e-12)


def _fk(rng):
    j, s = 4, 6
    arrays = dict(a=rng.uniform(0.2, 1.0, j), alpha=rng.uniform(-1.5, 1.5, j),
                  d=rng.uniform(-0.3, 0.3, j),
                  theta_bias=rng.uniform(-0.5, 0.5, j))
    frames = rng.integers(0, j, s)
    centers = rng.standard_normal((s, 3)) * 0.2
    jfk = jrob.DHForwardKinematics(
        **{k: jnp.asarray(v) for k, v in arrays.items()},
        frames=jnp.asarray(frames), centers=jnp.asarray(centers))
    tfk = trob.DHForwardKinematics(
        **{k: t(v) for k, v in arrays.items()},
        frames=torch.as_tensor(frames), centers=t(centers))
    return jfk, tfk


def test_dh_forward_kinematics_matches_jax():
    rng = np.random.default_rng(9)
    jfk, tfk = _fk(rng)
    thetas = rng.uniform(-np.pi, np.pi, (5, 4))
    for method in ("joint_transforms", "sphere_centers"):
        want = np.stack([np.asarray(getattr(jfk, method)(jnp.asarray(th)))
                         for th in thetas])
        got = getattr(tfk, method)(t(thetas)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_patch_functions_match_jax():
    """The window mode's prep and costs, 2-D and 3-D, as plain tensor
    functions (the JAX costs take component lists, as its lanes kernel
    hands them)."""
    rng = np.random.default_rng(10)
    (jf2, jf3), (tf2, tf3) = _fields(rng)
    for jf, tf, dims, patch in ((jf2, tf2, 2, 4), (jf3, tf3, 3, 3)):
        mu = _points(jf, rng, 12)[:12]
        jprep = (jrob.make_patch_prep_2d if dims == 2
                 else jrob.make_patch_prep_3d)(jf, patch)(jnp.asarray(mu))
        tprep = (trob.make_patch_prep_2d if dims == 2
                 else trob.make_patch_prep_3d)(tf, patch)(t(mu))
        for a, b in zip(tprep, jprep):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        x = mu + 0.3 * rng.standard_normal(mu.shape)
        args = (0.4, 0.2, 5.0, 1.5)
        jcost = (jrob.make_patch_cost_2d if dims == 2
                 else jrob.make_patch_cost_3d)(jf, patch, *args)
        tcost = (trob.make_patch_cost_2d if dims == 2
                 else trob.make_patch_cost_3d)(tf, patch, *args)
        want = np.asarray(jcost(list(jnp.asarray(x.T)),
                                jnp.moveaxis(jprep[0], 0, -1), *jprep[1:]))
        got = tcost(t(x), *tprep).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        assert (got > 0).any()


def test_patch_mode_raises():
    """The patch mode raises for a window wider than the field (the JAX
    package's ``dynamic_slice`` fails at trace time) and builds the window
    functors' batches at every width that fits: the full-state rule, the
    static row with the windows at the field's origin, the field, and a
    prep whose windows follow the means."""
    rng = np.random.default_rng(14)
    _, (tf2, tf3) = _fields(rng)
    with pytest.raises(ValueError, match="patch_size=8 does not fit"):
        trob.make_planar_obstacle_factor(tf2, np.arange(3), 4, patch_size=8,
                                         device=CPU)
    with pytest.raises(ValueError, match="patch_size=5 does not fit"):
        trob.make_point3d_obstacle_factor(tf3, np.arange(3), 6, patch_size=5,
                                          device=CPU)
    fb2 = trob.make_planar_obstacle_factor(tf2, np.arange(3), 4, patch_size=4,
                                           device=CPU)
    fb3 = trob.make_point3d_obstacle_factor(tf3, np.arange(3), 6,
                                            patch_size=3, device=CPU)
    for fb, cost, width, d in ((fb2, "planar_patch", 10, 4),
                               (fb3, "sdf3d_patch", 12, 6)):
        assert fb.kernel_cost == cost and fb.quad_rdim is None
        assert fb.nodes.shape == (41 if d == 4 else 85, d)
        assert fb.kernel_params.shape == (3, width)
        assert (fb.kernel_params[:, -(d // 2):] == 0).all()
        mu = t(rng.uniform(0.0, 2.0, (3, d)))
        row = fb.kernel_prep(mu)
        assert torch.equal(row[:, :-(d // 2)], fb.kernel_params[:, :-(d // 2)])
    assert torch.equal(fb2.kernel_field, tf2.data)
    assert torch.equal(fb3.kernel_field, tf3.data)


# ---------------------------------------------------------------------------
# the obstacle factors and the kernel cost's plain form
# ---------------------------------------------------------------------------

def _planner_points(rng, n=400):
    """Sigma points for the planner's field: clear of the obstacle, inside
    it, off the field, on the last row and column, on grid nodes."""
    cell = 10.0 / 99
    pts = [rng.uniform(-2.0, 12.0, (n, 4)),                  # incl. off-field
           np.c_[rng.uniform(4.0, 6.0, (n, 1)), rng.uniform(3.0, 5.0, (n, 1)),
                 rng.standard_normal((n, 2))],               # inside
           np.c_[np.full((20, 1), 10.0), rng.uniform(0, 10, (20, 1)),
                 np.zeros((20, 2))],                         # last column
           np.c_[rng.uniform(0, 10, (20, 1)), np.full((20, 1), 10.0),
                 np.zeros((20, 2))],                         # last row
           np.c_[cell * rng.integers(0, 100, (40, 2)), np.zeros((40, 2))]]
    return np.concatenate(pts)


@pytest.mark.parametrize("interp", ["gather", "matmul"])
def test_planar_obstacle_factor_matches_jax(interp):
    """The factor: rule, marginal dims, nonneg contract, the cost_fn on
    batched points; the gather names the kernel cost, the matmul does
    not."""
    jf = jax_block_sdf(dtype=jnp.float64)
    tf = block_obstacle_sdf(device=CPU)
    kw = dict(state_dim=4, cost_sigma=5.0, epsilon=0.4, radius=0.2,
              interp=interp)
    jb = jrob.make_planar_obstacle_factor(jf, np.arange(5), **kw,
                                          dtype=jnp.float64)
    tb = trob.make_planar_obstacle_factor(tf, np.arange(5), **kw, device=CPU)
    np.testing.assert_array_equal(tb.nodes.numpy(), np.asarray(jb.nodes))
    np.testing.assert_array_equal(tb.weights.numpy(), np.asarray(jb.weights))
    assert (tb.quad_rdim, tb.nonneg_cost, tb.slice_offset, tb.nb) == (
        jb.quad_rdim, jb.nonneg_cost, jb.slice_offset, jb.nb) == (2, True, 0, 1)
    assert tb.nodes.shape == (13, 4)
    pts = _planner_points(np.random.default_rng(11))
    want = np.asarray([jb.cost_fn(jnp.asarray(p), None) for p in pts])
    got = tb.cost_fn(t(pts), None).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)
    if interp == "gather":
        assert tb.kernel_cost == "planar_sdf"
        assert tb.kernel_params.shape == (5, 7)
        np.testing.assert_array_equal(tb.kernel_field.numpy(),
                                      np.asarray(jf.data))
    else:
        assert tb.kernel_cost is None and tb.kernel_field is None


@pytest.mark.parametrize("build", ["point3d", "arm", "quad"])
def test_cost_fn_only_obstacle_factors_match_jax(build):
    """The 3-D point, arm and planar-quadrotor factors: the JAX rule and
    cost; the arm and quadrotor name no kernel cost (plain routes), the
    3-D point robot's gather the ``"sdf3d"`` functor."""
    rng = np.random.default_rng(12)
    (jf2, jf3), (tf2, tf3) = _fields(rng)
    if build == "point3d":
        jb = jrob.make_point3d_obstacle_factor(jf3, np.arange(3), 6,
                                               dtype=jnp.float64)
        tb = trob.make_point3d_obstacle_factor(tf3, np.arange(3), 6,
                                               device=CPU)
        d = 6
    elif build == "arm":
        jfk, tfk = _fk(rng)
        radii = [0.1, 0.2, 0.1, 0.3, 0.2, 0.1]
        jb = jrob.make_arm_obstacle_factor(jf3, jfk, jnp.asarray(radii),
                                           np.arange(3), 8, gh_degree=2,
                                           dtype=jnp.float64)
        tb = trob.make_arm_obstacle_factor(tf3, tfk, radii, np.arange(3), 8,
                                           gh_degree=2, device=CPU)
        d = 8
    else:
        jb = jrob.make_planar_obstacle_factor(
            jf2, np.arange(3), 6, balls_fn=jrob.planar_quad_balls,
            dtype=jnp.float64)
        tb = trob.make_planar_obstacle_factor(
            tf2, np.arange(3), 6, balls_fn=trob.planar_quad_balls, device=CPU)
        d = 6
    assert tb.kernel_cost == ("sdf3d" if build == "point3d" else None)
    assert tb.quad_rdim == jb.quad_rdim
    np.testing.assert_array_equal(tb.nodes.numpy(), np.asarray(jb.nodes))
    np.testing.assert_array_equal(tb.weights.numpy(), np.asarray(jb.weights))
    pts = rng.standard_normal((30, d))
    want = np.asarray([jb.cost_fn(jnp.asarray(p), None) for p in pts])
    np.testing.assert_allclose(tb.cost_fn(t(pts), None).numpy(), want,
                               rtol=1e-13, atol=1e-13)


def test_planar_sdf_kernel_form_matches_jax_cost():
    """``KERNEL_COSTS["planar_sdf"]``'s plain form on the packed params and
    the field equals the JAX factor's ``cost_fn`` (PlanarSDF
    signed_distance + hinge_obstacle_cost) at every kind of point."""
    jf = jax_block_sdf(dtype=jnp.float64)
    tb = trob.make_planar_obstacle_factor(
        block_obstacle_sdf(device=CPU), np.arange(3), 4, cost_sigma=5.0,
        epsilon=0.4, radius=0.2, device=CPU)
    jb = jrob.make_planar_obstacle_factor(jf, np.arange(3), 4, cost_sigma=5.0,
                                          epsilon=0.4, radius=0.2,
                                          interp="gather", dtype=jnp.float64)
    pts = _planner_points(np.random.default_rng(13))
    form = quad.cost_form("planar_sdf", tb.kernel_field)
    got = form(t(pts), tb.kernel_params[0]).numpy()
    want = np.asarray([jb.cost_fn(jnp.asarray(p), None) for p in pts])
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)
    assert (got == 0).any() and (got > 0).any()
    # NaN points stay NaN through the clip and the hinge
    nan = form(t([[np.nan, 1.0, 0, 0]]), tb.kernel_params[0])
    assert torch.isnan(nan).all()


def test_all_clear_factor_has_exact_zero_expectation():
    """Every sigma point of a factor clear of the obstacle (outside
    eps + radius) gives phi = 0: the guarded E[phi] is exactly 0, not NaN
    (the cancellation and nonneg tests are strict), on the plain routes
    and through the kernel cost's plain form; a factor touching the
    obstacle stays finite and positive."""
    tb = trob.make_planar_obstacle_factor(
        block_obstacle_sdf(device=CPU), np.arange(3), 4, cost_sigma=5.0,
        epsilon=0.4, radius=0.2, device=CPU)
    mu = t([[1.0, 1.0, 0.5, 0.5], [8.5, 8.5, 0.5, 0.5], [5.0, 2.9, 0, 0]])
    cov = (0.01 * torch.eye(4, dtype=F64)).expand(3, 4, 4)
    plain = expectation_phi(tb.nodes, tb.weights, mu, cov, tb.cost_fn, None,
                            nonneg=True)
    kern = quad.quad_phi_plain(mu, cov, tb.nodes, tb.weights, "planar_sdf",
                               tb.kernel_params, nonneg=True,
                               field=tb.kernel_field)
    for e in (plain, kern):
        assert e[0].item() == 0.0 and e[1].item() == 0.0
        assert torch.isfinite(e[2]) and e[2] > 0
    np.testing.assert_allclose(kern.numpy(), plain.numpy(), rtol=1e-14)
    moments = quad.quad_moments_plain(mu, cov, tb.nodes, tb.weights,
                                      "planar_sdf", tb.kernel_params, rdim=2,
                                      field=tb.kernel_field)
    for m in moments:
        assert (m[:2] == 0).all() and torch.isfinite(m).all()


def test_kernel_covers_the_planar_batch():
    """K3 covers the gather batch (d = 4, P = 7, a 2-D field in the
    batch's dtype) and names what is missing otherwise."""
    from dataclasses import replace

    from gaussianvi_tpu_torch.factors.moments import kernel_covers

    tb = trob.make_planar_obstacle_factor(
        block_obstacle_sdf(device=CPU), np.arange(3), 4, device=CPU)
    assert kernel_covers(tb) is None
    assert "carries none" in kernel_covers(replace(tb, kernel_field=None))
    assert "dtype" in kernel_covers(
        replace(tb, kernel_field=tb.kernel_field.float()))
    assert "2-D" in kernel_covers(
        replace(tb, kernel_field=tb.kernel_field[0]))
    assert "reads no field" in quad.covers("range", 4, 4, 29, F64,
                                           tb.kernel_field)
