"""PyTorch port, the factor-parallel (dp x fp) path: the split fused
gradient pair (K6 ``accum`` / ``solve``) against the JAX kernels in Pallas
interpret mode, ``optimize_sharded`` / ``sharded_ngd_step`` on gloo ranks
against the JAX package's ``optimize_sharded`` on its 8-virtual-device CPU
mesh and against the port's ``optimize`` (the loop's options included),
and ``joint_cost`` and the restarts' best-of selection against the JAX
package (CPU, f64).

Every sharded run of this file happens in ONE group of four rank processes
(``ranks`` fixture); the tests read its results.  The rank processes import
this module to find :func:`_rank_jobs`, so JAX (and the test modules that
import it) is imported inside the functions that use it: a rank never
loads it.
"""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gaussianvi_tpu_torch import GVIConfig, optimize, stack_problems  # noqa: E402
from gaussianvi_tpu_torch import parallel  # noqa: E402
from gaussianvi_tpu_torch.convert import (  # noqa: E402
    graph_from_arrays,
    state_from_arrays,
)
from gaussianvi_tpu_torch.inference.engine import fused_operands  # noqa: E402
from gaussianvi_tpu_torch.kernels import fused_gradient as tfg  # noqa: E402
from gaussianvi_tpu_torch.parallel.multiprocess import spawn_ranks  # noqa: E402
from gaussianvi_tpu_torch.parallel.sharding import FactorShardEngine  # noqa: E402

CPU = torch.device("cpu")

WORLD = 4
MESHES = [(2, 2), (1, 4), (4, 1)]
_BENCH = dict(niters=5, niters_lowtemp=5, step_size_base=0.9)
# variant -> (method, config fields of both packages, the port's extra
# fields, the JAX package's extra fields)
VARIANTS = {
    # the fused kernels' plain versions on CPU tensors; on the JAX side the
    # lanes kernels in interpret mode under shard_map
    "ngd-fused": ("ngd", _BENCH, dict(fused_trials="on", fused_gradient="on"),
                  dict(chain_impl="lanes", quad_impl="lanes")),
    "ngd-separate": ("ngd", _BENCH, {}, {}),
    "prox": ("prox", dict(_BENCH, step_size_base=0.1), {}, {}),
}
# the loop's options on the (2, 2) mesh, NGD, held to JAX
# ``optimize_sharded`` with the same option and to the port's ``optimize``
OPTIONS = {"bf16": dict(moments_eval_dtype="bfloat16"),
           "seq": dict(linesearch="seq"), "ema": dict(ema_alpha=0.5)}
# problem sets: (num_states, dim_x, gh_degree, problems)
SETS = {"flagship": (8, 2, 4, 4), "split": (8, 1, 3, 1), "odd": (6, 1, 3, 4),
        "s6": (6, 3, 4, 1)}


def _jax_problems(key):
    from gaussianvi_tpu.examples.chain_estimation import (
        build_chain_estimation,
    )

    n, dim_x, degree, count = SETS[key]
    return [build_chain_estimation(num_states=n, dim_x=dim_x,
                                   gh_degree=degree, seed=seed)[:2]
            for seed in range(count)]


def _port_batch(descs):
    return stack_problems([graph_from_arrays(d, device=CPU) for d, _ in descs],
                          [state_from_arrays(s, device=CPU) for _, s in descs])


def _np(tree):
    return tuple(np.asarray(x) for x in tree)


def _run_result(state, hist, mesh):
    return dict(
        cost=hist.cost.numpy(), factor_costs=hist.factor_costs.numpy(),
        accepted_step=hist.accepted_step.numpy(),
        cov_diag=hist.cov_diag.numpy(), mu=state.mu.numpy(),
        prec_diag=state.precision.diag.numpy(),
        prec_off=state.precision.off.numpy(),
        position=(mesh.dp_index, mesh.fp_index),
        all_reduces=mesh.all_reduces)


def _rank_jobs(rank, world, device, descs, jobs):
    """Entry of one rank process: run every job on the mesh it names and
    return ``{job name: result}`` as numpy arrays (``None`` where the rank
    is outside the job's mesh, the exception's type and text where the job
    is expected to raise)."""
    batches = {key: _port_batch(d) for key, d in descs.items()}
    out = {}
    for name, kind, key, (dp, fp), fields, method in jobs:
        if kind == "patch":
            mesh = parallel.make_mesh(dp, fp)
            out[name] = (_patch_run(mesh, torch.device("cuda"), fields)
                         if mesh.member else None)
            continue
        graph_b, state_b = batches[key]
        cfg = GVIConfig(**fields)
        if kind == "raises":
            try:
                mesh = parallel.make_mesh(dp, fp)
                parallel.optimize_sharded(graph_b, state_b, cfg, mesh, method)
                out[name] = None
            except (ValueError, RuntimeError) as e:
                out[name] = (type(e).__name__, str(e))
            continue
        mesh = parallel.make_mesh(dp, fp)
        if not mesh.member:
            out[name] = None
        elif kind == "optimize":
            state, hist = parallel.optimize_sharded(graph_b, state_b, cfg,
                                                    mesh, method)
            out[name] = _run_result(state, hist, mesh)
        elif kind == "step":
            state, cost = parallel.sharded_ngd_step(
                graph_b, state_b, cfg, mesh, temperature=2.0, method=method)
            out[name] = dict(mu=state.mu.numpy(), cost=cost.numpy(),
                             position=(mesh.dp_index, mesh.fp_index))
        elif kind == "split":
            engine = FactorShardEngine(
                parallel.shard_graph(graph_b, mesh), cfg, device, mesh)
            got = engine.fused_gradient(
                parallel.shard_state(state_b, mesh),
                torch.ones(state_b.mu.shape[0] // dp, dtype=torch.float64))
            cd, co, ld, dprec, dmu, dfb = got
            out[name] = _np(x.numpy() for x in (
                cd, co, ld, dprec.diag, dprec.off, dmu, dfb))
        elif kind == "lockstep":
            # rank 1 is handed another anchor target than the others
            if rank == 1:
                anchor = graph_b.linear[0]
                graph_b = replace(graph_b, linear=(replace(
                    anchor, target_mu=anchor.target_mu + 0.5),
                    *graph_b.linear[1:]))
            try:
                parallel.optimize_sharded(graph_b, state_b, cfg, mesh, method)
                out[name] = None
            except RuntimeError as e:
                out[name] = (type(e).__name__, str(e))
    return out


PATCH_RESTARTS = 2


def _patch_run(mesh, device, fields):
    """The 3-D point planner in the patch mode (N = 8, windows of 4
    voxels, two restarts) on the routes the engines resolve for ``device``
    (for the card: K1, K2, K3 with the trials' windows and K6 with the
    current means' windows; here on CPU tensors, the kernels' plain
    versions), on ``mesh`` (None: the single-process engine)."""
    from gaussianvi_tpu_torch.examples.point3d_planning import (
        build_point3d_planning,
    )
    from gaussianvi_tpu_torch.inference.engine import LocalEngine
    from gaussianvi_tpu_torch.inference.optimize import run_gvi
    from gaussianvi_tpu_torch.parallel.restarts import _batch_graph
    from gaussianvi_tpu_torch.parallel.sharding import (
        _gather_factor_costs,
    )

    graph, init, cfg, _ = build_point3d_planning(num_states=8, patch_size=4,
                                                 device=CPU)
    cfg = replace(cfg, **fields)
    graph_b = _batch_graph(graph, PATCH_RESTARTS)
    noise = 0.3 * torch.as_tensor(np.random.default_rng(3).standard_normal(
        (PATCH_RESTARTS, *init.mu.shape)))
    noise[0] = 0.0
    prec = init.precision
    state_b = type(init)(init.mu + noise, type(prec)(
        prec.diag.expand(PATCH_RESTARTS, *prec.diag.shape).clone(),
        prec.off.expand(PATCH_RESTARTS, *prec.off.shape).clone()))
    if mesh is None:
        engine = LocalEngine(graph_b, cfg, device)
        state, hist = run_gvi(engine, state_b, cfg)
        return dict(cost=hist.cost.numpy(),
                    factor_costs=hist.factor_costs.numpy(),
                    accepted_step=hist.accepted_step.numpy(),
                    mu=state.mu.numpy(),
                    prec_diag=state.precision.diag.numpy(),
                    prec_off=state.precision.off.numpy())
    graph_loc = parallel.shard_graph(graph_b, mesh)
    engine = FactorShardEngine(graph_loc, cfg, device, mesh)
    assert engine.fused_gradient_ready and not engine.fused_trials_ready
    state, hist = run_gvi(engine, parallel.shard_state(state_b, mesh), cfg)
    return _run_result(state, _gather_factor_costs(hist, graph_loc, mesh),
                       mesh)


def _jobs():
    jobs = []
    for variant, (method, base, extra, _) in VARIANTS.items():
        for mesh in MESHES:
            jobs.append((f"{variant}-{mesh}", "optimize", "flagship", mesh,
                         {**base, **extra}, method))
    for name, fields in OPTIONS.items():
        jobs.append((f"option-{name}", "optimize", "flagship", (2, 2),
                     {**_BENCH, **fields}, "ngd"))
    fused = dict(fused_trials="on", fused_gradient="on")
    # bfloat16 offsets in K6 accum's and K5's plain versions
    jobs.append(("option-bf16-fused", "optimize", "flagship", (2, 2),
                 {**_BENCH, **OPTIONS["bf16"], **fused}, "ngd"))
    jobs += [
        ("step", "step", "flagship", (2, 2), dict(step_size_base=0.9), "ngd"),
        ("split-2", "split", "split", (1, 2), fused, "ngd"),
        ("split-4", "split", "split", (1, 4), fused, "ngd"),
        ("odd-K", "raises", "odd", (1, 4), _BENCH, "ngd"),
        ("odd-B", "raises", "split", (2, 2), _BENCH, "ngd"),
        ("big-mesh", "raises", "flagship", (4, 2), _BENCH, "ngd"),
        ("lockstep", "lockstep", "flagship", (1, 4),
         dict(_BENCH, fused_trials="on", fused_gradient="on"), "ngd"),
        ("patch-fp2", "patch", None, (1, 2), dict(niters=5, niters_lowtemp=3),
         "ngd"),
    ]
    return jobs


@pytest.fixture(scope="module")
def jax_sets():
    return {key: _jax_problems(key) for key in SETS}


@pytest.fixture(scope="module")
def descs(jax_sets):
    from test_torch_slice import describe

    return {key: [describe(g, s) for g, s in ps]
            for key, ps in jax_sets.items()}


@pytest.fixture(scope="module")
def ranks(descs, tmp_path_factory):
    """The results of every sharded job, per rank: one spawn of four gloo
    ranks on the CPU, one thread each, 240 s for the lot."""
    return spawn_ranks(_rank_jobs, WORLD, (descs, _jobs()), backend="gloo",
                       device="cpu", timeout_s=240.0,
                       rendezvous_dir=str(tmp_path_factory.mktemp("ranks")))


def _assemble(ranks, name, dp, fp):
    """The global result of an optimize job: every fp rank of a row holds
    the same bits; the rows concatenate in dp order."""
    rows = []
    for i_dp in range(dp):
        row = [ranks[i_dp * fp + j][name] for j in range(fp)]
        assert [r["position"] for r in row] == [(i_dp, j) for j in range(fp)]
        for other in row[1:]:
            for k in ("cost", "factor_costs", "accepted_step", "mu",
                      "prec_diag", "prec_off"):
                np.testing.assert_array_equal(other[k], row[0][k])
        rows.append(row[0])
    for r in ranks[dp * fp:]:
        assert r[name] is None
    return {k: np.concatenate([r[k] for r in rows]) for k in rows[0]
            if k not in ("position", "all_reduces")}, rows[0]["all_reduces"]


def _assert_same_run(got, want, tag):
    """cost / factor costs rtol 1e-9, final state atol 1e-9, identical
    accepted steps: the only difference allowed is the reassociation of
    the sums over fp."""
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-9,
                               err_msg=tag)
    np.testing.assert_array_equal(got["accepted_step"],
                                  want["accepted_step"], err_msg=tag)
    np.testing.assert_allclose(got["factor_costs"], want["factor_costs"],
                               rtol=1e-9, err_msg=tag)
    for k in ("mu", "prec_diag", "prec_off"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-9, err_msg=tag)


@pytest.fixture(scope="module")
def port_runs(descs):
    """The port's single-process ``optimize`` per variant."""
    graph_b, state_b = _port_batch(descs["flagship"])
    runs = {}
    for variant, (method, base, extra, _) in VARIANTS.items():
        state, hist = optimize(graph_b, state_b,
                               GVIConfig(**base, **extra), method)
        runs[variant] = dict(
            cost=hist.cost.numpy(), factor_costs=hist.factor_costs.numpy(),
            accepted_step=hist.accepted_step.numpy(), mu=state.mu.numpy(),
            prec_diag=state.precision.diag.numpy(),
            prec_off=state.precision.off.numpy())
    return runs


@pytest.fixture(scope="module")
def jax_runs(jax_sets):
    """JAX ``optimize_sharded`` on the CPU mesh, computed on demand per
    (variant, mesh)."""
    from gaussianvi_tpu.inference import GVIConfig as JaxConfig
    from gaussianvi_tpu.parallel import sharding as js

    ps = jax_sets["flagship"]
    graph_b, state_b = js.stack_problems([p[0] for p in ps],
                                         [p[1] for p in ps])
    cache = {}

    def run(variant, mesh):
        if (variant, mesh) not in cache:
            method, base, _, jextra = VARIANTS[variant]
            state, hist = js.optimize_sharded(
                graph_b, state_b, JaxConfig(**base, **jextra),
                js.make_mesh(*mesh), method=method,
                # Pallas interpret mode does not trace under shard_map's
                # varying-axes typing (as in the JAX package's own tests)
                check_vma="chain_impl" not in jextra)
            cache[variant, mesh] = dict(
                cost=np.asarray(hist.cost),
                factor_costs=np.asarray(hist.factor_costs),
                accepted_step=np.asarray(hist.accepted_step),
                mu=np.asarray(state.mu),
                prec_diag=np.asarray(state.precision.diag),
                prec_off=np.asarray(state.precision.off))
        return cache[variant, mesh]

    return run


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_optimize_sharded_matches_jax_and_local(ranks, port_runs, jax_runs,
                                                variant, mesh):
    """Four gloo ranks on each mesh against the port's ``optimize`` and
    against JAX ``optimize_sharded``: on the same mesh for the separate
    NGD path at (2, 2) and (1, 4), on the (2, 2) mesh otherwise (the JAX
    meshes differ from one another by the reassociation of one sum only,
    and each compile of them takes 10-35 s here)."""
    dp, fp = mesh
    got, all_reduces = _assemble(ranks, f"{variant}-{mesh}", dp, fp)
    _assert_same_run(got, port_runs[variant], "vs the port's optimize")
    jmesh = mesh if variant == "ngd-separate" and mesh != (4, 1) else (2, 2)
    _assert_same_run(got, jax_runs(variant, jmesh),
                     f"vs JAX optimize_sharded on {jmesh}")
    # problems differ, so the per-problem decisions differ too
    assert len({tuple(r) for r in got["cost"].round(6).tolist()}) == 4
    # collectives per run, fp >= 2: NGD sums the cost at the top of the
    # iteration, the gradient accumulators (one buffer) and the trial
    # costs; then one gather of the factor costs is not a sum, and three
    # lockstep checks are
    if fp == 1:
        assert all_reduces == 0
    else:
        assert all_reduces == 3 * _BENCH["niters"] + 3


def test_patch_mode_at_fp2_matches_one_process(ranks):
    """The point planner's patch mode at dp = 1 x fp = 2 on the card's
    routes (each rank forms its own shard's windows: K3 for the trials,
    K6 ``accum`` then ``solve``) against the single-process run on the
    same routes (K6 ``full``): 1e-9 and the same steps."""
    job = next(j for j in _jobs() if j[0] == "patch-fp2")
    got, all_reduces = _assemble(ranks, "patch-fp2", 1, 2)
    want = _patch_run(None, torch.device("cuda"), job[4])
    _assert_same_run(got, want, "patch mode at fp = 2 vs one process")
    assert (got["accepted_step"] > 0).any()
    # per iteration the cost, the accumulators and the trial costs (run_gvi
    # on the engine: no lockstep checks of optimize_sharded)
    assert all_reduces == 3 * job[4]["niters"]


@pytest.mark.parametrize("name", sorted(OPTIONS) + ["bf16-fused"])
def test_optimize_sharded_options_match_jax_and_local(ranks, jax_sets, descs,
                                                      name):
    """``moments_eval_dtype="bfloat16"``, ``linesearch="seq"`` and
    ``ema_alpha=0.5`` on the (2, 2) mesh against the port's ``optimize``
    with the same option and against JAX ``optimize_sharded`` with it on
    the (2, 2) CPU mesh (its separate path: bf16 on the fused plain
    versions is held to the port's own fused run)."""
    from gaussianvi_tpu.inference import GVIConfig as JaxConfig
    from gaussianvi_tpu.parallel import sharding as js

    option = OPTIONS[name.split("-")[0]]
    fused = (dict(fused_trials="on", fused_gradient="on")
             if name.endswith("fused") else {})
    got, _ = _assemble(ranks, f"option-{name}", 2, 2)
    graph_b, state_b = _port_batch(descs["flagship"])
    state, hist = optimize(graph_b, state_b,
                           GVIConfig(**_BENCH, **option, **fused))
    _assert_same_run(got, _run_result(state, hist, parallel.make_mesh(1, 1)),
                     "vs the port's optimize")
    if fused:
        return
    ps = jax_sets["flagship"]
    jg, jst = js.stack_problems([p[0] for p in ps], [p[1] for p in ps])
    jstate, jhist = js.optimize_sharded(jg, jst, JaxConfig(**_BENCH, **option),
                                        js.make_mesh(2, 2))
    _assert_same_run(got, dict(
        cost=np.asarray(jhist.cost),
        factor_costs=np.asarray(jhist.factor_costs),
        accepted_step=np.asarray(jhist.accepted_step),
        mu=np.asarray(jstate.mu), prec_diag=np.asarray(jstate.precision.diag),
        prec_off=np.asarray(jstate.precision.off)),
        "vs JAX optimize_sharded on (2, 2)")


def test_factor_costs_come_back_in_global_order(ranks, port_runs):
    """The nonlinear batch's K axis is sharded over fp and reassembled: on
    the (1, 4) mesh every rank returns all 8 range costs, then the linear
    ones, in the single-process order, and they differ factor to factor."""
    got, _ = _assemble(ranks, "ngd-separate-(1, 4)", 1, 4)
    want = port_runs["ngd-separate"]["factor_costs"]
    assert got["factor_costs"].shape == want.shape == (4, 5, 8 + 1 + 7)
    np.testing.assert_allclose(got["factor_costs"], want, rtol=1e-9)
    assert len(set(want[0, 0, :8].round(9).tolist())) == 8


def test_sharded_ngd_step_matches_jax(ranks, jax_sets):
    """One step at a fixed temperature on the (2, 2) mesh."""
    from gaussianvi_tpu.inference import GVIConfig as JaxConfig
    from gaussianvi_tpu.parallel import sharding as js

    ps = jax_sets["flagship"]
    graph_b, state_b = js.stack_problems([p[0] for p in ps],
                                         [p[1] for p in ps])
    jstate, jcost = js.sharded_ngd_step(
        graph_b, state_b, JaxConfig(step_size_base=0.9), js.make_mesh(2, 2),
        temperature=2.0)
    rows = [ranks[r]["step"] for r in (0, 2)]
    np.testing.assert_array_equal(ranks[1]["step"]["mu"], rows[0]["mu"])
    np.testing.assert_allclose(np.concatenate([r["cost"] for r in rows]),
                               np.asarray(jcost), rtol=1e-9)
    np.testing.assert_allclose(np.concatenate([r["mu"] for r in rows]),
                               np.asarray(jstate.mu), atol=1e-9)


@pytest.mark.parametrize("fp", [2, 4])
def test_split_pair_on_ranks_matches_jax_fused_gradient(ranks, jax_sets, fp):
    """``FactorShardEngine.fused_gradient`` on fp ranks (accum on the
    shard, one all-reduce, solve) against the JAX package's single fused
    gradient kernel on the same problem (the setup of its
    ``test_fp_sharded_split_gradient_bitmatch``: N=8, dim_x=1, degree 3),
    f64, rtol 1e-9."""
    import jax.numpy as jnp

    from gaussianvi_tpu.inference import GVIConfig as JaxConfig
    from gaussianvi_tpu.inference.engine import LocalEngine as JaxEngine

    (graph, state), = jax_sets["split"]
    eng = JaxEngine(graph, JaxConfig(chain_impl="lanes", quad_impl="lanes"))
    cd, co, ld, dprec, dmu, dfb = eng.fused_gradient(state, jnp.asarray(1.0))
    want = _np((cd, co, ld, dprec.diag, dprec.off, dmu, dfb))
    for rank in range(fp):
        got = ranks[rank][f"split-{fp}"]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.isnan(g[0]), np.isnan(w))
            np.testing.assert_allclose(np.nan_to_num(g[0]), np.nan_to_num(w),
                                       rtol=1e-9, atol=1e-12)
        for g, g0 in zip(got, ranks[0][f"split-{fp}"]):
            np.testing.assert_array_equal(g, g0)
    assert all(r[f"split-{fp}"] is None for r in ranks[fp:])


@pytest.mark.parametrize("job,kind,match", [
    ("odd-K", "ValueError", "nonlinear factors: 6 does not divide over 4"),
    ("odd-B", "ValueError", "problems: 1 does not divide over 2"),
    ("big-mesh", "ValueError", "mesh 4x2 needs 8 ranks, have 4"),
    ("lockstep", "RuntimeError", "did not run in lockstep"),
])
def test_sharded_errors_raise_on_every_rank(ranks, job, kind, match):
    """K not divisible by fp, B not divisible by dp and a mesh larger than
    the world raise ``ValueError`` (as JAX ``make_mesh`` / ``shard_map``
    do); ranks that were handed different data finish the run (the
    collectives do not depend on the data, so nothing hangs) and then all
    raise together."""
    for r in ranks:
        assert r[job] is not None, "the job did not raise"
        assert r[job][0] == kind and match in r[job][1], r[job]


def _failing_rank(rank, world, device):
    if rank == 1:
        raise ValueError("rank 1 gives up")
    x = torch.ones(2)
    torch.distributed.all_reduce(x)         # never completed by rank 1
    return float(x[0])


def test_a_failed_rank_fails_the_run(tmp_path):
    """A rank that raises is reported with its traceback, and the rank left
    waiting in a collective is stopped: ``spawn_ranks`` raises instead of
    hanging."""
    with pytest.raises(RuntimeError, match="rank 1 gives up"):
        spawn_ranks(_failing_rank, 2, device="cpu", timeout_s=60.0,
                    rendezvous_dir=str(tmp_path))


# ---------------------------------------------------------------------------
# the split pair's plain versions, in this process
# ---------------------------------------------------------------------------

def _shard_ops(nl_specs, nl_arrays, i, fp):
    """Shard i of fp of the port's nonlinear fused operands."""
    specs, arrays = [], []
    for sp, (start, nodes, weights, params) in zip(nl_specs, nl_arrays):
        k = sp.k // fp
        sl = slice(i * k, (i + 1) * k)
        specs.append(sp._replace(k=k, slice_offset=None))
        arrays.append((start[sl], nodes, weights, params[:, sl]))
    return tuple(specs), tuple(arrays)


def _iterate(state, n, s, rng):
    """A perturbed iterate with per-problem temperatures; problem 0 stays
    at the initial iterate."""
    b = state.mu.shape[0]
    mu = state.mu.numpy().copy()
    mu[1:] += 0.05 * rng.standard_normal(mu[1:].shape)
    q = rng.standard_normal((b, n, s, s))
    pd = state.precision.diag.numpy() + 0.2 * q @ np.swapaxes(q, -1, -2)
    pd[0] = state.precision.diag[0].numpy()
    po = 0.3 * rng.standard_normal((b, n - 1, s, s))
    po[0] = 0.0
    return mu, pd, po, np.linspace(1.0, 10.0, b)


@pytest.mark.parametrize("key", ["flagship", "split"])
@pytest.mark.parametrize("fp", [2, 4])
def test_split_pair_plain_matches_full_plain(descs, key, fp):
    """accum on each of fp shards, summed, then solve, against the port's
    ``full`` plain version on the same inputs: equal up to the
    reassociation of the sum (rtol 1e-12 of each output's range)."""
    graph, state = _port_batch(descs[key])
    n, s = state.mu.shape[1:]
    nl_specs, lin_specs, nl_arrays, lin_arrays = fused_operands(graph)
    x = tuple(map(torch.as_tensor, _iterate(state, n, s,
                                            np.random.default_rng(fp))))
    want = tfg.gradient_plain(*x, nl_specs, lin_specs, nl_arrays, lin_arrays)
    total = None
    for i in range(fp):
        specs, arrays = _shard_ops(nl_specs, nl_arrays, i, fp)
        part = tfg.gradient_lanes(*x, specs, (), arrays, (), mode="accum")
        assert isinstance(part, tfg.Partials) and len(part) == 3
        if total is None:
            total = part
        else:
            total.buffer.add_(part.buffer)
    before = [t.clone() for t in total]
    got = tfg.gradient_lanes(*x, (), lin_specs, (), lin_arrays, mode="solve",
                             seeds=total)
    for t, t0 in zip(total, before):        # the seeds are left untouched
        assert torch.equal(t, t0)
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        fin = torch.isfinite(w)
        if fin.any():       # the flagship's Vddmu is indefinite here
            torch.testing.assert_close(
                g[fin], w[fin], rtol=0,
                atol=1e-12 * float(w[fin].abs().max()))
    assert bool(torch.isfinite(got[6]).all())
    assert key == "flagship" or bool(torch.isfinite(got[5]).any())


def test_split_modes_plain_match_jax_kernels(jax_sets, descs, key="flagship"):
    """The plain versions of ``accum`` (on each half of the factors) and
    ``solve`` (on their sum) against the JAX kernel in interpret mode in
    the same mode on the same shard operands (four flagship problems, s=4,
    the marginal-rule lift on), rtol 1e-9."""
    _split_modes_vs_jax(jax_sets, descs, key)


def test_split_modes_plain_match_jax_kernels_s6(jax_sets, descs):
    """The same at s = 6 (chain estimation at dim_x = 3, one problem, the
    3-D marginal rule on the range cost): the shapes of the pair's new
    CUDA instances."""
    _split_modes_vs_jax(jax_sets, descs, "s6")


def _split_modes_vs_jax(jax_sets, descs, key):
    import jax.numpy as jnp

    from gaussianvi_tpu.inference import GVIConfig as JaxConfig
    from gaussianvi_tpu.kernels import fused_gradient as jfg
    from test_torch_fused import _jax_operands

    problems = jax_sets[key]
    jnl_specs, jlin_specs, jnl, jlin = _jax_operands(
        problems, JaxConfig(chain_impl="lanes"))
    graph, state = _port_batch(descs[key])
    n, s = state.mu.shape[1:]
    nl_specs, lin_specs, nl_arrays, lin_arrays = fused_operands(graph)
    x = _iterate(state, n, s, np.random.default_rng(7))
    tx, jx = tuple(map(torch.as_tensor, x)), tuple(map(jnp.asarray, x))

    def close(got, want):
        got, want = got.numpy(), np.asarray(want)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want),
                                   rtol=1e-9, atol=1e-10)

    fp, jsum, tsum = 2, None, None
    for i in range(fp):
        jspecs, jarrays = [], []
        for sp, (_, nodes, w, leaves) in zip(jnl_specs, jnl):
            k = sp.k // fp
            starts = jnp.arange(i * k, (i + 1) * k) + (sp.slice_offset or 0)
            jspecs.append(sp._replace(k=k, slice_offset=None))
            jarrays.append((starts, nodes, w, tuple(
                leaf[:, i * k:(i + 1) * k] for leaf in leaves)))
        jpart = jfg.gradient_lanes(*jx, tuple(jspecs), (), tuple(jarrays),
                                   (), interpret=True, mode="accum")
        specs, arrays = _shard_ops(nl_specs, nl_arrays, i, fp)
        tpart = tfg.gradient_plain(*tx, specs, (), arrays, (), mode="accum")
        for g, w in zip(tpart, jpart):
            close(g, w)
        jsum = jpart if jsum is None else tuple(
            a + b for a, b in zip(jsum, jpart))
        tsum = tpart if tsum is None else tuple(
            a + b for a, b in zip(tsum, tpart))
    assert float(tsum[1].abs().max()) > 0
    want = jfg.gradient_lanes(*jx, (), jlin_specs, (), jlin, interpret=True,
                              mode="solve", seeds=jsum)
    got = tfg.gradient_plain(*tx, (), lin_specs, (), lin_arrays,
                             mode="solve", seeds=tsum)
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("kwargs,match", [
    (dict(mode="both"), "unknown mode"),
    (dict(mode="solve"), "seeds go with mode 'solve'"),
    (dict(mode="accum", seeds=()), "seeds go with mode 'solve'"),
])
def test_gradient_mode_errors(descs, kwargs, match):
    graph, state = _port_batch(descs["split"])
    x = (state.mu, state.precision.diag, state.precision.off,
         torch.ones(1, dtype=torch.float64))
    with pytest.raises(ValueError, match=match):
        tfg.gradient_lanes(*x, (), (), (), (), **kwargs)


def test_accum_and_solve_refuse_the_other_factor_kind(descs):
    graph, state = _port_batch(descs["split"])
    nl_specs, lin_specs, nl_arrays, lin_arrays = fused_operands(graph)
    x = (state.mu, state.precision.diag, state.precision.off,
         torch.ones(1, dtype=torch.float64))
    with pytest.raises(ValueError, match="nonlinear factors only"):
        tfg.gradient_lanes(*x, nl_specs, lin_specs, nl_arrays, lin_arrays,
                           mode="accum")
    seeds = tfg.gradient_lanes(*x, nl_specs, (), nl_arrays, (), mode="accum")
    with pytest.raises(ValueError, match="linear factors only"):
        tfg.gradient_lanes(*x, nl_specs, lin_specs, nl_arrays, lin_arrays,
                           mode="solve", seeds=seeds)
    with pytest.raises(ValueError, match="seeds must be"):
        tfg.gradient_lanes(*x, (), lin_specs, (), lin_arrays, mode="solve",
                           seeds=seeds[:2])


# ---------------------------------------------------------------------------
# single process: the 1 x 1 mesh, impl resolution
# ---------------------------------------------------------------------------

def test_one_by_one_mesh_is_the_local_run_to_the_bit(descs):
    """Without a process group the 1 x 1 mesh runs the single-device loop
    unchanged."""
    graph_b, state_b = _port_batch(descs["flagship"])
    mesh = parallel.make_mesh(1, 1)
    assert (mesh.dp, mesh.fp) == (1, 1) and mesh.member
    cfg = GVIConfig(**_BENCH)
    state, hist = parallel.optimize_sharded(graph_b, state_b, cfg, mesh)
    ref_state, ref = optimize(graph_b, state_b, cfg)
    for a, b in zip(hist, ref):
        assert torch.equal(a, b)
    assert torch.equal(state.mu, ref_state.mu)
    assert mesh.all_reduces == 0
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        parallel.make_mesh(1, 2)
    with pytest.raises(ValueError, match="problem-batched"):
        parallel.optimize_sharded(
            graph_from_arrays(descs["split"][0][0], device=CPU),
            state_from_arrays(descs["split"][0][1], device=CPU), cfg, mesh)


def test_a_graph_without_the_problem_axis_raises(descs):
    """A batched state with one problem's graph (restarts sharing it) would
    shard the wrong axis of the factors' data: ``optimize_sharded`` refuses
    it, and takes the graph the restarts module batches for it."""
    from gaussianvi_tpu_torch.parallel.restarts import _batch_graph

    graph_b, state_b = _port_batch(descs["flagship"])
    one = graph_from_arrays(descs["flagship"][0][0], device=CPU)
    mesh, cfg = parallel.make_mesh(1, 1), GVIConfig(niters=1)
    with pytest.raises(ValueError, match="problem-batched graph"):
        parallel.optimize_sharded(one, state_b, cfg, mesh)
    _, hist = parallel.optimize_sharded(_batch_graph(one, 4), state_b, cfg,
                                        mesh)
    _, ref = optimize(one, state_b, cfg)
    assert torch.equal(hist.cost, ref.cost)


def test_auto_impls_go_by_the_device(descs):
    """``"auto"`` on CPU tensors is the plain chain and quadrature (the JAX
    package resolves it by the mesh's platform), the fused kernels stay off
    unless asked for, and the CUDA kernels asked for on the CPU raise."""
    graph_b, state_b = _port_batch(descs["flagship"])
    mesh, cpu = parallel.make_mesh(1, 1), torch.device("cpu")
    eng = FactorShardEngine(graph_b, GVIConfig(use_pallas=True), cpu, mesh)
    assert eng.chain_impl != "lanes" and not any(eng.quad_batches)
    assert not eng.fused_trials_ready and not eng.fused_gradient_ready
    assert not eng.use_pallas
    with pytest.raises(ValueError, match="CUDA"):
        parallel.optimize_sharded(graph_b, state_b,
                                  GVIConfig(niters=1, chain_impl="lanes"),
                                  mesh)


def test_nccl_without_a_gpu_raises():
    from gaussianvi_tpu_torch.parallel.multiprocess import (
        initialize_multiprocess,
    )

    with pytest.raises(ValueError, match="needs a CUDA device per rank"):
        initialize_multiprocess("tcp://localhost:1", 1, 0, backend="nccl",
                                device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        initialize_multiprocess("tcp://localhost:1", 1, 0, backend="mpi",
                                device="cpu")


# ---------------------------------------------------------------------------
# joint_cost and restarts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_joint_costs(jax_sets):
    """JAX ``joint_cost`` of the four flagship problems at T = 3, tempered
    and not (one compile for both)."""
    import jax

    from gaussianvi_tpu.inference.gvi import joint_cost as jax_joint_cost
    from gaussianvi_tpu.parallel.sharding import stack_problems as jstack

    ps = jax_sets["flagship"]
    jgraph, jstate = jstack([p[0] for p in ps], [p[1] for p in ps])
    tempered, raw = jax.jit(jax.vmap(lambda g, s: tuple(
        jax_joint_cost(g, s.mu, s.precision, 3.0, temper_costs=t)
        for t in (True, False))))(jgraph, jstate)
    return {True: np.asarray(tempered), False: np.asarray(raw)}


@pytest.mark.parametrize("temper", [True, False])
def test_joint_cost_matches_jax(jax_joint_costs, descs, temper):
    from gaussianvi_tpu_torch.inference.gvi import joint_cost

    graph_b, state_b = _port_batch(descs["flagship"])
    got = joint_cost(graph_b, state_b.mu, state_b.precision, 3.0,
                     temper_costs=temper)
    assert got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), jax_joint_costs[temper],
                               rtol=1e-9)
    assert not np.allclose(jax_joint_costs[True], jax_joint_costs[False])


def test_best_of_restarts_matches_jax_on_the_same_inits(jax_sets, descs,
                                                        method="ngd",
                                                        base=0.9):
    """The same six initial states (numpy noise, restart 0 nominal) through
    the JAX package's restart body (``vmap`` of ``optimize`` +
    ``joint_cost``, then ``argmin``) and the port's
    ``best_of_restarts``."""
    import jax
    import jax.numpy as jnp

    from gaussianvi_tpu.inference import GVIConfig as JaxConfig
    from gaussianvi_tpu.inference.graph import GaussianState as JState
    from gaussianvi_tpu.inference.gvi import joint_cost as jax_joint_cost
    from gaussianvi_tpu.inference.optimize import optimize as jax_optimize

    r = 6
    jgraph, jinit = jax_sets["flagship"][1]
    noise = 0.3 * np.random.default_rng(5).standard_normal(
        (r, *jinit.mu.shape))
    noise[0] = 0.0
    fields = dict(niters=4, niters_lowtemp=4, step_size_base=base)
    jcfg = JaxConfig(**fields)

    def one(mu):
        final, _ = jax_optimize(jgraph, JState(mu, jinit.precision), jcfg,
                                method)
        return final, jax_joint_cost(jgraph, final.mu, final.precision,
                                     jcfg.temperature,
                                     temper_costs=method == "ngd")

    jfinals, jcosts = jax.jit(jax.vmap(one))(jnp.asarray(jinit.mu + noise))
    jbest = int(jnp.argmin(jcosts))

    d, st = descs["flagship"][1]
    graph, init = graph_from_arrays(d, device=CPU), state_from_arrays(st, device=CPU)
    from gaussianvi_tpu_torch.inference.graph import GaussianState
    from gaussianvi_tpu_torch.ops.blocktridiag import BlockTridiag

    inits = GaussianState(init.mu + torch.as_tensor(noise), BlockTridiag(
        init.precision.diag.expand(r, -1, -1, -1).clone(),
        init.precision.off.expand(r, -1, -1, -1).clone()))
    best_state, best_cost, costs = parallel.best_of_restarts(
        graph, inits, GVIConfig(**fields), method)
    np.testing.assert_allclose(costs.numpy(), np.asarray(jcosts), rtol=1e-9)
    assert int(torch.argmin(costs)) == jbest
    assert len(set(np.asarray(jcosts).round(6).tolist())) > 1
    np.testing.assert_allclose(float(best_cost), float(jcosts[jbest]),
                               rtol=1e-9)
    np.testing.assert_allclose(best_state.mu.numpy(),
                               np.asarray(jfinals.mu[jbest]), atol=1e-9)
    np.testing.assert_allclose(best_state.precision.diag.numpy(),
                               np.asarray(jfinals.precision.diag[jbest]),
                               atol=1e-9)


def test_perturb_inits_and_optimize_restarts(descs):
    """Restart 0 keeps the nominal mean, the precision is shared, the noise
    follows the generator, and ``optimize_restarts`` is ``best_of_restarts``
    of those initial states."""
    d, st = descs["flagship"][0]
    graph, init = graph_from_arrays(d, device=CPU), state_from_arrays(st, device=CPU)

    def gen():
        return torch.Generator().manual_seed(3)

    inits = parallel.perturb_inits(init, gen(), 5, mean_scale=0.2)
    assert inits.mu.shape == (5, *init.mu.shape)
    assert torch.equal(inits.mu[0], init.mu)
    assert not torch.equal(inits.mu[1], init.mu)
    assert torch.equal(inits.precision.diag[3], init.precision.diag)
    again = parallel.perturb_inits(init, gen(), 5, mean_scale=0.2)
    assert torch.equal(inits.mu, again.mu)
    noise = (inits.mu[1:] - init.mu) / 0.2
    assert 0.5 < float(noise.std()) < 1.5
    cfg = GVIConfig(niters=3, niters_lowtemp=3, step_size_base=0.9)
    best, cost, costs = parallel.optimize_restarts(
        graph, init, gen(), num_restarts=5, config=cfg, mean_scale=0.2)
    best2, cost2, costs2 = parallel.best_of_restarts(graph, inits, cfg)
    assert torch.equal(costs, costs2) and torch.equal(best.mu, best2.mu)
    assert costs.shape == (5,) and float(cost) == float(costs.min())
