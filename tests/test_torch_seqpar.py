"""PyTorch port, the sequence-parallel path: ``parallel.chain_seqpar``
against the JAX package's on its 8-virtual-device CPU mesh,
``to_chain_layout``, ``optimize_time_sharded`` (NGD and prox) and
``sharded_time_ngd_step`` on gloo ranks against JAX
``optimize_time_sharded`` and against the port's ``optimize``, and
``parallel.comm_model``'s predicted collectives against the ones each
:class:`~gaussianvi_tpu_torch.parallel.collective.Mesh` recorded, on the
sequence-parallel and the factor-parallel path (CPU, f64).

Every multi-rank run of this file happens in ONE group of four rank
processes (``ranks`` fixture); the tests read its results.  The rank
processes import this module to find :func:`_rank_jobs`, so JAX (and the
test modules that import it) is imported inside the functions that use it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gaussianvi_tpu_torch import GVIConfig, optimize, parallel  # noqa: E402
from gaussianvi_tpu_torch.convert import (  # noqa: E402
    graph_from_arrays,
    state_from_arrays,
)
from gaussianvi_tpu_torch.ops.blocktridiag import (  # noqa: E402
    BlockTridiag,
    gbp_covariance_logdet,
    solve,
)
from gaussianvi_tpu_torch.parallel import comm_model  # noqa: E402
from gaussianvi_tpu_torch.parallel.multiprocess import spawn_ranks  # noqa: E402

CPU = torch.device("cpu")
WORLD = 4
N = 16
# crosses the scheduled high-temperature switch at iteration 2 (the JAX
# package's own time-sharded test)
NGD = dict(niters=5, niters_lowtemp=2, temperature=0.5, high_temperature=4.0,
           step_size_base=0.9)
PROX = dict(niters=3, step_size_base=0.3)
METHODS = {"ngd": NGD, "prox": PROX}
# (sp, N, s) of the chain cases; the last one carries a leading axis of 3
CHAINS = [(2, 16, 2), (4, 8, 4), (4, 32, 3), (2, 6, 6), (4, 12, 2)]
# the JAX mesh each port run is held to (each compile of JAX's loop at
# dim_x = 2 takes about 20 s here; the JAX meshes differ from one another
# by the reassociation of the sums over sp only)
JAX_SP = {1: (4,), 2: (2,)}


def random_chain(n, s, seed, lead=()):
    """An SPD chain ``A = D + off`` with a dominant diagonal and a rhs."""
    rng = np.random.default_rng(seed)
    a = 0.3 * rng.standard_normal((*lead, n, s, s))
    diag = a @ np.swapaxes(a, -1, -2) + 3.0 * np.eye(s)
    off = 0.2 * rng.standard_normal((*lead, n - 1, s, s))
    return diag, off, rng.standard_normal((*lead, n, s))


def _chain(case):
    p, n, s = case
    lead = (3,) if case == CHAINS[-1] else ()
    return random_chain(n, s, 10 * n + s, lead)


def _segment(x, mesh, n, axis):
    nl = n // mesh.size
    return x.narrow(axis, mesh.index * nl, nl)


def _problem(desc):
    graph = graph_from_arrays(desc[0], device=CPU)
    return graph, state_from_arrays(desc[1], device=CPU)


def _result(state, hist, mesh=None):
    out = dict(cost=hist.cost.numpy(), accepted_step=hist.accepted_step.numpy(),
               factor_costs=hist.factor_costs.numpy(),
               hist_mu=hist.mu.numpy(), mu=state.mu.numpy(),
               prec_diag=state.precision.diag.numpy(),
               prec_off=state.precision.off.numpy())
    if mesh is not None:
        out["inventory"] = dict(mesh.inventory)
    return out


def _rank_jobs(rank, world, device, chains, descs, flagship):
    """Entry of one rank process: every job on the mesh it names, results
    as numpy arrays (``None`` where the rank is outside the job's mesh, the
    exception's type and text where the job is expected to raise)."""
    from gaussianvi_tpu_torch.batching import stack_problems
    from gaussianvi_tpu_torch.parallel import chain_seqpar as cs

    out = {}
    # ---- the chain: covariance, log det and solve per segment ----
    for case, (diag, off, rhs) in chains.items():
        p, n, _ = case
        mesh = parallel.make_mesh(1, 1, sp=p)
        if not mesh.member:
            out[case] = None
            continue
        d, o, b = (torch.as_tensor(x) for x in (diag, off, rhs))
        d, o, b = (_segment(d, mesh, n, -3),
                   _segment(cs.pad_off_for_seqpar(o), mesh, n, -3),
                   _segment(b, mesh, n, -2))
        cd, co, ld = cs.gbp_covariance_logdet_seqpar(d, o, mesh)
        out[case] = dict(
            cov_diag=cd.numpy(), cov_off=co.numpy(), logdet=ld.numpy(),
            x=cs.solve_seqpar(d, o, b, mesh).numpy(),
            fwd=cs.forward_pivots_local(d, o, mesh).numpy(),
            bwd=cs.backward_pivots_local(d, o, mesh).numpy())
    # ---- the loop, time-sharded ----
    for dim_x, desc in descs.items():
        graph, state = _problem(desc)
        chain_graph = parallel.to_chain_layout(graph)
        for method, fields in METHODS.items():
            for p in (2, 4):
                mesh = parallel.make_mesh(1, 1, sp=p)
                key = (method, dim_x, p)
                if not mesh.member:
                    out[key] = None
                    continue
                out[key] = _result(*parallel.optimize_time_sharded(
                    chain_graph, state, GVIConfig(**fields), mesh, method),
                    mesh)
    graph, state = _problem(descs[1])
    chain_graph = parallel.to_chain_layout(graph)
    mesh = parallel.make_mesh(1, 1, sp=4)
    new, cost = parallel.sharded_time_ngd_step(
        chain_graph, state, GVIConfig(step_size_base=0.9), mesh,
        temperature=2.0)
    out["step"] = dict(mu=new.mu.numpy(), cost=cost.numpy())
    mesh = parallel.make_mesh(1, 1, sp=2)
    if mesh.member:
        out["seq"] = _result(*parallel.optimize_time_sharded(
            chain_graph, state, GVIConfig(**NGD, linesearch="seq"), mesh))
    mesh = parallel.make_mesh(1, 1, sp=3)
    try:
        parallel.optimize_time_sharded(chain_graph, state,
                                       GVIConfig(niters=1), mesh)
        out["odd-N"] = None
    except ValueError as e:
        out["odd-N"] = (type(e).__name__, str(e))
    one_b, one_s = stack_problems([graph], [state])
    try:
        parallel.optimize_sharded(one_b, one_s, GVIConfig(niters=1),
                                  parallel.make_mesh(1, 1, sp=2))
        out["sp-to-fp"] = None
    except ValueError as e:
        out["sp-to-fp"] = str(e)
    # ---- the factor-parallel path's collectives (2 x 2 mesh, B = 4) ----
    graph_b, state_b = stack_problems(*map(list, zip(*(
        _problem(d) for d in flagship))))
    for name, extra in (("fp-separate", {}),
                        ("fp-fused", dict(fused_trials="on",
                                          fused_gradient="on"))):
        mesh = parallel.make_mesh(2, 2)
        parallel.optimize_sharded(graph_b, state_b,
                                  GVIConfig(**NGD, **extra), mesh)
        out[name] = dict(mesh.inventory)
    return out


@pytest.fixture(scope="module")
def chains():
    return {case: _chain(case) for case in CHAINS}


@pytest.fixture(scope="module")
def jax_problems():
    from gaussianvi_tpu.examples.chain_estimation import (
        build_chain_estimation,
    )

    return {dim_x: build_chain_estimation(num_states=N, dim_x=dim_x,
                                          gh_degree=4, seed=0)[:2]
            for dim_x in (1, 2)}


@pytest.fixture(scope="module")
def descs(jax_problems):
    from test_torch_slice import describe

    return {dim_x: describe(*p) for dim_x, p in jax_problems.items()}


@pytest.fixture(scope="module")
def flagship():
    from gaussianvi_tpu.examples.chain_estimation import (
        build_chain_estimation,
    )
    from test_torch_slice import describe

    return [describe(*build_chain_estimation(num_states=8, dim_x=2,
                                             gh_degree=4, seed=seed)[:2])
            for seed in range(4)]


@pytest.fixture(scope="module")
def ranks(chains, descs, flagship, tmp_path_factory):
    """The results of every multi-rank job, per rank: one spawn of four
    gloo ranks on the CPU, 240 s for the lot."""
    return spawn_ranks(_rank_jobs, WORLD, (chains, descs, flagship),
                       backend="gloo", device="cpu", timeout_s=240.0,
                       rendezvous_dir=str(tmp_path_factory.mktemp("ranks")))


def _cat(ranks, key, field, p, axis):
    parts = [ranks[r][key][field] for r in range(p)]
    for r in ranks[p:]:
        assert r[key] is None
    return np.concatenate(parts, axis=axis)


# ---------------------------------------------------------------------------
# the chain
# ---------------------------------------------------------------------------

def _jax_seqpar(diag, off, rhs, p):
    """JAX ``gbp_covariance_logdet_seqpar`` and ``solve_seqpar`` under
    ``shard_map`` on a p-device sp mesh (one chain, no leading axis)."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from gaussianvi_tpu.parallel import chain_seqpar as jcs

    mesh = Mesh(np.asarray(jax.devices()[:p]), ("sp",))
    off_pad = jcs.pad_off_for_seqpar(jax.numpy.asarray(off))

    def body(d, o, b):
        return (*jcs.gbp_covariance_logdet_seqpar(d, o, "sp"),
                jcs.solve_seqpar(d, o, b, "sp"))

    run = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P("sp"), P("sp"), P("sp")),
        out_specs=(P("sp"), P("sp"), P(), P("sp"))))
    return tuple(np.asarray(x) for x in run(diag, off_pad, rhs))


@pytest.mark.parametrize("case", CHAINS, ids=str)
def test_chain_seqpar_matches_jax_and_seq(ranks, chains, case):
    """Covariance blocks, log det and solve on p ranks against the port's
    sequential sweep / Thomas solve (the JAX tests' tolerances) and, for
    the single chains, against JAX's seqpar on p virtual devices (1e-12);
    the padded last edge row is zero."""
    p, n, s = case
    diag, off, rhs = chains[case]
    lead = diag.ndim - 3
    got = {k: _cat(ranks, case, k, p, lead) for k in (
        "cov_diag", "cov_off", "x", "fwd", "bwd")}
    for r in range(1, p):
        np.testing.assert_array_equal(ranks[r][case]["logdet"],
                                      ranks[0][case]["logdet"])
    a = BlockTridiag(torch.as_tensor(diag), torch.as_tensor(off))
    cd, co, ld = gbp_covariance_logdet(a)
    np.testing.assert_allclose(got["cov_diag"], cd.numpy(), rtol=1e-9,
                               atol=1e-11)
    np.testing.assert_allclose(got["cov_off"][..., :-1, :, :], co.numpy(),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_array_equal(got["cov_off"][..., -1, :, :], 0.0)
    np.testing.assert_allclose(ranks[0][case]["logdet"], ld.numpy(),
                               rtol=1e-11)
    x = solve(a, torch.as_tensor(rhs)).numpy()
    np.testing.assert_allclose(got["x"], x, rtol=1e-8, atol=1e-10)
    from gaussianvi_tpu_torch.ops import parallel_chain as pc

    np.testing.assert_allclose(got["fwd"], pc.forward_pivots(a).numpy(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got["bwd"], pc.backward_pivots(a).numpy(),
                               rtol=1e-12, atol=1e-12)
    if lead:
        return
    jcd, jco, jld, jx = _jax_seqpar(diag, off, rhs, p)
    np.testing.assert_allclose(got["cov_diag"], jcd, rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(got["cov_off"], jco, rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(ranks[0][case]["logdet"], jld, rtol=1e-13)
    np.testing.assert_allclose(got["x"], jx, rtol=1e-12, atol=1e-13)


def test_one_rank_seqpar_is_the_local_chain():
    """A 1 x 1 x 1 mesh: no collective, the segment is the chain."""
    from gaussianvi_tpu_torch.parallel import chain_seqpar as cs

    diag, off, rhs = (torch.as_tensor(x) for x in random_chain(6, 3, 0))
    mesh = parallel.make_mesh(1, 1, sp=1)
    a = BlockTridiag(diag, off)
    cd, co, ld = cs.gbp_covariance_logdet_seqpar(
        diag, cs.pad_off_for_seqpar(off), mesh)
    rcd, rco, rld = gbp_covariance_logdet(a)
    torch.testing.assert_close(cd, rcd, rtol=1e-10, atol=0)
    torch.testing.assert_close(ld, rld, rtol=1e-11, atol=0)
    x = cs.solve_seqpar(diag, cs.pad_off_for_seqpar(off), rhs, mesh)
    torch.testing.assert_close(x, solve(a, rhs), rtol=1e-9, atol=1e-12)
    assert not mesh.inventory and mesh.all_reduces == 0


# ---------------------------------------------------------------------------
# chain layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim_x", [1, 2])
def test_to_chain_layout_matches_jax(jax_problems, descs, dim_x):
    """Every array of the port's chain-layout graph equals JAX's."""
    from gaussianvi_tpu.parallel import to_chain_layout as jax_layout

    jg = jax_layout(jax_problems[dim_x][0])
    tg = parallel.to_chain_layout(_problem(descs[dim_x])[0])
    assert len(jg.nonlinear) == len(tg.nonlinear) == 1
    for jb, tb in zip(jg.nonlinear, tg.nonlinear):
        np.testing.assert_array_equal(tb.start.numpy(), np.asarray(jb.start))
        assert tb.slice_offset == jb.slice_offset == 0
        for k in jb.params:
            np.testing.assert_array_equal(tb.params[k].numpy(),
                                          np.asarray(jb.params[k]))
    assert len(jg.linear) == len(tg.linear) == 2
    for jb, tb in zip(jg.linear, tg.linear):
        for k in ("start", "lam", "psi", "target_mu", "target_prec",
                  "constant"):
            np.testing.assert_array_equal(getattr(tb, k).numpy(),
                                          np.asarray(getattr(jb, k)))
        assert tb.nb == jb.nb and not tb.uniform


@pytest.mark.parametrize("change,match", [
    ("binary", "unary nonlinear factors"),
    ("missing", "cover every state exactly once"),
    ("duplicate", "duplicate linear-factor starts"),
    ("batched", "one problem"),
])
def test_to_chain_layout_errors(descs, change, match):
    """What JAX's ``to_chain_layout`` refuses, the port refuses too; and a
    problem-batched graph (JAX takes one problem per call)."""
    from dataclasses import replace

    from gaussianvi_tpu_torch import stack_problems

    graph, state = _problem(descs[1])
    fb, (anchor, lb) = graph.nonlinear[0], graph.linear
    if change == "binary":
        graph = replace(graph, nonlinear=(replace(fb, nb=2),))
    elif change == "missing":
        graph = replace(graph, nonlinear=(replace(
            fb, start=fb.start.clamp(max=N - 2)),))
    elif change == "duplicate":
        start = lb.start.clone()
        start[1] = start[0]
        graph = replace(graph, linear=(anchor, replace(lb, start=start)))
    else:
        graph, _ = stack_problems([graph, graph], [state, state])
    with pytest.raises(ValueError, match=match):
        parallel.to_chain_layout(graph)


# ---------------------------------------------------------------------------
# the loop, time-sharded
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs(jax_problems):
    """JAX ``optimize_time_sharded`` on the CPU mesh, on demand."""
    import jax
    from jax.sharding import Mesh

    from gaussianvi_tpu.inference import GVIConfig as JaxConfig
    from gaussianvi_tpu.parallel import optimize_time_sharded, to_chain_layout

    cache = {}

    def run(method, dim_x, p):
        if (method, dim_x, p) not in cache:
            graph, init = jax_problems[dim_x]
            state, hist = optimize_time_sharded(
                to_chain_layout(graph), init, JaxConfig(**METHODS[method]),
                Mesh(np.asarray(jax.devices()[:p]), ("sp",)), method=method)
            cache[method, dim_x, p] = dict(
                cost=np.asarray(hist.cost),
                accepted_step=np.asarray(hist.accepted_step),
                factor_costs=np.asarray(hist.factor_costs),
                hist_mu=np.asarray(hist.mu), mu=np.asarray(state.mu),
                prec_diag=np.asarray(state.precision.diag),
                prec_off=np.asarray(state.precision.off))
        return cache[method, dim_x, p]

    return run


def _same_run(got, want, method, tag):
    """The JAX package's tolerances between a time-sharded run and
    ``optimize``: NGD costs 1e-9 and identical accepted steps, prox costs
    1e-8 (its JKO step amplifies rounding); final state 1e-9 (prox
    precision 1e-6 relative)."""
    np.testing.assert_allclose(got["cost"], want["cost"],
                               rtol=1e-9 if method == "ngd" else 1e-8,
                               atol=1e-12, err_msg=tag)
    np.testing.assert_array_equal(got["accepted_step"],
                                  want["accepted_step"], err_msg=tag)
    for k in ("mu", "hist_mu", "prec_off"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-7, atol=1e-9,
                                   err_msg=f"{tag}: {k}")
    np.testing.assert_allclose(got["prec_diag"], want["prec_diag"],
                               rtol=1e-7 if method == "ngd" else 1e-6,
                               atol=1e-9, err_msg=tag)


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("dim_x", [1, 2])
@pytest.mark.parametrize("method", ["ngd", "prox"])
def test_optimize_time_sharded_matches_jax_and_local(ranks, descs, jax_runs,
                                                     method, dim_x, p):
    """Every rank returns the whole run, the same bits on each; held to
    JAX ``optimize_time_sharded`` (on the JAX meshes of ``JAX_SP``) and to
    the port's ``optimize`` on the original graph."""
    key = (method, dim_x, p)
    got = ranks[0][key]
    for r in range(1, p):
        for k in ("cost", "accepted_step", "mu", "prec_diag", "prec_off",
                  "factor_costs"):
            np.testing.assert_array_equal(ranks[r][key][k], got[k])
    assert all(r[key] is None for r in ranks[p:])
    for jp in JAX_SP[dim_x]:
        want = jax_runs(method, dim_x, jp)
        _same_run(got, want, method, f"vs JAX on sp={jp}")
        np.testing.assert_allclose(got["factor_costs"], want["factor_costs"],
                                   rtol=1e-7, atol=1e-10)
    graph, state = _problem(descs[dim_x])
    final, hist = optimize(graph, state, GVIConfig(**METHODS[method]), method)
    _same_run(got, _result(final, hist), method, "vs the port's optimize")
    if method == "ngd":
        assert (got["accepted_step"] > 0).any()


def test_sharded_time_ngd_step_matches_jax(ranks, jax_problems):
    """One step at a fixed temperature on four ranks against JAX's on its
    8-device mesh."""
    import jax
    from jax.sharding import Mesh

    from gaussianvi_tpu.inference import GVIConfig as JaxConfig
    from gaussianvi_tpu.parallel import sharded_time_ngd_step, to_chain_layout

    graph, init = jax_problems[1]
    jstate, jcost = sharded_time_ngd_step(
        to_chain_layout(graph), init, JaxConfig(step_size_base=0.9),
        Mesh(np.asarray(jax.devices()[:8]), ("sp",)), temperature=2.0)
    for r in ranks:
        np.testing.assert_allclose(r["step"]["cost"], float(jcost),
                                   rtol=1e-10)
        np.testing.assert_allclose(r["step"]["mu"], np.asarray(jstate.mu),
                                   rtol=1e-7, atol=1e-9)


def test_time_sharded_seq_linesearch_matches_local(ranks, descs):
    """``linesearch="seq"`` decides each further trial on the all-reduced
    costs: both ranks run the same trials and match ``optimize``."""
    graph, state = _problem(descs[1])
    final, hist = optimize(graph, state, GVIConfig(**NGD, linesearch="seq"))
    _same_run(ranks[0]["seq"], _result(final, hist), "ngd", "seq")
    np.testing.assert_array_equal(ranks[1]["seq"]["mu"], ranks[0]["seq"]["mu"])


def test_time_sharded_errors(ranks, descs):
    """N = 16 over 3 ranks raises on each of them, and on the fourth,
    outside the mesh; so do a problem-batched state, a graph not in chain
    layout and the quadrature kernel asked for on the CPU."""
    for r in ranks[:3]:
        assert r["odd-N"][0] == "ValueError"
        assert "num_states 16 not divisible by sp=3" in r["odd-N"][1]
    assert "outside the 1x1x3 mesh" in ranks[3]["odd-N"][1]
    for r in ranks:
        assert "an sp mesh is optimize_time_sharded's" in r["sp-to-fp"]
    graph, state = _problem(descs[1])
    chain_graph = parallel.to_chain_layout(graph)
    mesh = parallel.make_mesh(1, 1)
    batched = type(state)(state.mu[None], BlockTridiag(
        state.precision.diag[None], state.precision.off[None]))
    with pytest.raises(ValueError, match="takes one problem"):
        parallel.optimize_time_sharded(chain_graph, batched, GVIConfig(),
                                       mesh)
    with pytest.raises(ValueError, match="chain layout"):
        parallel.optimize_time_sharded(graph, state, GVIConfig(), mesh)
    with pytest.raises(ValueError, match="CUDA"):
        parallel.optimize_time_sharded(chain_graph, state,
                                       GVIConfig(quad_impl="lanes"), mesh)


# ---------------------------------------------------------------------------
# the communication model against what the meshes recorded
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("method", ["ngd", "prox"])
def test_comm_model_predicts_the_time_sharded_run(ranks, method, p):
    """Each rank's recorded collectives equal ``niters`` iterations of
    ``time_shard_model`` plus ``time_shard_setup`` (chain estimation: one
    nonlinear batch, an anchor and the GP prior, the last nb == 2)."""
    from types import SimpleNamespace

    fields = METHODS[method]
    mesh = SimpleNamespace(size=p)
    for dim_x, s in ((1, 2), (2, 4)):
        want = comm_model.expected(
            comm_model.time_shard_model(N, s, 11, mesh, method),
            fields["niters"],
            comm_model.time_shard_setup(N, s, fields["niters"], mesh))
        for r in range(p):
            got = ranks[r][method, dim_x, p]["inventory"]
            assert got == dict(want), (dim_x, r)


@pytest.mark.parametrize("fused", [False, True], ids=["separate", "fused"])
def test_comm_model_predicts_the_factor_sharded_run(ranks, fused):
    """On a 2 x 2 mesh (two local problems, four of the eight range factors
    a rank): ``niters`` iterations of ``factor_shard_model`` plus
    ``factor_shard_setup``, with the same bytes per iteration as the JAX
    package's model of its psums."""
    n, s, niters = 8, 4, NGD["niters"]
    per_iter, report = comm_model.factor_shard_model(
        n, s, 11, 29, 8, local_batch=2, fused=fused)
    want = comm_model.expected(per_iter, niters, comm_model.factor_shard_setup(
        n, s, niters, (4,), local_batch=2))
    for r in ranks:
        assert r["fp-fused" if fused else "fp-separate"] == dict(want)
    b = 2
    assert report.bytes_per_iter == 8 * (b * (1 + n * s + n * s * s + 11)
                                         + b * (n - 1) * s * s)
    assert sum(c for (op, _, _), c in per_iter.items()
               if op == "all_reduce") == 3


# ---------------------------------------------------------------------------
# the JAX package's parallel exports
# ---------------------------------------------------------------------------

def _jax_parallel_names():
    import ast
    import pathlib

    path = (pathlib.Path(__file__).resolve().parent.parent / "gaussianvi_tpu"
            / "parallel" / "__init__.py")
    for node in ast.parse(path.read_text()).body:
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "__all__"):
            return ast.literal_eval(node.value)
    raise AssertionError("no __all__")


@pytest.mark.parametrize("name", _jax_parallel_names())
def test_jax_parallel_name_runs(descs, name):
    """Every name of JAX ``parallel.__all__`` is a port export that runs,
    here on the single process's 1 x 1 mesh (N = 16, dim_x = 1, one
    iteration)."""
    from gaussianvi_tpu_torch import stack_problems
    from gaussianvi_tpu_torch.parallel import chain_seqpar as cs

    assert name in parallel.__all__
    graph, state = _problem(descs[1])
    chain_graph = parallel.to_chain_layout(graph)
    graph_b, state_b = stack_problems([graph, graph], [state, state])
    cfg = GVIConfig(niters=1, step_size_base=0.9)
    mesh = parallel.make_mesh(1, 1)
    pad = cs.pad_off_for_seqpar(state.precision.off)
    calls = {
        "make_mesh": lambda: parallel.make_mesh(1, 1, sp=1),
        "sharded_ngd_step": lambda: parallel.sharded_ngd_step(
            graph_b, state_b, cfg, mesh)[1],
        "optimize_sharded": lambda: parallel.optimize_sharded(
            graph_b, state_b, cfg, mesh)[1].cost,
        "stack_problems": lambda: stack_problems([graph], [state])[1].mu,
        "optimize_restarts": lambda: parallel.optimize_restarts(
            graph, state, torch.Generator().manual_seed(0), 2, cfg)[1],
        "perturb_inits": lambda: parallel.perturb_inits(
            state, torch.Generator().manual_seed(0), 2, 0.1).mu,
        "gbp_covariance_logdet_seqpar": lambda: cs.gbp_covariance_logdet_seqpar(
            state.precision.diag, pad, mesh)[2],
        "solve_seqpar": lambda: cs.solve_seqpar(
            state.precision.diag, pad, state.mu, mesh),
        "pad_off_for_seqpar": lambda: pad,
        "sharded_time_ngd_step": lambda: parallel.sharded_time_ngd_step(
            chain_graph, state, cfg, mesh)[1],
        "optimize_time_sharded": lambda: parallel.optimize_time_sharded(
            chain_graph, state, cfg, mesh)[1].cost,
        "to_chain_layout": lambda: chain_graph.linear[1].lam,
    }
    out = calls[name]()
    if isinstance(out, torch.Tensor):
        assert bool(torch.isfinite(out).all())
    assert getattr(parallel, name) is not None
