"""The GVI loop replayed as a CUDA graph (``inference/loop_graph.py``),
what the CPU can check: the call signature, which calls may take a graph,
the static copies' layout, and that CPU runs count as eager.  The replay
itself is checked on the card (``tests/test_torch_cuda.py``).  No JAX.

    python -m pytest --noconftest -o addopts="" tests/test_torch_loop_graph.py -q
"""

import warnings
from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

from gaussianvi_tpu_torch import GVIConfig, optimize, stack_problems  # noqa: E402
from gaussianvi_tpu_torch.examples.chain_estimation import (  # noqa: E402
    build_chain_estimation,
)
from gaussianvi_tpu_torch.examples.point3d_planning import (  # noqa: E402
    build_point3d_planning,
)
from gaussianvi_tpu_torch import kernels  # noqa: E402
from gaussianvi_tpu_torch.inference import loop_graph  # noqa: E402
from gaussianvi_tpu_torch.inference.engine import LocalEngine  # noqa: E402
from gaussianvi_tpu_torch.inference.optimize import (  # noqa: E402
    LoopState,
    _graph_call,
    optimize_from,
)
from gaussianvi_tpu_torch.kernels import (  # noqa: E402
    launch_counts,
    loop_graph_counts,
    reset_launch_counts,
)

CPU = torch.device("cpu")
# the engine is resolved for the card on CPU tensors: resolution launches
# nothing, and the routes are the card's
CARD = torch.device("cuda")
CFG = GVIConfig(niters=4, niters_lowtemp=2, step_size_base=0.9)


def _chain(seeds=range(3), n=8, dtype=torch.float64, dim_x=2):
    probs = [build_chain_estimation(num_states=n, dim_x=dim_x, gh_degree=4,
                                    seed=seed, dtype=dtype, device=CPU)[:2]
             for seed in seeds]
    return stack_problems([p[0] for p in probs], [p[1] for p in probs])


def _signature(graph, state, cfg=CFG, method="ngd", start=0, loop=None):
    # fresh copies, at the allocator's alignment as on the card (NumPy's
    # arrays, which the builders wrap, are aligned to fewer bytes)
    graph, state = loop_graph.map_tensors((graph, state), torch.clone)
    engine = LocalEngine(graph, cfg, CARD)
    call = _graph_call(engine, state, cfg, method, start, loop)
    assert call is not None
    key, tree, _ = call
    sig, _ = loop_graph.signature(key, tree)
    assert sig is not None
    return sig


def test_signature_is_equal_for_other_values_of_the_same_shapes():
    a, b = _chain(range(3)), _chain(range(3, 6))
    assert not torch.equal(a[1].mu, b[1].mu)
    assert _signature(*a) == _signature(*b)
    assert hash(_signature(*a)) == hash(_signature(*b))


@pytest.mark.parametrize("change", ["shape", "batch", "dtype", "config",
                                    "route", "start_iteration", "loop"])
def test_signature_differs(change):
    graph, state = _chain()
    base = _signature(graph, state)
    if change == "shape":
        other = _signature(*_chain(n=9))
    elif change == "batch":
        other = _signature(*_chain(range(4)))
    elif change == "dtype":
        other = _signature(*_chain(dtype=torch.float32))
    elif change == "config":
        other = _signature(graph, state, replace(CFG, step_decay=0.7))
    elif change == "route":
        other = _signature(graph, state, replace(CFG, fused_trials="off"))
    elif change == "start_iteration":
        other = _signature(graph, state, start=1)
    else:
        other = _signature(graph, state,
                           loop=LoopState(CFG.temperature, True, False))
    assert other != base


def test_the_tree_holds_the_operands_and_the_starts():
    """The tree the region reads: the state, the graph and the fused
    operands, each tensor once; every fused batch's start is refreshed."""
    graph, state = _chain()
    engine = LocalEngine(graph, CFG, CARD)
    key, tree, starts = _graph_call(engine, state, CFG, "ngd", 0, None)
    _, leaves = loop_graph.signature(key, tree)
    ids = {id(t) for t in leaves}
    assert len(ids) == len(leaves)
    assert {id(state.mu), id(state.precision.diag), id(graph.linear[0].lam),
            id(graph.nonlinear[0].kernel_params)} <= ids
    # a dict (the params cost_fn reads) is not read by the region
    assert id(next(iter(graph.nonlinear[0].params.values()))) not in ids
    ops = engine._fused_ops
    assert [id(t) for t, _ in starts] == [id(a[0])
                                          for a in (*ops[2], *ops[3])]
    assert all(n == graph.num_states and id(t) in ids for t, n in starts)


def _point3d(patch_size=None):
    graph, init, cfg, _ = build_point3d_planning(
        num_states=6, patch_size=patch_size, device=CPU)
    return graph, init, cfg


@pytest.mark.parametrize("case", ["cpu", "seq", "prox", "empty window",
                                  "float16", "cost_fn", "patch mode",
                                  "s = 14", "factor-parallel"])
def test_ineligible_calls_take_no_graph(case):
    graph, state = _chain()
    cfg, method, start, device = CFG, "ngd", 0, CARD
    if case == "s = 14":
        # no quadrature kernel covers the wide chain's factors
        graph, state = _chain(n=4, dtype=torch.float32, dim_x=7)
    elif case == "cpu":
        device = CPU
    elif case == "seq":
        cfg = replace(CFG, linesearch="seq")
    elif case == "prox":
        method = "prox"
    elif case == "empty window":
        start = CFG.niters
    elif case == "float16":
        cfg = replace(CFG, moments_eval_dtype="float16")
    elif case == "cost_fn":
        graph, state, cfg = _point3d()
        graph = replace(graph, nonlinear=(replace(graph.nonlinear[0],
                                                  kernel_cost=None,
                                                  kernel_params=None),))
    elif case == "patch mode":
        graph, state, cfg = _point3d(patch_size=4)
    if case == "factor-parallel":
        from gaussianvi_tpu_torch.parallel import make_mesh
        from gaussianvi_tpu_torch.parallel.sharding import FactorShardEngine

        engine = FactorShardEngine(graph, cfg, device, make_mesh(1, 1))
    else:
        engine = LocalEngine(graph, cfg, device)
    assert _graph_call(engine, state, cfg, method, start, None) is None


def test_the_point_planner_is_eligible():
    graph, state, cfg = _point3d()
    assert _signature(graph, state, cfg) is not None


@pytest.mark.parametrize("method, fields", [
    ("ngd", {}), ("ngd", {"linesearch": "seq"}), ("prox", {}),
])
def test_cpu_runs_count_as_eager(method, fields):
    graph, state = _chain()
    cfg = replace(CFG, step_size_base=0.1 if method == "prox" else 0.9,
                  **fields)
    reset_launch_counts()
    for _ in range(3):
        optimize(graph, state, cfg, method)
    optimize_from(graph, state, cfg, method, start_iteration=1)
    assert loop_graph_counts() == {"eager": 4, "captured": 0, "replayed": 0}
    assert not any(launch_counts().values())
    reset_launch_counts()
    assert loop_graph_counts() == {"eager": 0, "captured": 0, "replayed": 0}


def test_the_factor_parallel_run_counts_no_call():
    from gaussianvi_tpu_torch.parallel import make_mesh, optimize_sharded

    graph, state = _chain()
    reset_launch_counts()
    optimize_sharded(graph, state, CFG, make_mesh(1, 1))
    assert loop_graph_counts() == {"eager": 0, "captured": 0, "replayed": 0}


@pytest.mark.parametrize("layout", ["contiguous", "broadcast", "view",
                                    "transposed", "empty"])
def test_static_copies_keep_the_layout(layout):
    base = torch.arange(60, dtype=torch.float64).reshape(3, 4, 5)
    t = {"contiguous": base,
         "broadcast": base[0].expand(7, 4, 5),
         "view": base[:, 1:3, ::2],
         "transposed": base.transpose(0, 2),
         "empty": base[:, :0]}[layout]
    assert loop_graph._copyable(t)
    static = loop_graph._static_like(t)
    assert static.shape == t.shape and static.stride() == t.stride()
    align = loop_graph.ALIGN
    assert static.data_ptr() % align == t.data_ptr() % align
    loop_graph._compact(static).copy_(loop_graph._compact(t))
    assert torch.equal(static, t)


def test_overlapping_tensors_take_no_graph():
    t = torch.arange(10.0).as_strided((4, 3), (2, 1))
    assert not loop_graph._copyable(t)
    assert loop_graph.signature("key", (t,))[0] is None
    assert loop_graph.signature("key", (torch.zeros(2), t[:1]))[0] is not None


def test_map_tensors_keeps_the_tree_and_its_aliases():
    graph, state = _chain()
    seen = []

    def fn(t):
        seen.append(t)
        return t.clone()

    tree = (state, graph, state.mu)
    out = loop_graph.map_tensors(tree, fn)
    assert out[2] is out[0].mu and len(seen) == len({id(t) for t in seen})
    assert type(out[1].nonlinear[0]) is type(graph.nonlinear[0])
    assert out[1].nonlinear[0].params is None
    assert out[1].nonlinear[0].cost_fn is graph.nonlinear[0].cost_fn
    assert torch.equal(out[0].precision.off, state.precision.off)
    assert out[0].precision.off is not state.precision.off


class _EagerGraph(loop_graph._Graph):
    """A graph without the card: the region run on the static inputs at
    every replay, so the path around the capture (signature, static
    copies, outputs) runs on the CPU."""

    def __init__(self, leaves, tree, region, starts):
        self.static = [loop_graph._static_like(t) for t in leaves]
        ids = {id(t): i for i, t in enumerate(leaves)}
        self.tree = loop_graph.map_tensors(
            tree, lambda t: self.static[ids[id(t)]])
        self.region, self.indexes, self.launches = region, [], {}
        self.replays = 0

    def replay(self, leaves):
        self.load(leaves)
        self.out = self.region(self.tree)
        return self.out


def test_the_graph_path_returns_the_eager_loop_on_the_cpu(monkeypatch):
    """Problem sets A, B, A, B through the graph path with the region run
    eagerly on the static copies (``_EagerGraph``): eager, captured,
    replayed, replayed, each call the eager loop's bits on its own set,
    and the first call's outputs untouched by the later ones."""
    from gaussianvi_tpu_torch.inference.optimize import (
        _run_call,
        run_gvi_carry,
    )

    monkeypatch.setattr(loop_graph, "_Graph", _EagerGraph)
    cfg = GVIConfig(niters=5, niters_lowtemp=3, step_size_base=0.9)
    sets = [loop_graph.map_tensors(_chain(seeds), torch.clone)
            for seeds in (range(3), range(3, 6))]
    loop_graph.clear()
    reset_launch_counts()
    outs, first = [], None
    for k in (0, 1, 0, 1):
        graph, state = sets[k]
        with torch.no_grad():
            want = run_gvi_carry(LocalEngine(graph, cfg, CARD), state, cfg)
            got = _run_call(LocalEngine(graph, cfg, CARD), state, cfg, "ngd")
        flat = [got[0].state.mu, got[0].state.precision.diag,
                got[0].temperature, got[0].converged, *got[1]]
        for a, b in zip(flat, [want[0].state.mu, want[0].state.precision.diag,
                               want[0].temperature, want[0].converged,
                               *want[1]]):
            assert torch.equal(a, b)
        outs.append(flat)
        if first is None:
            first = [x.clone() for x in flat]
    assert loop_graph_counts() == {"eager": 1, "captured": 1, "replayed": 2}
    assert all(torch.equal(a, b) for a, b in zip(outs[0], first))
    loop_graph.clear()


class _FakeGraph:
    """A kept graph without the card: ``region`` run on the call's own
    tree at every replay; ``fail`` raises at the capture (after counting
    launches, as a capture that launched some kernels)."""

    made = 0
    fail = None

    def __init__(self, leaves, tree, region, starts):
        type(self).made += 1
        self.region, self.launches, self.replays = region, {"solve": 2}, 0
        if self.fail is not None:
            kernels.WRAPPERS["solve"].launches += 5
            raise self.fail

    def replay(self, leaves):
        return self.region((leaves[0],))


def _fake_run(x, eager=None):
    return loop_graph.run(("key", x.shape), (x,),
                          eager or (lambda: ("eager", x * 2)),
                          lambda tree: tree[0] * 2,
                          lambda out: ("graph", out.clone()))


@pytest.fixture
def fake_graph(monkeypatch):
    monkeypatch.setattr(loop_graph, "_Graph", _FakeGraph)
    monkeypatch.setattr(_FakeGraph, "made", 0)
    monkeypatch.setattr(_FakeGraph, "fail", None)
    loop_graph.clear()
    reset_launch_counts()
    yield _FakeGraph
    loop_graph.clear()
    reset_launch_counts()


@pytest.mark.parametrize("error", [torch.OutOfMemoryError("pool"),
                                   RuntimeError("operation not permitted "
                                                "when stream is capturing")])
def test_a_failed_capture_runs_that_signature_eager_for_good(fake_graph,
                                                             error):
    """A capture that raises: the call runs eager, the launch counters
    read as before the capture, and every later call of the signature
    runs eager without another capture; another signature still takes
    its graph."""
    fake_graph.fail = error
    x = torch.arange(4.0)
    kinds = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(4):
            seen = loop_graph_counts()
            kind, out = _fake_run(x)
            assert kind == "eager" and torch.equal(out, x * 2)
            now = loop_graph_counts()
            kinds += [k for k in now if now[k] > seen[k]]
    assert kinds == ["eager"] * 4 and fake_graph.made == 1
    assert [w.category for w in caught] == [RuntimeWarning]
    assert not any(launch_counts().values())
    fake_graph.fail = None
    y = torch.arange(5.0)
    assert [_fake_run(y)[0] for _ in range(3)] == ["eager", "graph", "graph"]
    assert loop_graph_counts() == {"eager": 5, "captured": 1, "replayed": 1}
    assert launch_counts()["solve"] == 4


def test_an_eager_call_out_of_memory_frees_the_kept_graphs(fake_graph):
    """Where the eager loop runs out of the device's memory while graphs
    are kept, the graphs are dropped (their signatures capture again on
    their next call), the counters read as before the failed run, and the
    call runs again; without kept graphs the error is the caller's."""
    a, b = torch.arange(3.0), torch.arange(6.0)
    assert [_fake_run(a)[0] for _ in range(2)] == ["eager", "graph"]
    tries = []

    def eager():
        tries.append(1)
        if len(tries) == 1:
            kernels.WRAPPERS["solve"].launches += 7
            raise torch.OutOfMemoryError("held by a graph")
        return "eager", b * 2

    kind, out = _fake_run(b, eager)
    assert kind == "eager" and torch.equal(out, b * 2) and len(tries) == 2
    assert launch_counts()["solve"] == 2
    assert not any(isinstance(g, _FakeGraph)
                   for g in loop_graph._GRAPHS.values())
    assert [_fake_run(a)[0] for _ in range(2)] == ["graph", "graph"]
    assert fake_graph.made == 2
    loop_graph.clear()

    def out_of_memory():
        raise torch.OutOfMemoryError("no graph kept")

    with pytest.raises(torch.OutOfMemoryError):
        _fake_run(b, out_of_memory)


def test_a_replay_out_of_memory_runs_eager(fake_graph, monkeypatch):
    """Where the replay's outputs do not fit, the call runs eager and
    counts no replayed launch."""
    x = torch.arange(3.0)
    assert [_fake_run(x)[0] for _ in range(2)] == ["eager", "graph"]

    def replay(self, leaves):
        raise torch.OutOfMemoryError("outputs")

    monkeypatch.setattr(_FakeGraph, "replay", replay)
    before = launch_counts()
    assert _fake_run(x)[0] == "eager"
    assert launch_counts() == before
    assert loop_graph_counts() == {"eager": 2, "captured": 1, "replayed": 0}


def test_traffic_of_more_signatures_than_are_kept_captures_later(
        fake_graph, monkeypatch):
    """While the last graph dropped for room had never been replayed, a
    signature captures on its third call, not its second; once a dropped
    graph had been replayed, on its second again."""
    monkeypatch.setattr(loop_graph, "MAX_GRAPHS", 2)
    a, b, c, d, e, f, g = (torch.arange(float(n)) for n in range(1, 8))
    calls = [a, a, b, c,   # a's graph dropped unreplayed for c
             d, d, d, d,   # d captures on its third call
             e, f,         # d's graph dropped, replayed once
             g, g]         # g captures on its second call
    kinds = [_fake_run(x)[0] for x in calls]
    assert kinds == ["eager", "graph", "eager", "eager",
                     "eager", "eager", "graph", "graph",
                     "eager", "eager", "eager", "graph"]
    assert loop_graph_counts() == {"eager": 8, "captured": 3, "replayed": 1}


def test_the_real_capture_raising_on_the_cpu_runs_eager():
    """The loop's own capture path on CPU tensors of an engine resolved
    for the card: the capture raises (no CUDA stream on the CPU), so the
    second call and every later one of the signature run eager, with the
    eager loop's bits, and one warning."""
    from gaussianvi_tpu_torch.inference.optimize import (
        _run_call,
        run_gvi_carry,
    )

    graph, state = loop_graph.map_tensors(_chain(), torch.clone)
    loop_graph.clear()
    reset_launch_counts()
    with torch.no_grad():
        want = run_gvi_carry(LocalEngine(graph, CFG, CARD), state, CFG)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            outs = [_run_call(LocalEngine(graph, CFG, CARD), state, CFG,
                              "ngd") for _ in range(3)]
    assert [w.category for w in caught] == [RuntimeWarning]
    assert loop_graph_counts() == {"eager": 3, "captured": 0, "replayed": 0}
    for got in outs:
        assert torch.equal(got[0].state.mu, want[0].state.mu)
        assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    loop_graph.clear()
