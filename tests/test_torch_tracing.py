"""The port's phase spans (``utils.profiling.span``): the tree a profiled
``optimize`` call records, no span entered without a profiler, the same
bits with the profiler on and off, and, on the card, one
``gvi.kernel.<name>`` span for each launch ``kernels.launch_counts()``
counts.  No JAX: the card-only case runs on a machine without it.

    python -m pytest --noconftest -o addopts="" tests/test_torch_tracing.py -q
"""

import json
from collections import Counter

import pytest

torch = pytest.importorskip("torch")

from gaussianvi_tpu_torch import GVIConfig, optimize, stack_problems  # noqa: E402
from gaussianvi_tpu_torch.examples.chain_estimation import (  # noqa: E402
    build_chain_estimation,
)
from gaussianvi_tpu_torch.inference.optimize import optimize_from  # noqa: E402
from gaussianvi_tpu_torch.utils import profiling  # noqa: E402

CPU = torch.device("cpu")
NITERS = 3
# name -> (method, config fields): the batched and the sequential line
# search, and the proximal optimizer (which moves at small steps)
PATHS = {
    "ngd": ("ngd", {}),
    "ngd_seq": ("ngd", {"linesearch": "seq"}),
    "prox": ("prox", {"step_size_base": 0.1}),
}
PHASES = ["gvi.gradient", "gvi.trials", "gvi.select"]


def _problem(device, dtype=torch.float64, b=3, n=6):
    probs = [build_chain_estimation(num_states=n, dim_x=2, gh_degree=4,
                                    seed=seed, dtype=dtype,
                                    device=device)[:2] for seed in range(b)]
    return stack_problems([p[0] for p in probs], [p[1] for p in probs])


def _config(path, **over):
    method, fields = PATHS[path]
    return method, GVIConfig(niters=NITERS, niters_lowtemp=NITERS,
                             **fields, **over)


def _events(trace_dir):
    with open(trace_dir / "trace.json") as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and str(e.get("name", "")).startswith("gvi.")]


def _tree(events):
    """The spans as nested ``(name, [children])``, in time order."""
    root = ("", [])
    stack = [(float("inf"), root)]
    for e in sorted(events, key=lambda e: (e["ts"], -e["dur"])):
        while e["ts"] >= stack[-1][0]:
            stack.pop()
        node = (e["name"], [])
        stack[-1][1][1].append(node)
        stack.append((e["ts"] + e["dur"], node))
    return root[1]


def _names(nodes, prefix="gvi.kernel."):
    return [name for name, _ in nodes if not name.startswith(prefix)]


@pytest.mark.parametrize("path", list(PATHS))
def test_a_profiled_call_records_the_span_tree(tmp_path, path):
    graph, state = _problem(CPU)
    method, cfg = _config(path)
    with profiling.trace(str(tmp_path)):
        optimize(graph, state, cfg, method)
    tree = _tree(_events(tmp_path))
    assert _names(tree) == ["gvi.optimize"]
    children = tree[0][1]
    assert _names(children) == (["gvi.engine", "gvi.init"]
                                + ["gvi.iter"] * NITERS + ["gvi.finish"])
    for name, phases in children:
        if name == "gvi.iter":
            assert _names(phases) == PHASES


def test_a_resumed_call_records_its_window(tmp_path):
    """``optimize_from`` is a call of its own: its root holds the resumed
    iterations only."""
    graph, state = _problem(CPU)
    method, cfg = _config("ngd")
    with profiling.trace(str(tmp_path)):
        optimize_from(graph, state, cfg, method, start_iteration=1)
    (name, children), = _tree(_events(tmp_path))
    assert name == "gvi.optimize"
    assert _names(children) == (["gvi.engine", "gvi.init"]
                                + ["gvi.iter"] * (NITERS - 1) + ["gvi.finish"])


class _Counting(torch.profiler.record_function):
    """``record_function`` that notes each span it enters."""

    entered: list = []

    def __enter__(self):
        _Counting.entered.append(self.name)
        return super().__enter__()


@pytest.mark.parametrize("path", list(PATHS))
def test_no_span_is_entered_without_a_profiler(tmp_path, monkeypatch, path):
    monkeypatch.setattr(torch.profiler, "record_function", _Counting)
    monkeypatch.setattr(_Counting, "entered", [])
    graph, state = _problem(CPU)
    method, cfg = _config(path)
    optimize(graph, state, cfg, method)
    assert _Counting.entered == []
    # the same patch sees every span while a profiler records
    with profiling.trace(str(tmp_path)):
        optimize(graph, state, cfg, method)
    counts = Counter(_Counting.entered)
    assert counts["gvi.optimize"] == 1 and counts["gvi.iter"] == NITERS
    assert set(counts) >= {"gvi.engine", "gvi.init", "gvi.finish", *PHASES}


def test_a_span_is_one_shared_null_context_without_a_profiler():
    assert profiling.span("gvi.a") is profiling.span("gvi.b")


@pytest.mark.parametrize("path", list(PATHS))
def test_outputs_are_the_same_bits_with_the_profiler_on(tmp_path, path):
    graph, state = _problem(CPU)
    method, cfg = _config(path)
    plain = optimize(graph, state, cfg, method)
    with profiling.trace(str(tmp_path)):
        traced = optimize(graph, state, cfg, method)
    (f0, h0), (f1, h1) = plain, traced
    for a, b in [(f0.mu, f1.mu), (f0.precision.diag, f1.precision.diag),
                 (f0.precision.off, f1.precision.off), *zip(h0, h1)]:
        assert torch.equal(a, b)


# the card's routes: name -> config fields; together they reach every
# wrapper a single process launches (the split gradient pair runs only on
# ranks)
CARD_ROUTES = {
    "fused": ("ngd", {}),
    "separate": ("ngd", {"fused_trials": "off", "fused_gradient": "off"}),
    "block_moments": ("ngd", {"use_pallas": True, "fused_gradient": "off"}),
    "prox": ("prox", {"step_size_base": 0.1}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(CARD_ROUTES))
def test_kernel_spans_match_the_launch_counts(tmp_path, route):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only there)")
    from gaussianvi_tpu_torch.kernels import launch_counts

    dev = torch.device("cuda", 0)
    graph, state = _problem(dev, torch.float32, b=64, n=8)
    method, fields = CARD_ROUTES[route]
    cfg = GVIConfig(niters=NITERS, niters_lowtemp=NITERS, **fields)
    optimize(graph, state, cfg, method)          # builds the kernels
    torch.cuda.synchronize()
    before = launch_counts()
    with profiling.trace(str(tmp_path)):
        optimize(graph, state, cfg, method)
    grown = {f"gvi.kernel.{k}": v - before[k]
             for k, v in launch_counts().items() if v > before[k]}
    spans = Counter(e["name"] for e in _events(tmp_path)
                    if e["name"].startswith("gvi.kernel."))
    assert grown and dict(spans) == grown
