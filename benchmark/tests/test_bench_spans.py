"""The program's spans read from the profiler trace (``spans.py``): device
operations put down to the span that launched them, idle gaps named by
span, the span metrics, the base reduction's numbers unchanged, and a
traced run of a cell through the harness on the CPU."""

import json

import pytest

from benchmark import spans
from benchmark.families import range_chain
from benchmark.spans import NO_OP, OUTSIDE, SpanTrace
from benchmark.trace import Trace

from conftest import REPO

TRIALS = "void gvi::trials_kernel<float, 4, gvi::RangeCost<2> >(a)"
GRAD = "void gvi::grad_kernel<float, 4, false>(b)"


def _x(name, ts, dur, cat, corr=None):
    e = {"name": name, "ph": "X", "ts": ts, "dur": dur, "cat": cat,
         "pid": 1, "tid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _events():
    """One profiled call of 1000 us: the program's spans, host operators,
    the runtime's launches and the device operations they launched."""
    ua, op = "user_annotation", "cpu_op"
    return [
        _x("bench.call", 0.0, 1000.0, ua),
        _x("gvi.optimize", 10.0, 890.0, ua),
        _x("gvi.engine", 10.0, 30.0, ua),
        _x("gvi.iter", 100.0, 500.0, ua),
        _x("gvi.trials", 150.0, 150.0, ua),
        _x("gvi.kernel.fused_trials", 200.0, 60.0, ua),
        _x("gvi.select", 300.0, 280.0, ua),
        _x("aten::empty", 205.0, 3.0, op),
        _x("aten::add", 320.0, 10.0, op),
        _x("aten::mul", 395.0, 20.0, op),
        _x("aten::bmm", 700.0, 20.0, op),
        _x("cudaLaunchKernel", 220.0, 5.0, "cuda_runtime", 1),
        _x("cudaLaunchKernel", 325.0, 3.0, "cuda_runtime", 2),
        _x("cudaMemcpyAsync", 20.0, 5.0, "cuda_runtime", 3),
        _x("cudaLaunchKernel", 950.0, 5.0, "cuda_runtime", 4),
        _x("cudaLaunchKernel", 710.0, 5.0, "cuda_runtime", 5),
        _x(TRIALS, 230.0, 170.0, "kernel", 1),
        _x("void at::native::elementwise_kernel<128>(x)", 410.0, 20.0,
           "kernel", 2),
        _x("Memcpy HtoD", 30.0, 5.0, "gpu_memcpy", 3),
        _x("void at::native::reduce_kernel<512>(r)", 960.0, 20.0, "kernel",
           4),
        _x(GRAD, 720.0, 80.0, "kernel", 5),
    ]


def _without_spans(events):
    return [e for e in events if not e["name"].startswith("gvi.")]


def test_device_operations_are_put_down_to_the_span_that_launched_them():
    tr = SpanTrace(_events())
    named = [tr.spans[j][2] if j >= 0 else None for j in tr.op_span]
    assert named == ["gvi.kernel.fused_trials", "gvi.select", "gvi.engine",
                     None, "gvi.optimize"]
    table = tr.span_table()
    assert table["gvi.kernel.fused_trials"]["device_ops"] == 1
    assert table["gvi.kernel.fused_trials"]["device_ms"] == \
        pytest.approx(0.170)
    assert table[OUTSIDE]["device_ops"] == 1
    assert sum(r["device_ops"] for r in table.values()) == tr.device_ops
    # host and self time: the root less its engine and iteration, the
    # iteration less its trials and select
    assert table["gvi.optimize"]["host_ms"] == pytest.approx(0.890)
    assert table["gvi.optimize"]["self_ms"] == pytest.approx(0.360)
    assert table["gvi.iter"]["self_ms"] == pytest.approx(0.070)
    assert table["gvi.iter"]["count"] == 1


def test_idle_gaps_are_named_by_the_innermost_operator_or_span():
    tr = SpanTrace(_events())
    gaps = {n: s for n, s in tr.idle_gaps()}
    assert gaps == pytest.approx({
        "gvi.engine": 30e-6, "gvi.iter": 195e-6, "aten::mul": 10e-6,
        "gvi.select": 290e-6, "gvi.optimize": 160e-6, NO_OP: 20e-6})
    # without the spans the same gaps are the operator's or no one's
    base = {n: s for n, s in Trace(_events()).idle_gaps()}
    assert base == pytest.approx({NO_OP: 695e-6, "aten::mul": 10e-6})
    assert tr.no_operator_idle_share() == pytest.approx(20 / 705)
    table = tr.span_table()
    assert table["gvi.select"]["idle_ms"] == pytest.approx(0.290)
    assert table[OUTSIDE]["idle_ms"] == pytest.approx(0.020)


def test_the_span_metrics():
    tr = SpanTrace(_events())
    assert tr.loop_host_ms_per_iter(2) == pytest.approx(0.25)
    assert tr.call_host_ms() == pytest.approx(0.39)
    assert tr.glue_device_pct() == pytest.approx(100 * 125 / 295)
    line = spans.spans_line(tr.span_table())
    assert line.startswith("[spans] gvi.optimize 1 x, host 0.890000 ms")


def test_without_the_program_spans_the_span_metrics_read_nothing():
    tr = SpanTrace(_without_spans(_events()))
    assert tr.spans == [] and tr.loop_host_ms_per_iter(2) is None
    assert tr.call_host_ms() is None and tr.glue_device_pct() is None


class _Run:
    device_name = "NVIDIA H100 80GB HBM3"
    problems_per_call = 1024
    iters = 10
    elt = 4

    def __init__(self, trace):
        self.trace = trace
        self.cell = type("C", (), {"cfg": json.loads(
            (REPO / "benchmark" / "configs" / "chain_est.json")
            .read_text())})()

    def shapes(self):
        return range_chain.shapes(self.cell.cfg)


def _readings(trace):
    """Every per-layer metric of the benchmark and every number of the
    base reduction, read from ``trace``."""
    from benchmark.harness import load_module

    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    run = _Run(trace)
    out = {}
    for m in spec["per_layer"]:
        path = REPO / "benchmark" / "metrics" / f"{m['name']}.py"
        if path.exists():
            out[m["name"]] = load_module(
                path, "metric_" + m["name"].replace(".", "_")).read(run)
    out.update(calls=trace.calls, window=trace.window_s, busy=trace.busy_s,
               ops=trace.device_ops, top=trace.top_device_ops(),
               trials=trace.seconds_of(("trials_kernel",)))
    return out


@pytest.mark.parametrize("with_spans", [False, True])
def test_the_base_numbers_are_unchanged(with_spans):
    """Every existing metric, ``top_device_ops()`` and the rest read the
    same from a ``SpanTrace``; without the program's spans
    ``idle_gaps()`` does too."""
    events = _events() if with_spans else _without_spans(_events())
    base, ext = Trace(events), SpanTrace(events)
    assert _readings(ext) == _readings(base)
    assert _readings(base)["device_idle_pct.bulk"] is not None
    if not with_spans:
        assert ext.idle_gaps() == base.idle_gaps()


def test_a_profiled_call_on_the_cpu_reads_the_same(tmp_path):
    """A real trace: the port's call under the profiler, inside the
    harness's annotation."""
    import torch

    from gaussianvi_tpu_torch import GVIConfig, optimize, stack_problems
    from gaussianvi_tpu_torch.examples.chain_estimation import (
        build_chain_estimation,
    )
    from gaussianvi_tpu_torch.utils.profiling import trace

    probs = [build_chain_estimation(num_states=5, dim_x=2, gh_degree=4,
                                    seed=s, device="cpu")[:2]
             for s in range(2)]
    graph, state = stack_problems(*map(list, zip(*probs)))
    with trace(str(tmp_path)):
        with torch.profiler.record_function("bench.call"):
            optimize(graph, state, GVIConfig(niters=2, niters_lowtemp=2))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    tr = SpanTrace(events)
    assert {n for _, _, n in tr.spans} == {
        "gvi.optimize", "gvi.engine", "gvi.init", "gvi.iter", "gvi.gradient",
        "gvi.trials", "gvi.select", "gvi.finish"}
    assert tr.parent.count(-1) == 1
    assert 0 < tr.call_host_ms() and 0 < tr.loop_host_ms_per_iter(2)
    base = Trace(events)
    assert (base.window_s, base.busy_s, base.device_ops, len(base.host)) == \
        (tr.window_s, tr.busy_s, tr.device_ops, len(tr.host))
    plain = Trace(_without_spans(events))
    assert SpanTrace(_without_spans(events)).idle_gaps() == plain.idle_gaps()


def test_a_traced_run_of_a_cell_reports_the_host_metrics(tiny_root):
    out = spans.run(tiny_root, "chain_est.fleet64", 2**33 + 7, 1.0, "cpu")
    assert out["result"]["correct"]
    got = out["spans"]
    assert got["loop_host_ms_per_iter"] > 0 and got["call_host_ms"] > 0
    table = out["table"]
    traced = out["calls_ms"]["traced"]
    assert traced >= 1 and table["gvi.optimize"]["count"] == traced
    iters = json.loads((tiny_root / "benchmark" / "configs"
                        / "chain_est.json").read_text())["gvi"]["niters"]
    assert table["gvi.iter"]["count"] == traced * iters
