"""The frozen work counts and the roofline readers."""

import json

import pytest
import torch

from benchmark import work
from benchmark.families import point3d_sdf, range_chain
from benchmark.trace import Trace, function_name

from conftest import REPO

FAMILIES = {"chain_est": range_chain, "point3d_plan": point3d_sdf}


def _cfg(name):
    return json.loads((REPO / "benchmark" / "configs" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_counts_are_the_same_for_the_fused_and_the_separate_route(name):
    """The count is read from the problem's shapes: the same graph on the
    fused route and on the separate route (``fused_trials="off"``) has
    one count, whatever kernels the engine resolves."""
    from gaussianvi_tpu_torch.inference.config import GVIConfig
    from gaussianvi_tpu_torch.inference.engine import LocalEngine
    from benchmark.traffic import seed_seq

    cfg = _cfg(name)
    fam = FAMILIES[name]
    per = 2 if name == "point3d_plan" else 1
    inputs = fam.make_inputs(cfg, seed_seq(3, 0, 0), 2, per)
    graph = fam.build_program(cfg, inputs, torch.float32, "cpu",
                              fam.make_shared(cfg))
    counts = []
    for fused in ("auto", "off"):
        # the engine's routes resolved as on the card, without launching
        engine = LocalEngine(graph, GVIConfig(fused_trials=fused,
                                              fused_gradient=fused),
                             torch.device("cuda"))
        counts.append((engine.fused_trials_ready,
                       work.trials(fam.shapes(cfg), cfg["gvi"], 2 * per, 4),
                       work.gradient(fam.shapes(cfg), 2 * per, 4)))
    assert counts[0][0] and not counts[1][0]
    assert counts[0][1:] == counts[1][1:]
    z = fam.shapes(cfg)
    nl = graph.nonlinear[0]
    assert (z["n"], z["s"], z["m"]) == (graph.num_states, graph.state_dim,
                                        nl.nodes.shape[0])


def test_counts_at_the_flagship_shapes():
    """Operation counts of the s = 4 flagship (B = 1024, 11 trials), the
    leading terms stated in ``work.py``."""
    z = range_chain.shapes(_cfg("chain_est"))
    ops, nbytes = work.trials(z, _cfg("chain_est")["gvi"], 1024, 4)
    assert ops == pytest.approx(11 * 1024 * 32 * (
        work.chain_flops(4) + work.quad_flops(4, 29, 2, False, 14) + 256))
    assert work.chain_flops(4) == pytest.approx(2 * (64 / 3 + 256)
                                                + (2 / 3 + 12) * 64)
    assert nbytes > 0


def _event(name, ts, dur, cat):
    return {"name": name, "ph": "X", "ts": ts, "dur": dur, "cat": cat}


def _trace(kernel_names):
    ev = [_event("bench.call", 0.0, 1000.0, "user_annotation"),
          _event("aten::mul", 10.0, 5.0, "cpu_op")]
    t = 100.0
    for n in kernel_names:
        ev.append(_event(n, t, 200.0, "kernel"))
        t += 300.0
    return Trace(ev)


class _Run:
    device_name = "NVIDIA H100 80GB HBM3"
    problems_per_call = 1024
    iters = 10
    elt = 4

    def __init__(self, trace):
        self.trace = trace
        self.cell = type("C", (), {"cfg": _cfg("chain_est")})()

    def shapes(self):
        return range_chain.shapes(self.cell.cfg)


def _reader(name):
    from benchmark.harness import load_module

    return load_module(REPO / "benchmark" / "metrics" / f"{name}.py",
                       "metric_" + name.replace(".", "_"))


def test_trace_reduction_and_the_readers():
    tr = _trace(["void gvi::trials_kernel<float, 4, gvi::RangeCost<2> >(a)",
                 "void gvi::grad_kernel<float, 4, false>(b)", "memcpy"])
    assert function_name(tr.device[0][2]) == "trials_kernel"
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s == pytest.approx(6e-4)
    assert tr.device_ops == 3
    run = _Run(tr)
    assert _reader("device_idle_pct.bulk").read(run) == pytest.approx(40.0)
    assert _reader("launches_per_iter.interactive").read(run) == \
        pytest.approx(0.3)
    share = _reader("trials_roofline.bulk").read(run)
    assert 0 < share
    gaps = tr.idle_gaps()
    assert sum(s for _, s in gaps) == pytest.approx(4e-4)


def test_a_roofline_reads_nothing_without_its_kernels():
    run = _Run(_trace(["void at::native::elementwise_kernel<128>(x)"]))
    assert _reader("trials_roofline.bulk").read(run) is None
    assert _reader("gradient_roofline.bulk").read(run) is None
    assert _reader("device_idle_pct.bulk").read(_Run(None)) is None
