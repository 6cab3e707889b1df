"""The harness end to end at a tiny size on the CPU, through its test
hook (``run_cell(..., device="cpu")``): every cell, the control and the
faults that ``correct`` has to catch, a cell, a configuration and a
metric added as new files only, the refusal without a card, and the
modules a run loads."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import judge
from benchmark.control import control_readings
from benchmark.harness import BANNED, run_cell

from conftest import REPO

CELLS = ["chain_est.bulk16k", "point3d_plan.r1024", "chain_est.fleet64",
         "point3d_plan.bulk8x1024"]
SEED = 2**33 + 101


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_end_to_end_on_the_cpu(tiny_root, cell):
    result, code = run_cell(tiny_root, cell, SEED, 0.2, False, "cpu")
    assert code == 0 and result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    wanted = {m["name"] for m in spec["end_to_end"]
              if cell in m.get("workloads", [cell])}
    assert set(result["metrics"]) == wanted
    assert list(result)[-1] == "checks"
    cfg = json.loads((tiny_root / "benchmark" / "configs"
                      / f"{cell.split('.')[0]}.json").read_text())
    assert set(result["checks"]) == set(cfg["limits"])


def test_a_traced_run_reports_the_trace(tiny_root):
    result, code = run_cell(tiny_root, "chain_est.fleet64", SEED, 1.0, True,
                            "cpu")
    assert code == 0 and result["correct"]
    assert "window_s" in result["device"] and "breakdown" in result
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def _unchanged(optimize):
    """A step that returns its state unchanged."""
    def call(graph, state, config):
        final, hist = optimize(graph, state, config)
        return state, hist
    return call


def _half(optimize):
    """Half of the batch left out, the rest's outputs given for all."""
    def call(graph, state, config):
        final, hist = optimize(graph, state, config)
        b = final.mu.shape[0]
        idx = torch.arange(b) % max(1, b // 2)
        pick = lambda x: x[idx]                               # noqa: E731
        final = type(final)(pick(final.mu), type(final.precision)(
            pick(final.precision.diag), pick(final.precision.off)))
        hist = type(hist)(*(pick(x) for x in hist))
        return final, hist
    return call


def _altered(optimize):
    """An answer altered where it is produced: the final means."""
    def call(graph, state, config):
        final, hist = optimize(graph, state, config)
        return type(final)(final.mu + 1e-3, final.precision), hist
    return call


def _trials(edit):
    """The line search's trial costs ``[T, B]`` edited by ``edit`` where
    the program reduces them (K5's on the card, the separate route's
    here)."""
    def wrap(optimize):
        from gaussianvi_tpu_torch.inference.engine import LocalEngine

        def call(graph, state, config):
            orig = LocalEngine.reduce_trial_costs
            LocalEngine.reduce_trial_costs = (
                lambda self, ld, fc: edit(orig(self, ld, fc)))
            try:
                return optimize(graph, state, config)
            finally:
                LocalEngine.reduce_trial_costs = orig
        return call
    return wrap


def _nan(cost):
    """Every trial NaN: each search rejected, the state left unchanged
    and the recorded history consistent with it."""
    return torch.full_like(cost, float("nan"))


def _skip(cost):
    """The first trial passed over: the search takes the first later
    trial that decreases (a wrong selection among the trials)."""
    return torch.cat([torch.full_like(cost[:1], float("inf")), cost[1:]])


FAULTS = {"unchanged": _unchanged, "half": _half, "altered": _altered,
          "rejected": _trials(_nan), "skip_first": _trials(_skip)}


@pytest.mark.parametrize("fault", list(FAULTS.values()), ids=list(FAULTS))
@pytest.mark.parametrize("cell", ["chain_est.fleet64", "point3d_plan.r1024"])
def test_a_fault_in_the_timed_path_reads_incorrect(tiny_root, cell, fault):
    result, code = run_cell(tiny_root, cell, SEED, 0.2, False, "cpu",
                            wrap=fault)
    assert code == 0
    assert not result["correct"] and result["failed"] >= 1


@pytest.mark.parametrize("cell", ["chain_est.fleet64", "point3d_plan.r1024"])
def test_the_control_reads_incorrect(tiny_root, cell):
    """The reference with TF32 products in the program's place."""
    cfg = json.loads((tiny_root / "benchmark" / "configs"
                      / f"{cell.split('.')[0]}.json").read_text())
    read = control_readings(tiny_root, cell, SEED, torch.device("cpu"))
    bad, checks = judge.verdict(read, cfg["limits"])
    assert bad.any(), checks


def test_a_cell_configuration_and_metric_added_as_new_files(tiny_root):
    home = tiny_root / "benchmark"
    cfg = json.loads((home / "configs" / "chain_est.json").read_text())
    cfg.update(name="chain_est_short", num_states=4)
    (home / "configs" / "chain_est_short.json").write_text(json.dumps(cfg))
    (home / "workloads" / "chain_est_short.tiny.json").write_text(json.dumps(
        {"requests_per_call": 2, "per_request": 1, "pool_calls": 1,
         "kept_per_call": 1, "checked": 2, "traced_calls": 1}))
    (home / "metrics" / "calls_in_window.py").write_text(
        "def read(run):\n    return float(len(run.calls))\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({
        "name": "chain_est_short", "source": "https://arxiv.org/abs/1911.08333",
        "file": "benchmark/configs/chain_est_short.json",
        "reduced": ["num_states"], "why": "a shorter chain"})
    spec["workloads"].append({
        "name": "chain_est_short.tiny", "config": "chain_est_short",
        "traffic": "tiny", "chips": 1, "why": "two problems a call"})
    spec["end_to_end"][1]["workloads"].append("chain_est_short.tiny")
    spec["per_layer"].append({
        "name": "calls_in_window", "unit": "calls", "better": "higher",
        "source": "program_counter", "layer": "loop and glue",
        "moves": "solve_p95_ms", "workloads": ["chain_est_short.tiny"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    result, code = run_cell(tiny_root, "chain_est_short.tiny", SEED, 0.2,
                            False, "cpu")
    assert code == 0 and result["correct"]
    assert "solve_p95_ms" in result["metrics"]
    traced, _ = run_cell(tiny_root, "chain_est_short.tiny", SEED, 0.2, True,
                         "cpu")
    assert traced["metrics"]["calls_in_window"]["value"] >= 1


def _python(code, **env):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, **env})


def test_the_run_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_a_run_and_the_reference_load_no_jax(tiny_root):
    """Top-level module names compared whole: the program's own name
    begins with the JAX package's."""
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "import benchmark.reference.dense_gvi, benchmark.reference.range_chain\n"
        "import benchmark.reference.point3d_sdf, benchmark.judge\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(tops & {'gaussianvi_tpu_torch', 'gaussianvi_tpu', 'jax'}))\n"
        "from benchmark.harness import run_cell, banned_modules\n"
        f"res, code = run_cell({str(tiny_root)!r}, 'point3d_plan.r1024', 5, 0.2,"
        " False, 'cpu')\n"
        "print(banned_modules(), res['correct'])\n")
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref_line, run_line = proc.stdout.strip().splitlines()[-2:]
    assert ref_line == "[]"
    assert run_line == "[] True"
    assert "gaussianvi_tpu" in BANNED and "jax" in BANNED


def test_the_benchmark_reads_no_file_of_the_jax_benchmark():
    names = ("bench" + ".py", "BENCH" + "_")
    for path in (REPO / "benchmark").rglob("*.py"):
        if "tests" not in path.parts:
            assert not any(n in path.read_text() for n in names), path
