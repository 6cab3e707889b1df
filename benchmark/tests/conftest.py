"""Helpers of the benchmark's own tests: a copy of the benchmark at a tiny
size in a temporary directory."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# cells at a size a CPU holds: (config overrides, traffic overrides)
TINY = {
    "chain_est": {"num_states": 5},
    "point3d_plan": {"num_states": 6},
}
TINY_TRAFFIC = {"requests_per_call": 3, "pool_calls": 2, "kept_per_call": 2,
                "checked": 6, "traced_calls": 2}


def make_tiny_root(tmp: Path) -> Path:
    """``tmp`` holding ``BENCHMARK.json`` and a copy of ``benchmark/`` with
    every configuration and traffic cut to a tiny size."""
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_*out*"))
    for name, over in TINY.items():
        p = tmp / "benchmark" / "configs" / f"{name}.json"
        cfg = json.loads(p.read_text())
        cfg.update(over)
        p.write_text(json.dumps(cfg))
    for p in (tmp / "benchmark" / "workloads").glob("*.json"):
        tr = json.loads(p.read_text())
        tr.update(TINY_TRAFFIC)
        if tr["per_request"] > 1:
            tr.update(requests_per_call=2, per_request=2)
        p.write_text(json.dumps(tr))
    return tmp


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)
