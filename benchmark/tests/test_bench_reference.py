"""The plain reference against the program on the CPU, in float64, at a
tiny size: the whole loop from the same inputs, and the comparison that
decides ``correct`` on the program's outputs."""

import json

import numpy as np
import pytest
import torch

from benchmark import judge
from benchmark.families import point3d_sdf, range_chain
from benchmark.reference import dense_gvi
from benchmark.traffic import seed_seq

from conftest import REPO, TINY

CASES = {"chain_est": (range_chain, 3, 1), "point3d_plan": (point3d_sdf, 2, 2)}


def _setup(name, seed=11):
    fam, requests, per = CASES[name]
    cfg = json.loads((REPO / "benchmark" / "configs" / f"{name}.json")
                     .read_text())
    cfg.update(TINY[name])
    shared = fam.make_shared(cfg)
    inputs = fam.make_inputs(cfg, seed_seq(seed, 0, 0), requests, per)
    return fam, cfg, shared, inputs


def _program(fam, cfg, shared, inputs, dtype):
    from gaussianvi_tpu_torch.convert import state_from_arrays
    from gaussianvi_tpu_torch.inference.config import GVIConfig
    from gaussianvi_tpu_torch.inference.optimize import optimize

    from benchmark.harness import GVI_FIELDS

    graph = fam.build_program(cfg, inputs, dtype, "cpu", shared)
    p, n, s = inputs["init_mu"].shape
    state = state_from_arrays({
        "mu": inputs["init_mu"],
        "prec_diag": np.broadcast_to(np.eye(s) * cfg["init_prec_scale"],
                                     (p, n, s, s)),
        "prec_off": np.zeros((p, n - 1, s, s))}, dtype, "cpu")
    final, hist = optimize(graph, state,
                           GVIConfig(**{k: cfg["gvi"][k] for k in GVI_FIELDS}))
    return state, final, hist


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_follows_the_program_in_float64(name):
    fam, cfg, shared, inputs = _setup(name)
    state, final, hist = _program(fam, cfg, shared, inputs, torch.float64)
    prob = fam.build_reference(cfg, inputs, torch.finfo(torch.float32).eps,
                               "cpu", shared)
    rec, fin = dense_gvi.run(prob, state.mu, state.precision.diag.clone(),
                             state.precision.off.clone(),
                             dense_gvi.Schedule.from_config(cfg["gvi"]))
    torch.testing.assert_close(rec["accepted_step"], hist.accepted_step,
                               rtol=0, atol=0)
    torch.testing.assert_close(rec["cost"], hist.cost, rtol=1e-10, atol=1e-9)
    torch.testing.assert_close(fin["mu"], final.mu, rtol=1e-8, atol=1e-10)
    torch.testing.assert_close(fin["prec_diag"], final.precision.diag,
                               rtol=1e-8, atol=1e-8)
    torch.testing.assert_close(fin["prec_off"], final.precision.off,
                               rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("name", sorted(CASES))
def test_judge_reads_the_float32_program_within_its_limits(name):
    fam, cfg, shared, inputs = _setup(name, seed=12)
    _, final, hist = _program(fam, cfg, shared, inputs, torch.float32)
    out = dict(mu=hist.mu, prec_diag=hist.prec_diag, prec_off=hist.prec_off,
               cost=hist.cost, accepted_step=hist.accepted_step,
               final_mu=final.mu, final_prec_diag=final.precision.diag,
               final_prec_off=final.precision.off)
    prob = fam.build_reference(cfg, inputs, torch.finfo(torch.float32).eps,
                               "cpu", shared)
    read = judge.readings(prob, out, inputs["init_mu"],
                          cfg["init_prec_scale"],
                          dense_gvi.Schedule.from_config(cfg["gvi"]),
                          torch.float32, "cpu")
    bad, checks = judge.verdict(read, cfg["limits"])
    assert not bad.any(), checks
    assert read["start"].max() == 0.0


def _leaves(graph):
    """Every tensor of the graph's factor batches, by path, materialized."""
    from dataclasses import fields

    out = {}
    for kind in ("nonlinear", "linear"):
        for i, fb in enumerate(getattr(graph, kind)):
            for f in fields(fb):
                v = getattr(fb, f.name)
                items = v.items() if isinstance(v, dict) else [("", v)]
                for k, x in items:
                    key = (kind, i, f.name, k)
                    out[key] = (x.contiguous() if torch.is_tensor(x) else x)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_batched_graph_equals_the_stacked_problems(name):
    """The graph the benchmark hands the program (problem 0's, given every
    problem's own leaves) equals ``batching.stack_problems`` of every
    problem's graph built alone: every leaf, and the outputs of
    ``optimize`` on each."""
    from gaussianvi_tpu_torch.batching import stack_problems
    from gaussianvi_tpu_torch.convert import state_from_arrays
    from gaussianvi_tpu_torch.inference.config import GVIConfig
    from gaussianvi_tpu_torch.inference.optimize import optimize

    from benchmark.harness import GVI_FIELDS

    fam, cfg, shared, inputs = _setup(name, seed=13)
    f64 = torch.float64
    p, n, s = inputs["init_mu"].shape
    batched = fam.build_program(cfg, inputs, f64, "cpu", shared)
    states = [state_from_arrays({
        "mu": inputs["init_mu"][i], "prec_diag": np.broadcast_to(
            np.eye(s) * cfg["init_prec_scale"], (n, s, s)),
        "prec_off": np.zeros((n - 1, s, s))}, f64, "cpu") for i in range(p)]
    first = fam.build_problem(cfg, inputs, 0, f64, "cpu", shared)
    stacked, state = stack_problems([first] + [
        fam.build_problem(cfg, inputs, i, f64, "cpu", shared, base=first)
        for i in range(1, p)], states)
    a, b = _leaves(batched), _leaves(stacked)
    assert a.keys() == b.keys()
    for key in a:
        if torch.is_tensor(a[key]):
            assert torch.equal(a[key], b[key]), key
        elif callable(a[key]):       # a closure of each build: its field
            assert a[key].__qualname__ == b[key].__qualname__, key
        else:
            assert a[key] == b[key], key
    gcfg = GVIConfig(**{k: cfg["gvi"][k] for k in GVI_FIELDS})
    one, two = optimize(batched, state, gcfg), optimize(stacked, state, gcfg)
    for x, y in zip((*one[1], one[0].mu, one[0].precision.diag),
                    (*two[1], two[0].mu, two[0].precision.diag)):
        assert torch.equal(x, y)


def test_tf32_rounds_to_a_ten_bit_mantissa():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, -3.0 - 2**-9,
                      float("inf"), 1e-30], dtype=torch.float32)
    r = dense_gvi.tf32(x)
    assert r[0] == 1.0 and r[2] == 1.0 + 2**-10 and r[3] == -3.0 - 2**-9
    assert r[1] in (1.0, 1.0 + 2**-10)
    assert torch.isinf(r[4]) and abs(float(r[5]) - 1e-30) < 1e-33
