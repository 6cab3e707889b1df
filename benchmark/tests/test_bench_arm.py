"""The arm planner's configuration (``configs/arm_plan.json``, family
``families/arm_sdf.py``, reference ``reference/arm_sdf.py``) on the CPU at
2 requests x 2 restarts of N = 10: the reference against the program in
float64, the comparison on the float32 program, the batched graph against
the stacked problems, planted faults, and the cell end to end through the
harness."""

import copy
import json
from dataclasses import replace

import numpy as np
import pytest
import torch

from benchmark import judge
from benchmark.families import arm_sdf
from benchmark.harness import GVI_FIELDS, run_cell
from benchmark.reference import dense_gvi
from benchmark.traffic import seed_seq

from conftest import REPO
from test_bench_reference import _leaves

CFG = json.loads((REPO / "benchmark" / "configs" / "arm_plan.json")
                 .read_text())
REQUESTS, PER = 2, 2
F32_EPS = torch.finfo(torch.float32).eps


def _inputs(seed):
    shared = arm_sdf.make_shared(CFG)
    return shared, arm_sdf.make_inputs(CFG, seed_seq(seed, 0, 0), REQUESTS,
                                       PER)


def _state(inputs, dtype):
    from gaussianvi_tpu_torch.convert import state_from_arrays

    p, n, s = inputs["init_mu"].shape
    return state_from_arrays({
        "mu": inputs["init_mu"],
        "prec_diag": np.broadcast_to(np.eye(s) * CFG["init_prec_scale"],
                                     (p, n, s, s)),
        "prec_off": np.zeros((p, n - 1, s, s))}, dtype, "cpu")


def _program(graph, inputs, dtype):
    from gaussianvi_tpu_torch.inference.config import GVIConfig
    from gaussianvi_tpu_torch.inference.optimize import optimize

    state = _state(inputs, dtype)
    final, hist = optimize(graph, state, GVIConfig(
        **{k: CFG["gvi"][k] for k in GVI_FIELDS}))
    return state, final, hist


def _outputs(final, hist):
    return dict(mu=hist.mu, prec_diag=hist.prec_diag,
                prec_off=hist.prec_off, cost=hist.cost,
                accepted_step=hist.accepted_step, final_mu=final.mu,
                final_prec_diag=final.precision.diag,
                final_prec_off=final.precision.off)


def _verdict(shared, inputs, final, hist, dtype):
    prob = arm_sdf.build_reference(CFG, inputs, F32_EPS, "cpu", shared)
    read = judge.readings(prob, _outputs(final, hist), inputs["init_mu"],
                          CFG["init_prec_scale"],
                          dense_gvi.Schedule.from_config(CFG["gvi"]), dtype,
                          "cpu")
    return judge.verdict(read, CFG["limits"]), read


def test_the_frozen_rule_is_the_programs():
    """The configuration's rule is the program's (7, 2) joint-marginal
    rule over the joint angles, and the program's arm batch names the
    kernel functor on it."""
    from gaussianvi_tpu_torch.factors.base import marginal_rule

    nodes, weights = marginal_rule(14, 7, CFG["gh_degree"])
    np.testing.assert_array_equal(np.asarray(nodes)[:, :7],
                                  CFG["rule"]["nodes"])
    assert not np.asarray(nodes)[:, 7:].any()
    np.testing.assert_array_equal(np.asarray(weights), CFG["rule"]["weights"])
    shared, inputs = _inputs(5)
    fb = arm_sdf.build_problem(CFG, inputs, 0, torch.float64, "cpu",
                               shared).nonlinear[0]
    assert fb.kernel_cost == "arm_sdf" and fb.quad_rdim == 7


def test_reference_follows_the_program_in_float64():
    shared, inputs = _inputs(11)
    graph = arm_sdf.build_program(CFG, inputs, torch.float64, "cpu", shared)
    state, final, hist = _program(graph, inputs, torch.float64)
    prob = arm_sdf.build_reference(CFG, inputs, F32_EPS, "cpu", shared)
    rec, fin = dense_gvi.run(prob, state.mu, state.precision.diag.clone(),
                             state.precision.off.clone(),
                             dense_gvi.Schedule.from_config(CFG["gvi"]))
    torch.testing.assert_close(rec["accepted_step"], hist.accepted_step,
                               rtol=0, atol=0)
    assert (hist.accepted_step > 0).any()
    torch.testing.assert_close(rec["cost"], hist.cost, rtol=1e-10, atol=1e-9)
    torch.testing.assert_close(fin["mu"], final.mu, rtol=1e-8, atol=1e-10)
    torch.testing.assert_close(fin["prec_diag"], final.precision.diag,
                               rtol=1e-8, atol=1e-8)


def test_judge_reads_the_float32_program_within_its_limits():
    shared, inputs = _inputs(12)
    graph = arm_sdf.build_program(CFG, inputs, torch.float32, "cpu", shared)
    _, final, hist = _program(graph, inputs, torch.float32)
    (bad, checks), read = _verdict(shared, inputs, final, hist,
                                   torch.float32)
    assert not bad.any(), checks
    assert read["start"].max() == 0.0


def test_batched_graph_equals_the_stacked_problems():
    """The graph the benchmark hands the program (problem 0's, given every
    problem's own anchors) equals ``batching.stack_problems`` of every
    problem's graph built alone: every leaf, and ``optimize``'s outputs."""
    from gaussianvi_tpu_torch.batching import stack_problems

    shared, inputs = _inputs(13)
    f64 = torch.float64
    batched = arm_sdf.build_program(CFG, inputs, f64, "cpu", shared)
    first = arm_sdf.build_problem(CFG, inputs, 0, f64, "cpu", shared)
    p = inputs["init_mu"].shape[0]
    states = _state(inputs, f64)
    per = [type(states)(states.mu[i], type(states.precision)(
        states.precision.diag[i], states.precision.off[i]))
        for i in range(p)]
    stacked, state = stack_problems([first] + [
        arm_sdf.build_problem(CFG, inputs, i, f64, "cpu", shared, base=first)
        for i in range(1, p)], per)
    a, b = _leaves(batched), _leaves(stacked)
    assert a.keys() == b.keys()
    for key in a:
        if torch.is_tensor(a[key]):
            assert torch.equal(a[key], b[key]), key
        elif callable(a[key]):
            assert a[key].__qualname__ == b[key].__qualname__, key
        else:
            assert a[key] == b[key], key
    from gaussianvi_tpu_torch.inference.config import GVIConfig
    from gaussianvi_tpu_torch.inference.optimize import optimize

    gcfg = GVIConfig(**{k: CFG["gvi"][k] for k in GVI_FIELDS})
    x, y = optimize(batched, state, gcfg), optimize(stacked, state, gcfg)
    for u, v in zip((*x[1], x[0].mu), (*y[1], y[0].mu)):
        assert torch.equal(u, v)


def _without_last_sphere(graph, inputs, shared):
    cfg = copy.deepcopy(CFG)
    for key in ("frames", "centers", "radii"):
        cfg["dh"][key] = cfg["dh"][key][:-1]
    return arm_sdf.build_program(cfg, inputs, torch.float32, "cpu", shared)


def _without_the_lift(graph, inputs, shared):
    return replace(graph, nonlinear=tuple(replace(fb, quad_rdim=None)
                                          for fb in graph.nonlinear))


@pytest.mark.parametrize("fault", [_without_last_sphere, _without_the_lift])
def test_a_planted_fault_reads_incorrect(fault):
    """A program whose arm lost its last sphere, or whose moments leave
    out the marginal rule's lift, reads ``correct`` false against the
    reference."""
    shared, inputs = _inputs(12)
    graph = arm_sdf.build_program(CFG, inputs, torch.float32, "cpu", shared)
    _, final, hist = _program(fault(graph, inputs, shared), inputs,
                              torch.float32)
    (bad, checks), _ = _verdict(shared, inputs, final, hist, torch.float32)
    assert bad.any(), checks


def test_the_cell_runs_end_to_end_on_the_cpu(tiny_root):
    result, code = run_cell(tiny_root, "arm_plan.r1024", 2**33 + 101, 0.2,
                            False, "cpu")
    assert code == 0 and result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"solve_p95_ms", "setup_s"}
    assert set(result["checks"]) == set(CFG["limits"])


def test_a_fall_back_to_the_plain_quadrature_fails_a_card_run(monkeypatch):
    """On the card the cell's check refuses a run in which the program
    resolved an arm batch to the plain quadrature; on the CPU, where the
    plain route is the only one, and with every batch on the kernel, it
    passes."""
    from gaussianvi_tpu_torch import kernels

    monkeypatch.setitem(kernels.QUAD_ROUTE_COUNTS, "kernel", 3)
    monkeypatch.setitem(kernels.QUAD_ROUTE_COUNTS, "plain", 0)
    arm_sdf.kernel_route_held(torch.device("cuda", 0))
    monkeypatch.setitem(kernels.QUAD_ROUTE_COUNTS, "plain", 1)
    arm_sdf.kernel_route_held("cpu")
    with pytest.raises(RuntimeError, match="plain"):
        arm_sdf.kernel_route_held(torch.device("cuda", 0))
