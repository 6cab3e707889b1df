"""PyTorch port, the s = 6 instances of the fused kernels K5 (two passes:
K1's layout over the trial chains, then a lane a (trial, problem, state)
item) and K6 (an edge on a lane group, or on a lane, by instance), on the
CPU without a kernel: the block plans the wrappers hand the C entries at
the models' shapes in both dtypes (K5's scratch and grids, K6's problems
per block and work areas, the global-scratch threshold), the wrappers'
copies of the sources' formulas and layout choices, the passes' names,
and the ptxas report's names for the s = 6 kernels."""

from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from gaussianvi_tpu_torch.kernels import _build  # noqa: E402
from gaussianvi_tpu_torch.kernels import chain as tchain  # noqa: E402
from gaussianvi_tpu_torch.kernels import fused_gradient as fg  # noqa: E402
from gaussianvi_tpu_torch.kernels import fused_trials as ft  # noqa: E402

CSRC = Path(ft.__file__).resolve().parent.parent / "csrc"
M = 6 * 6 + 1          # arena words of an s x s block (Pitch::kMat)


def _rules(m, itemsize):
    return m * 7 * itemsize        # nodes [m, 6] and weights [m]


# (N, itemsize, nodes): the point planner (N = 20, 25 nodes) and chain
# estimation at dim_x = 3 (N = 32, 69 nodes)
@pytest.mark.parametrize("n,itemsize,m", [
    (20, 4, 25), (20, 8, 25), (32, 4, 69), (32, 8, 69)])
def test_trial_plan_at_s6_is_k1s_over_every_trial(n, itemsize, m):
    """K5's first pass at s = 6 takes K1's plan (one warp a block, its two
    chains' pivots in shared memory) over all T trials at once; the rules
    go to the second pass alone.  The scratch carries the marginal
    covariance of every state of every trial chain."""
    plan = ft.trial_plan("t", n, 6, 11, itemsize, _rules(m, itemsize))
    k1 = tchain.gbp_plan(n, 6, itemsize)
    assert (plan.warps, plan.chunk, plan.scratch) == (1, 11, False)
    assert (plan.arena, plan.smem) == (k1.arena, k1.smem)
    assert plan.arena == 2 * 2 * tchain.slot_pitch(n * M, 2, itemsize)
    assert plan.smem == plan.arena * itemsize
    b = 1024
    assert ft.trial_scratch_elems(plan, b, n, 6, 11) == (
        ft.trial_s6_block_elems(11 * b, n))
    assert ft.trial_s6_block_elems(11 * b, n) == 11 * b * n * 36


@pytest.mark.parametrize("itemsize,first", [(8, 197), (4, 393)])
def test_trial_plan_at_s6_past_shared_memory(itemsize, first):
    """From the first N whose two chains' pivots pass a block's shared
    memory, the arenas follow the blocks in the scratch, one a warp of
    the first pass."""
    last = ft.trial_plan("t", first - 1, 6, 11, itemsize, _rules(69, itemsize))
    assert not last.scratch and last.smem <= ft.SMEM_LIMIT
    assert ft.trial_scratch_elems(last, 3, first - 1, 6, 11) == (
        ft.trial_s6_block_elems(33, first - 1))
    plan = ft.trial_plan("t", first, 6, 11, itemsize, _rules(69, itemsize))
    assert (plan.scratch, plan.smem, plan.chunk) == (True, 0, 11)
    assert plan.arena * itemsize > ft.SMEM_LIMIT
    warps = ft.trial_s6_grids(3, first, 11)[0]
    assert warps == 17
    assert ft.trial_scratch_elems(plan, 3, first, 6, 11) == (
        ft.trial_s6_block_elems(33, first) + warps * plan.arena)


# (B, N, T) -> blocks of the two passes: two trial chains a warp, the
# (trial, problem, state) items 128 a block; odd chain counts, one problem
@pytest.mark.parametrize("b,n,nt,sweep,costs", [
    (1024, 20, 11, 5632, 1760), (8192, 20, 11, 45056, 14080),
    (3, 33, 11, 17, 9), (1, 2, 1, 1, 1)])
def test_trial_s6_grids(b, n, nt, sweep, costs):
    assert ft.trial_s6_grids(b, n, nt) == (sweep, costs)
    assert sweep == -(-nt * b // tchain.chains_per_warp(6))
    assert costs * ft.TRIAL_COST_THREADS >= nt * b * n > (
        costs - 1) * ft.TRIAL_COST_THREADS


def test_trial_s6_passes_are_named_for_the_roofline():
    """Both passes' entry functions start with ``trials_s6_kernel``, which
    the benchmark's ``trials_roofline.bulk`` matches by prefix, and no
    other kernel of the source is launched."""
    import re

    from benchmark.trace import function_name

    text = (CSRC / "fused_trials_s6.cu").read_text()
    kernels = re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s*"
                         r"(\w+)\(", text)
    assert kernels == ["trials_s6_kernel_sweep", "trials_s6_kernel_costs"]
    launched = re.findall(r"(\w+)(?:<[^<>]*>)?\s*<<<", text)
    assert launched == ["trials_s6_kernel_sweep", "costs"]
    assert "auto costs = trials_s6_kernel_costs<T, Cost>;" in text
    metric = (CSRC.parents[1] / "benchmark" / "metrics"
              / "trials_roofline.bulk.py").read_text()
    assert '"trials_s6_kernel"' in metric
    for name in kernels:
        demangled = f"void gvi::{name}<float, gvi::Sdf3dCost>(float const*)"
        assert function_name(demangled).startswith("trials_s6_kernel")


# (N, s, T, itemsize, rules) -> trials held: below s = 6 the plan is the
# lane-per-item layout's, a block of four warps a problem with as many
# trials as fit shared memory, or a global scratch of one arena a problem
@pytest.mark.parametrize("n,s,nt,itemsize,fixed,chunk,scratch", [
    (32, 4, 11, 4, 580, 11, False), (2000, 4, 11, 4, 580, 11, True)])
def test_trial_plan_below_s6(n, s, nt, itemsize, fixed, chunk, scratch):
    plan = ft.trial_plan("t", n, s, nt, itemsize, fixed)
    assert (plan.warps, plan.chunk, plan.scratch) == (4, chunk, scratch)
    assert plan.arena == ft.trial_arena_elems(n, s, chunk)
    assert ft.trial_scratch_elems(plan, 5, n, s, nt) == (
        5 * plan.arena if scratch else 0)


# (N, itemsize, nodes, cost, mode) -> (K6 problems a block, global
# scratch, lane groups): the two models and the patch mode's point planner
# (85 nodes), the split pair, a long chain in both dtypes
@pytest.mark.parametrize("n,itemsize,m,cost,mode,warps,scratch,groups", [
    (20, 4, 25, "sdf3d", "full", 2, False, True),
    (20, 8, 25, "sdf3d", "full", 1, False, False),
    (20, 4, 25, "sdf3d", "accum", 2, False, True),
    (32, 4, 69, "range", "full", 2, False, False),
    (32, 8, 69, "range", "full", 1, False, False),
    (32, 4, 69, "range", "accum", 2, False, False),
    (32, 4, 0, "range", "solve", 2, False, True),
    (20, 8, 85, "sdf3d_patch", "full", 1, False, True),
    (160, 4, 69, "range", "full", 1, False, False),
    (160, 8, 69, "range", "full", 4, True, False),
    (160, 8, 85, "sdf3d_patch", "accum", 4, True, True)])
def test_grad_plan_at_s6_by_instance(n, itemsize, m, cost, mode, warps,
                                     scratch, groups):
    fixed = _rules(m, itemsize)
    plan = fg.grad_plan("t", n, 6, itemsize, fixed, cost, mode)
    assert fg.grad_groups(6, itemsize, cost, mode) == groups
    chain = fg.grad_chain_elems(n, 6)
    work = fg.grad_work_elems(6) if groups else 0
    assert fg.grad_work_elems(6) == 4 * 6 * 7
    assert chain == n * (6 * M + 4 * 7) == plan.arena
    assert (plan.warps, plan.scratch) == (warps, scratch)
    if scratch:    # the arenas go global, the work areas stay
        assert plan.smem == fixed + 4 * work * itemsize
        assert fixed + (chain + work) * itemsize > ft.SMEM_LIMIT
    else:
        assert plan.smem == fixed + warps * (chain + work) * itemsize
        assert plan.smem <= (ft.SMEM_TARGET if warps > 1 else ft.SMEM_LIMIT)
    # "full" and "accum" of one instance share a layout (their sums must
    # agree bit for bit); no lane groups below s = 6
    if mode != "solve":
        assert fg.grad_groups(6, itemsize, cost, "full") == fg.grad_groups(
            6, itemsize, cost, "accum")
    assert not fg.grad_groups(4, itemsize, cost, mode)


def _source(name):
    return " ".join((CSRC / name).read_text().split())


def test_wrapper_formulas_are_the_sources():
    """The wrappers' copies of the arena, work-area and occupancy formulas
    say what the C entries check (csrc/fused_trials.cuh,
    csrc/fused_trials_s6.cu, csrc/fused_gradient.cuh,
    csrc/fused_gradient_s6.cuh, csrc/fused_s6.cuh)."""
    trials, trials6 = _source("fused_trials.cuh"), _source("fused_trials_s6.cu")
    grad, grad6 = _source("fused_gradient.cuh"), _source("fused_gradient_s6.cuh")
    lanes = _source("fused_s6.cuh")
    assert "return n * 4 * Pitch<S>::kMat;" in trials
    assert ("return trial_stage_elems<S>(n) + chunk * 2 * n * Pitch<S>::kMat;"
            in trials)
    assert "constexpr int kTrialWarps = 4;" in trials
    assert ft.TRIAL_WARPS == 4
    assert "return chains * n * 36;" in trials6
    assert "constexpr int kTrialCostThreads = 128;" in trials6
    assert ft.TRIAL_COST_THREADS == 128
    assert ("warps != 1 || chunk != nt || arena != gbp_warp_elems<T, 6>(n)"
            in trials6)
    assert "sizeof(T) * (size_t)arena <= kMaxSmem;" in trials6
    assert ft.SMEM_LIMIT == 232448 and "kMaxSmem = 232448;" in _source(
        "fused.cuh")
    assert "trials_s6_kernel_sweep<T><<<chain_blocks<6>(chains), kWarp," in (
        trials6)
    assert ("costs<<<(int)((items + kTrialCostThreads - 1) / "
            "kTrialCostThreads), kTrialCostThreads, rules, st>>>") in trials6
    assert ("return n * (6 * Pitch<S>::kMat + 4 * Pitch<S>::kVec);" in grad)
    assert "constexpr int kGroup = 8;" in lanes
    assert "constexpr int kGroups = kWarp / kGroup;" in lanes
    assert "return kGroups * S * (S + 1);" in grad6
    assert ("(scratch == nullptr ? (size_t)warps * chain : 0) + "
            "(size_t)warps * grad_s6_work_elems<6>()") in grad6
    assert fg.grad_work_elems(6) == (32 // 8) * 6 * (6 + 1)


def test_layout_table_is_the_sources():
    """Which K6 instance at s = 6 runs the lane groups: the wrapper's
    table is the source's trait (its block plan follows the layout)."""
    import re

    grad6 = _source("fused_gradient_s6.cuh")
    # one specialization a (dtype, cost, mode)
    names = {"float": 4, "double": 8}
    kinds = {"Sdf3dPatchCost": "sdf3d_patch", "Sdf3dCost": "sdf3d",
             "RangeCost<3>": "range"}
    modes = {"kGradFull": "full", "kGradAccum": "accum", "kGradSolve": "solve"}
    found = {(names[t], kinds[c], modes[m]) for t, c, m in re.findall(
        r"GVI_GRAD_S6_GROUPS\((float|double), (\w+(?:<3>)?), (kGrad\w+)\)",
        grad6)}
    assert found == fg.GRAD_S6_GROUPS


def test_ptxas_report_names_the_s6_kernels(tmp_path, monkeypatch):
    """The s = 6 kernels take no block size argument: the report puts 6
    first in their ``ints``, ahead of the cost's and the mode's, for K5's
    two passes too."""
    lib = tmp_path / "libgvi_kernels_x.so"
    lib.with_suffix(".ptxas").write_text(
        "ptxas info    : Compiling entry function "
        "'_ZN3gvi22trials_s6_kernel_sweepIfEEvPKT_S3_S3_S3_S3_PS1_S4_S4_iii'"
        " for 'sm_90a'\n"
        "ptxas info    : Function properties for x\n"
        "    16 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 168 registers\n"
        "ptxas info    : Compiling entry function "
        "'_ZN3gvi22trials_s6_kernel_costsIdNS_9RangeCostILi3EEEEEvPKT_' for "
        "'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 90 registers\n"
        "ptxas info    : Compiling entry function "
        "'_ZN3gvi22trials_s6_kernel_costsIfNS_9Sdf3dCostEEEvPKT_' for "
        "'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 80 registers\n"
        "ptxas info    : Compiling entry function "
        "'_ZN3gvi14grad_s6_kernelIdNS_9RangeCostILi3EEELi2EEEvPKT_' for "
        "'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 200 registers\n"
        "ptxas info    : Compiling entry function "
        "'_ZN3gvi11grad_kernelIfLi4ENS_9RangeCostILi2EEELi1EEEvPKT_' for "
        "'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 96 registers\n")
    monkeypatch.setattr(_build, "build", lambda: lib)
    rows = _build.ptxas_report()
    assert [(r["kernel"], r["dtype"], r["ints"], r["cost"], r["registers"],
             r["spill_stores"], r["spill_loads"]) for r in rows] == [
        ("trials_s6_kernel_sweep", "float32", [6], None, 168, 4, 8),
        ("trials_s6_kernel_costs", "float64", [6, 3], "range", 90, 0, 0),
        ("trials_s6_kernel_costs", "float32", [6], "sdf3d", 80, 0, 0),
        ("grad_s6_kernel", "float64", [6, 3, 2], "range", 200, 0, 0),
        ("grad_kernel", "float32", [4, 2, 1], "range", 96, 0, 0)]
