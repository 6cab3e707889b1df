"""PyTorch port, the s = 6 instances of the fused kernels K5 and K6 (an
edge on a lane group, or on a lane, by instance), on the CPU without a
kernel: the block plans the wrappers hand the C entries at the models'
shapes in both dtypes (trials held at once, blocks per SM, the work
areas, the global-scratch threshold), the wrappers' copies of the
sources' formulas and layout choices, and the ptxas report's names for
the s = 6 kernels."""

from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from gaussianvi_tpu_torch.kernels import _build  # noqa: E402
from gaussianvi_tpu_torch.kernels import fused_gradient as fg  # noqa: E402
from gaussianvi_tpu_torch.kernels import fused_trials as ft  # noqa: E402

CSRC = Path(ft.__file__).resolve().parent.parent / "csrc"
M = 6 * 6 + 1          # arena words of an s x s block (Pitch::kMat)


def _rules(m, itemsize):
    return m * 7 * itemsize        # nodes [m, 6] and weights [m]


# (N, itemsize, nodes) -> trials held: the point planner (N = 20, 25
# nodes) and chain estimation at dim_x = 3 (N = 32, 69 nodes)
@pytest.mark.parametrize("n,itemsize,m,chunk", [
    (20, 4, 25, 7), (20, 8, 25, 7), (32, 4, 69, 3), (32, 8, 69, 3)])
def test_trial_plan_holds_what_lets_its_blocks_share_an_sm(n, itemsize, m,
                                                           chunk):
    fixed = _rules(m, itemsize)
    plan = ft.trial_plan("t", n, 6, 11, itemsize, fixed)
    arena = (4 + 2 * chunk) * n * M
    assert (plan.warps, plan.chunk, plan.scratch) == (4, chunk, False)
    assert plan.arena == arena == ft.trial_arena_elems(n, 6, chunk)
    assert plan.smem == fixed + arena * itemsize
    blocks = ft.TRIAL_S6_BLOCKS[itemsize]
    assert blocks * (plan.smem + ft.BLOCK_RESERVED) <= ft.SM_SMEM
    # one more trial and that many blocks no longer fit
    more = fixed + ft.trial_arena_elems(n, 6, chunk + 1) * itemsize
    assert blocks * (more + ft.BLOCK_RESERVED) > ft.SM_SMEM


def test_trial_plan_at_s6_past_its_target_and_past_shared_memory():
    # N = 80 in float64: one trial past the two-block target, two fit a
    # block alone; N = 160: not one trial fits, the arena goes global with
    # every trial held
    fixed = _rules(69, 8)
    plan = ft.trial_plan("t", 80, 6, 11, 8, fixed)
    assert fixed + ft.trial_arena_elems(80, 6, 1) * 8 > ft.trial_smem_target(
        6, 8)
    assert (plan.chunk, plan.scratch) == (2, False)
    assert plan.smem <= ft.SMEM_LIMIT < fixed + ft.trial_arena_elems(
        80, 6, 3) * 8
    plan = ft.trial_plan("t", 160, 6, 11, 8, fixed)
    assert (plan.chunk, plan.scratch, plan.smem) == (11, True, fixed)
    assert plan.arena == ft.trial_arena_elems(160, 6, 11)
    # the lane-per-item layout (below s = 6) may take all of shared memory
    assert ft.trial_smem_target(4, 4) == ft.SMEM_LIMIT
    assert ft.trial_plan("t", 32, 4, 11, 4, 580).chunk == 11


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
    blocks = ft.TRIAL_S6_BLOCKS
    assert (f"value = sizeof(T) == 4 ? {blocks[4]} : {blocks[8]};" in trials6)
    assert "arena != trial_arena_elems<6>(n, chunk)" in trials6
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
    first in their ``ints``, ahead of the cost's and the mode's."""
    lib = tmp_path / "libgvi_kernels_x.so"
    lib.with_suffix(".ptxas").write_text(
        "ptxas info    : Compiling entry function "
        "'_ZN3gvi16trials_s6_kernelIfNS_9Sdf3dCostEEEvPKT_' for 'sm_90a'\n"
        "ptxas info    : Function properties for x\n"
        "    16 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 128 registers\n"
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
        ("trials_s6_kernel", "float32", [6], "sdf3d", 128, 4, 8),
        ("grad_s6_kernel", "float64", [6, 3, 2], "range", 200, 0, 0),
        ("grad_kernel", "float32", [4, 2, 1], "range", 96, 0, 0)]
