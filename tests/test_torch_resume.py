"""PyTorch port, checkpoint / resume (``optimize_from``, ``LoopState``,
``utils/checkpoint.py``): the three cases of ``tests/test_resume.py`` on
the port, with the JAX package's tolerances (bit for bit where it asserts
it), a batch's per-problem loop values, and checkpoints carried across the
packages: a JAX-written file resumed by the port against JAX's
uninterrupted run, and a port-written one read by the JAX package (CPU,
f64)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gaussianvi_tpu.examples.chain_estimation import (  # noqa: E402
    build_chain_estimation as jax_build,
)
from gaussianvi_tpu.inference import GVIConfig as JaxConfig  # noqa: E402
from gaussianvi_tpu.inference import optimize_from as jax_optimize_from  # noqa: E402
from gaussianvi_tpu.utils import load_loop_state as jax_load  # noqa: E402
from gaussianvi_tpu.utils import save_checkpoint as jax_save  # noqa: E402
from gaussianvi_tpu_torch.examples.chain_estimation import (  # noqa: E402
    build_chain_estimation,
)
from gaussianvi_tpu_torch.inference import (  # noqa: E402
    GVIConfig,
    LoopState,
    optimize,
    optimize_from,
)
from gaussianvi_tpu_torch.utils import (  # noqa: E402
    load_checkpoint,
    load_loop_state,
    save_checkpoint,
)

CPU = torch.device("cpu")


def _chain():
    return build_chain_estimation(num_states=6, dim_x=1, gh_degree=4,
                                  device=CPU)[:2]


def _same(a, b, rtol=0.0):
    if rtol == 0.0:
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    else:
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol, atol=0)


def test_resume_matches_uninterrupted(tmp_path):
    """No switch inside the window: (state, temperature, is_lowtemp) carry
    the run; the second half through ``optimize`` from the loaded state."""
    graph, init = _chain()
    full_cfg = GVIConfig(niters=8, niters_lowtemp=100, step_size_base=0.9)
    final_full, hist_full = optimize(graph, init, full_cfg)
    half_cfg = GVIConfig(niters=4, niters_lowtemp=100, step_size_base=0.9)
    mid, _ = optimize(graph, init, half_cfg)
    path = str(tmp_path / "ck")
    save_checkpoint(path, mid, iteration=4, temperature=1.0, is_lowtemp=True)
    state, it, temp, low = load_checkpoint(path, device=CPU)
    assert (it, temp, low) == (4, 1.0, True)
    final_res, hist_res = optimize(graph, state, half_cfg)
    np.testing.assert_allclose(final_res.mu.numpy(), final_full.mu.numpy(),
                               atol=1e-10)
    np.testing.assert_allclose(final_res.precision.diag.numpy(),
                               final_full.precision.diag.numpy(), atol=1e-9)
    np.testing.assert_allclose(hist_res.cost.numpy(),
                               hist_full.cost[4:].numpy(), atol=1e-10)


def test_full_state_resume_across_temperature_switch(tmp_path):
    """The window straddles the scheduled switch and reaches the
    convergence freeze, so every loop value changes; the resumed run is
    the uninterrupted one: 5e-14 relative (the resumed run's carried
    costs come from another batch shape), the same accepted steps."""
    graph, init = _chain()
    cfg = GVIConfig(niters=24, niters_lowtemp=4, high_temperature=8.0,
                    step_size_base=0.9)
    final_full, hist_full, loop_full = optimize_from(graph, init, cfg)
    assert not bool(loop_full.is_lowtemp)
    assert float(loop_full.temperature) == 8.0
    half = GVIConfig(niters=7, niters_lowtemp=4, high_temperature=8.0,
                     step_size_base=0.9)
    mid, hist_half, loop_mid = optimize_from(graph, init, half)
    assert hist_half.cost.shape == (7,)
    path = str(tmp_path / "ck_full")
    save_checkpoint(path, mid, iteration=7,
                    temperature=float(loop_mid.temperature),
                    is_lowtemp=bool(loop_mid.is_lowtemp),
                    converged=bool(loop_mid.converged))
    state, it, loop = load_loop_state(path, device=CPU)
    assert it == 7
    final_res, hist_res, loop_res = optimize_from(
        graph, state, cfg, start_iteration=it, loop_state=loop)
    assert hist_res.cost.shape == (17,)
    _same(final_res.mu, final_full.mu, 5e-14)
    _same(final_res.precision.diag, final_full.precision.diag, 5e-14)
    _same(hist_res.cost, hist_full.cost[7:], 5e-14)
    _same(hist_res.accepted_step, hist_full.accepted_step[7:])
    assert bool(loop_res.converged) == bool(loop_full.converged)


def test_resume_preserves_converged_freeze(tmp_path):
    """Checkpointed after convergence, the resumed run stays frozen: the
    state the same bits as the uninterrupted run's, every step refused.
    The recorded costs are the JAX package's bits there but not the
    port's: the uninterrupted run carries the costs its last accepted
    trial was evaluated with, in the trial batch, and the CPU's batched
    matrix products pick their kernels by batch shape, so the resumed
    run's recomputation at the same state lands ulps away (5e-14, the
    JAX package's tolerance for its own resumed runs)."""
    graph, init = _chain()
    cfg = GVIConfig(niters=40, niters_lowtemp=4, high_temperature=8.0,
                    step_size_base=0.9)
    final_full, hist_full, loop_full = optimize_from(graph, init, cfg)
    assert bool(loop_full.converged)
    half = GVIConfig(niters=30, niters_lowtemp=4, high_temperature=8.0,
                     step_size_base=0.9)
    mid, _, loop_mid = optimize_from(graph, init, half)
    assert bool(loop_mid.converged)
    path = str(tmp_path / "ck_conv")
    save_checkpoint(path, mid, iteration=30, temperature=loop_mid.temperature,
                    is_lowtemp=loop_mid.is_lowtemp,
                    converged=loop_mid.converged)
    state, it, loop = load_loop_state(path, device=CPU)
    final_res, hist_res, _ = optimize_from(graph, state, cfg,
                                           start_iteration=it,
                                           loop_state=loop)
    _same(final_res.mu, final_full.mu)
    _same(final_res.precision.diag, final_full.precision.diag)
    _same(hist_res.mu, hist_full.mu[30:])
    _same(hist_res.accepted_step, hist_full.accepted_step[30:])
    assert not bool(hist_res.accepted_step.any())
    _same(hist_res.cost, hist_full.cost[30:], 5e-14)


def test_batch_checkpoint_keeps_each_problems_loop_values(tmp_path):
    """A batch writes its loop values per problem ([B]); checkpointed at 12
    of 24 iterations, where one problem has converged and the others have
    not (one of them converges later), the resumed batch follows the
    uninterrupted one: the same state bits and steps, costs to 5e-14."""
    from gaussianvi_tpu_torch import stack_problems

    probs = [build_chain_estimation(num_states=6, dim_x=2, gh_degree=4,
                                    seed=seed, device=CPU)[:2]
             for seed in range(4)]
    graph, init = stack_problems([p[0] for p in probs],
                                 [p[1] for p in probs])
    kw = dict(niters_lowtemp=3, high_temperature=8.0, step_size_base=0.9,
              niters_backtrack=2)
    cfg = GVIConfig(niters=24, **kw)
    final_full, hist_full, loop_full = optimize_from(graph, init, cfg)
    mid, _, loop_mid = optimize_from(graph, init, GVIConfig(niters=12, **kw))
    assert loop_mid.converged.tolist() == [False, False, False, True]
    assert loop_full.converged.tolist() == [False, False, True, True]
    path = save_checkpoint(str(tmp_path / "batch"), mid, 12, *loop_mid)
    state, it, loop = load_loop_state(path, device=CPU)
    assert loop.converged.shape == (4,) and loop.temperature.shape == (4,)
    for a, b in zip(loop, loop_mid):
        _same(a, b)
    final_res, hist_res, loop_res = optimize_from(graph, state, cfg, "ngd",
                                                  it, loop)
    _same(final_res.mu, final_full.mu)
    _same(final_res.precision.diag, final_full.precision.diag)
    _same(hist_res.cost, hist_full.cost[:, 12:], 5e-14)
    _same(hist_res.accepted_step, hist_full.accepted_step[:, 12:])
    for a, b in zip(loop_res, loop_full):
        _same(a, b)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A checkpoint the JAX package writes (scalar loop values, one
    problem) resumed by the port's ``optimize_from`` follows JAX's
    uninterrupted run; the port's file reads back in the JAX package."""
    jgraph, jinit, _ = jax_build(num_states=6, dim_x=1, gh_degree=4)
    jcfg = JaxConfig(niters=10, niters_lowtemp=4, high_temperature=8.0,
                     step_size_base=0.9)
    jfinal, jhist, jloop = jax_optimize_from(jgraph, jinit, jcfg)
    jmid, _, jloop_mid = jax_optimize_from(jgraph, jinit, JaxConfig(
        niters=6, niters_lowtemp=4, high_temperature=8.0, step_size_base=0.9))
    path = jax_save(str(tmp_path / "jax_ck"), jmid, iteration=6,
                    temperature=float(jloop_mid.temperature),
                    is_lowtemp=bool(jloop_mid.is_lowtemp),
                    converged=bool(jloop_mid.converged))
    state, it, loop = load_loop_state(path, device=CPU)
    assert it == 6 and loop.temperature.ndim == 0
    graph, _ = _chain()
    cfg = GVIConfig(niters=10, niters_lowtemp=4, high_temperature=8.0,
                    step_size_base=0.9)
    final, hist, loop_res = optimize_from(graph, state, cfg,
                                          start_iteration=it,
                                          loop_state=loop)
    np.testing.assert_allclose(hist.cost.numpy(), np.asarray(jhist.cost)[6:],
                               rtol=1e-12)
    np.testing.assert_array_equal(hist.accepted_step.numpy(),
                                  np.asarray(jhist.accepted_step)[6:])
    np.testing.assert_allclose(final.mu.numpy(), np.asarray(jfinal.mu),
                               atol=1e-12)
    assert float(loop_res.temperature) == float(jloop.temperature)
    back = save_checkpoint(str(tmp_path / "port_ck"), final, 10, *loop_res)
    jstate, jit_, jl = jax_load(back)
    assert jit_ == 10 and float(jl.temperature) == float(loop_res.temperature)
    np.testing.assert_array_equal(np.asarray(jstate.mu), final.mu.numpy())


def test_an_empty_window_returns_the_state():
    """Resumed at its last iteration, a run takes no step: zero-length
    history, the state and loop values as given."""
    graph, init = _chain()
    cfg = GVIConfig(niters=3)
    loop = LoopState(torch.tensor(10.0, dtype=torch.float64),
                     torch.tensor(False), torch.tensor(True))
    final, hist, loop_res = optimize_from(graph, init, cfg,
                                          start_iteration=3, loop_state=loop)
    assert hist.cost.shape == (0,) and hist.mu.shape == (0, 6, 2)
    _same(final.mu, init.mu)
    assert float(loop_res.temperature) == 10.0 and bool(loop_res.converged)
