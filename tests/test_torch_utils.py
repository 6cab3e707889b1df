"""PyTorch port, ``utils`` (run records, checkpoints, timing),
``inference/introspect.py`` and ``inference/validate.py`` and
``examples/plot_1d.py``, against the JAX package on the CPU (f64)."""

import os
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gaussianvi_tpu.examples import build_barfoot_1d as jax_barfoot  # noqa: E402
from gaussianvi_tpu.examples import run_barfoot_1d as jax_run_barfoot  # noqa: E402
from gaussianvi_tpu.examples.chain_estimation import (  # noqa: E402
    build_chain_estimation as jax_chain,
)
from gaussianvi_tpu.inference import GVIConfig as JaxConfig  # noqa: E402
from gaussianvi_tpu.inference import optimize as jax_optimize  # noqa: E402
from gaussianvi_tpu.inference.introspect import (  # noqa: E402
    factor_expectations as jax_expectations,
)
from gaussianvi_tpu.utils import cost_map_1d as jax_cost_map  # noqa: E402
from gaussianvi_tpu.utils import save_history_csv as jax_save_csv  # noqa: E402
from gaussianvi_tpu_torch.examples import (  # noqa: E402
    build_barfoot_1d,
    build_chain_estimation,
    run_barfoot_1d,
)
from gaussianvi_tpu_torch.factors import make_nonlinear_batch  # noqa: E402
from gaussianvi_tpu_torch.inference import (  # noqa: E402
    FactorGraph,
    GVIConfig,
    GVIHistory,
    optimize,
    validate_graph,
)
from gaussianvi_tpu_torch.inference.introspect import (  # noqa: E402
    factor_expectations,
    marginals,
)
from gaussianvi_tpu_torch.utils import (  # noqa: E402
    Timer,
    cost_map_1d,
    history_to_arrays,
    save_costmap,
    save_factor_expectations,
    save_history_csv,
    time_fn,
    trace,
)

CPU = torch.device("cpu")
CSV_SET = ("mean", "cov", "precision", "joint_cov", "joint_precision",
           "cost", "factor_costs", "zk_sdf", "Sk_sdf", "cov_off", "prec_off",
           "accepted_step")


def _as_port_history(jhist):
    return GVIHistory(*(torch.as_tensor(np.array(x)) for x in jhist))


@pytest.mark.parametrize("case", ["barfoot", "chain"])
def test_history_csv_is_the_jax_packages_byte_for_byte(tmp_path, case):
    """The same history written by both packages: the same files, byte for
    byte (the reference recorder's layout, iterations as columns, the
    dense joint matrices included); the port's own run writes the same
    numbers."""
    if case == "barfoot":
        _, jhist = jax_run_barfoot("ngd")
        _, hist = run_barfoot_1d("ngd", device=CPU)
    else:
        jg, ji, _ = jax_chain(num_states=4, dim_x=1, gh_degree=3, seed=0)
        _, jhist = jax_optimize(jg, ji, JaxConfig(niters=3))
        g, i, _ = build_chain_estimation(num_states=4, dim_x=1, gh_degree=3,
                                         seed=0, device=CPU)
        _, hist = optimize(g, i, GVIConfig(niters=3))
    want = jax_save_csv(jhist, str(tmp_path / "jax"))
    got = save_history_csv(_as_port_history(jhist), str(tmp_path / "port"))
    assert [os.path.basename(p) for p in got] == [os.path.basename(p)
                                                  for p in want]
    assert {os.path.basename(p)[:-4] for p in got} == set(CSV_SET)
    for a, b in zip(got, want):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), a
    own = history_to_arrays(hist)
    for name, arr in history_to_arrays(_as_port_history(jhist)).items():
        np.testing.assert_allclose(own[name], arr, rtol=1e-9, atol=1e-12)


def test_batched_history_is_refused():
    g, i, _ = build_chain_estimation(num_states=4, dim_x=1, gh_degree=3,
                                     device=CPU)
    _, hist = optimize(g, i, GVIConfig(niters=2))
    batched = GVIHistory(*(x[None] for x in hist))
    with pytest.raises(ValueError, match="one problem"):
        history_to_arrays(batched)
    history_to_arrays(GVIHistory(*(x[0] for x in batched)))


# spot values of the reference's committed data/1d/costmap.csv
# (tests/test_utils.py TestCostMap)
REF_SPOTS = {(0, 0): 12.2608693535343, (0, 1): 11.4579425558707,
             (1, 0): 11.9455399286534, (5, 7): 4.57490741640722,
             (20, 20): 2.47130490711575, (38, 39): 2.30464737169775}


def test_cost_map_1d_matches_jax_and_the_reference(tmp_path):
    graph = build_barfoot_1d(device=CPU)[0]
    z = cost_map_1d(graph, nmesh=40)
    assert z.shape == (40, 40)
    np.testing.assert_allclose(z, jax_cost_map(jax_barfoot()[0], nmesh=40),
                               rtol=1e-12)
    for (j, i), val in REF_SPOTS.items():
        np.testing.assert_allclose(z[j, i], val, rtol=1e-9)
    path = save_costmap(graph, str(tmp_path / "map" / "costmap.csv"),
                        nmesh=8)
    assert np.loadtxt(path, delimiter=",").shape == (8, 8)


def test_factor_expectations_match_jax(tmp_path):
    jg, ji, _ = jax_chain(num_states=6, dim_x=2, gh_degree=4, seed=1)
    jstate, _ = jax_optimize(jg, ji, JaxConfig(niters=2))
    g, i, _ = build_chain_estimation(num_states=6, dim_x=2, gh_degree=4,
                                     seed=1, device=CPU)
    state, _ = optimize(g, i, GVIConfig(niters=2))
    want = jax_expectations(jg, jstate)
    got = factor_expectations(g, state)
    assert len(got) == len(want) == 1
    for key in ("e_phi", "e_xmu_phi", "e_xmumu_phi"):
        np.testing.assert_allclose(got[0][key].numpy(),
                                   np.asarray(want[0][key]), rtol=1e-9,
                                   atol=1e-12)
    mu, cov = marginals(g, state)
    assert mu is state.mu and cov.shape == (6, 4, 4)
    paths = save_factor_expectations(g, state, str(tmp_path / "fx"))
    assert len(paths) == 3
    np.testing.assert_allclose(np.loadtxt(paths[0], delimiter=","),
                               got[0]["e_phi"].numpy(), rtol=1e-11)


def _square(x, p):
    return torch.sum(x**2, dim=-1)


def _scaled(x, p):
    return torch.sum(x**2, dim=-1) * p["a"]


def _batch(start, state_dim, **kw):
    return make_nonlinear_batch(_square, start, state_dim=state_dim,
                                gh_degree=3, device=CPU, **kw)


def _bad_start():
    return FactorGraph(num_states=3, state_dim=1, nonlinear=(_batch([5], 1),))


def _bad_param_axis():
    fb = make_nonlinear_batch(_scaled, [0, 1], state_dim=1, gh_degree=3,
                              params={"a": torch.ones(3, dtype=torch.float64)},
                              device=CPU)
    return FactorGraph(num_states=2, state_dim=1, nonlinear=(fb,))


def _dim_mismatch():
    return FactorGraph(num_states=2, state_dim=4, nonlinear=(_batch([0], 2),))


def _bad_slice_offset():
    fb = _batch([0, 1, 2], 1)
    assert fb.slice_offset == 0
    # start says [0, 1, 2], slice_offset claims 1: gathers and scatters
    # would read and write the wrong state blocks
    return FactorGraph(num_states=4, state_dim=1,
                       nonlinear=(replace(fb, slice_offset=1),))


def _slice_out_of_range():
    fb = replace(_batch([2, 3, 4], 1), slice_offset=2)
    return FactorGraph(num_states=4, state_dim=1, nonlinear=(fb,))


@pytest.mark.parametrize("build,match", [
    (_bad_start, "start indices"),
    (_bad_param_axis, "param leaf leading axis"),
    (_dim_mismatch, "quadrature dim"),
    (_bad_slice_offset, "slice_offset"),
    (_slice_out_of_range, "start indices|slice_offset"),
])
def test_validate_graph_rejects_bad_wiring(build, match):
    """``tests/test_validate_graph.py``'s malformed graphs, built in the
    port: the same errors."""
    with pytest.raises(ValueError, match=match):
        validate_graph(build())


def test_validate_graph_passes_valid_graphs():
    """The examples' graphs pass, with their states, one problem and a
    stacked batch (its leaves carry the problem axis first)."""
    from gaussianvi_tpu_torch import stack_problems

    for builder in (build_barfoot_1d, build_chain_estimation):
        graph, state = builder(device=CPU)[:2]
        validate_graph(graph, state)
    probs = [build_chain_estimation(num_states=5, seed=s, device=CPU)[:2]
             for s in range(2)]
    graph, state = stack_problems([p[0] for p in probs],
                                  [p[1] for p in probs])
    validate_graph(graph, state)
    with pytest.raises(ValueError, match="state.mu"):
        validate_graph(probs[0][0], replace(probs[0][1],
                                            mu=probs[0][1].mu[:, :1]))


def test_timer_time_fn_and_trace(tmp_path):
    """On the CPU: the timer and best-of-N timing measure a call, the
    trace writes a Chrome trace of the block."""
    x = torch.ones(64, 64, dtype=torch.float64)
    t = Timer()
    y = x @ x
    assert t.elapsed_ms(y) >= 0.0
    assert 0.0 < time_fn(lambda a: a @ a, x, repeats=3) < 10.0
    with trace(str(tmp_path / "tr")):
        x @ x
    path = tmp_path / "tr" / "trace.json"
    assert path.exists() and path.stat().st_size > 0


def test_plot_1d(tmp_path):
    """The 1-D example's plot (matplotlib, imported only here)."""
    pytest.importorskip("matplotlib")
    from gaussianvi_tpu_torch.examples.plot_1d import main

    out = main(str(tmp_path / "plot.png"), device=CPU)
    assert os.path.getsize(out) > 0
