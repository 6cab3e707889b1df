"""PyTorch port, how the engine resolves ``"auto"``: per shape and per
batch, as the JAX package does.  The engine is built for the card on CPU
tensors (resolution launches nothing), then the graphs the kernels do not
cover run through ``optimize`` on the CPU against ``jax.vmap(optimize)``
(f64)."""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gaussianvi_tpu.factors.priors import fixed_prior as jax_fixed_prior  # noqa: E402
from gaussianvi_tpu.factors.priors import (  # noqa: E402
    minimum_acc_prior as jax_min_acc_prior,
)
from gaussianvi_tpu.inference import GVIConfig as JaxConfig  # noqa: E402
from gaussianvi_tpu.inference.graph import FactorGraph as JaxGraph  # noqa: E402
from gaussianvi_tpu.inference.graph import GaussianState as JaxState  # noqa: E402
from gaussianvi_tpu.inference.optimize import optimize as jax_optimize  # noqa: E402
from gaussianvi_tpu.ops import BlockTridiag as JaxBlockTridiag  # noqa: E402
from gaussianvi_tpu.parallel.sharding import stack_problems as jax_stack  # noqa: E402
from gaussianvi_tpu_torch import GVIConfig, optimize, stack_problems  # noqa: E402
from gaussianvi_tpu_torch.convert import (  # noqa: E402
    graph_from_arrays,
    state_from_arrays,
)
from gaussianvi_tpu_torch.inference.engine import (  # noqa: E402
    LocalEngine,
    LoopPlan,
)
from test_torch_slice import (  # noqa: E402
    CPU,
    assert_same_run,
    build_chain_estimation,
    describe,
)

CARD = torch.device("cuda")


def _without_kernel_cost(graph):
    """The graph with its range batch given as ``cost_fn`` only."""
    return replace(graph, nonlinear=tuple(
        replace(fb, kernel_cost=None, kernel_params=None)
        for fb in graph.nonlinear))


def _six_dim_problem(n, seed, dim_x=3):
    """An s = 2 dim_x chain (s = 6 by default): a constant-velocity GP
    prior and an anchor, no nonlinear factor."""
    s = 2 * dim_x
    rng = np.random.default_rng(seed)
    mu0 = rng.standard_normal(s)
    graph = JaxGraph(num_states=n, state_dim=s, linear=(
        jax_fixed_prior(0, mu0, 0.01 * np.eye(s)),
        jax_min_acc_prior(np.eye(dim_x), 0.1, n)))
    mu = mu0 + 0.3 * np.cumsum(rng.standard_normal((n, s)), axis=0)
    return graph, JaxState(jnp.asarray(mu),
                           JaxBlockTridiag.identity(n, s, 10.0, jnp.float64))


@pytest.fixture(scope="module")
def graphs():
    """The port's flagship (N = 8), its cost_fn-only variant, an s = 6
    graph and an s = 8 graph (no kernel instance), and the models of the
    benchmark's other cells, the point planner (s = 6) and the arm
    (s = 14), and Barfoot's s = 1 example with their configs, on the
    CPU."""
    from gaussianvi_tpu_torch.examples.arm_planning import build_arm_planning
    from gaussianvi_tpu_torch.examples.barfoot_1d import build_barfoot_1d
    from gaussianvi_tpu_torch.examples.point3d_planning import (
        build_point3d_planning,
    )

    flag = graph_from_arrays(describe(*build_chain_estimation(
        num_states=8, dim_x=2, gh_degree=4, seed=0)[:2])[0], device=CPU)
    six = graph_from_arrays(describe(*_six_dim_problem(8, 0))[0], device=CPU)
    eight = graph_from_arrays(describe(*_six_dim_problem(8, 0, 4))[0],
                              device=CPU)
    point3d, _, point3d_cfg, _ = build_point3d_planning(num_states=6,
                                                        device=CPU)
    arm, _, arm_cfg, _ = build_arm_planning(num_states=4, device=CPU)
    barfoot, _, barfoot_cfg = build_barfoot_1d(device=CPU)
    return {"flagship": flag, "cost_fn only": _without_kernel_cost(flag),
            "s=6": six, "s=8": eight, "point3d": (point3d, point3d_cfg),
            "arm": (arm, arm_cfg), "barfoot": (barfoot, barfoot_cfg)}


def _routes(eng, config, method="ngd"):
    """Whether the chain takes its kernels, each nonlinear batch's
    quadrature route and the loop's plan."""
    return (eng.chain_impl == "lanes", eng.quad_batches,
            eng.plan(config, method))


KERNELS = LoopPlan("fused", "fused", None, True)
PLAIN = LoopPlan("separate", "separate", None, False)


@pytest.mark.parametrize("name,fields,method,want", [
    # every kernel covers the flagship: K5, K6, the loop captured
    ("flagship", {}, "ngd", (True, (True,), KERNELS)),
    # no functor: the batch takes the plain quadrature, the fused kernels
    # (which need one) stay off; the chain keeps its kernels
    ("cost_fn only", {}, "ngd", (True, (False,), PLAIN)),
    # s = 6: the chain kernels and, without a nonlinear batch, both fused
    # kernels (K5, K6 "full") cover it
    ("s=6", {}, "ngd", (True, (), KERNELS)),
    # the fused kernels are gated on the quadrature alone
    ("flagship", dict(chain_impl="seq", quad_impl="lanes",
                      fused_gradient="on"), "ngd",
     (False, (True,), KERNELS)),
    ("flagship", dict(chain_impl="seq"), "ngd", (False, (False,), PLAIN)),
    ("flagship", dict(quad_impl="xla"), "ngd", (True, (False,), PLAIN)),
    # the cells' models under their own configs: the point planner takes
    # K5 and K6 at s = 6; the arm at s = 14 K1's trial form and the
    # separate gradient, both captured
    ("point3d", {}, "ngd", (True, (True,), KERNELS)),
    ("arm", {}, "ngd",
     (True, (True,), LoopPlan("chain", "separate", None, True))),
    # Barfoot at s = 1: K1 / K2, the plain quadrature (no functor), eager
    ("barfoot", {}, "ngd", (True, (False,), PLAIN)),
    # prox: K5 where the run rounds as the config, the JKO gradient, eager
    ("flagship", {}, "prox",
     (True, (True,), LoopPlan("fused", "prox", None, False))),
    # the sequential search: the separate trials one after another, eager
    ("flagship", dict(linesearch="seq"), "ngd",
     (True, (True,), LoopPlan("seq", "fused", None, False))),
    # float16 offsets: the plain quadrature's rounding, no fused kernel
    ("flagship", dict(moments_eval_dtype="float16"), "ngd",
     (True, (True,), LoopPlan("separate", "separate", torch.float16,
                              False))),
])
def test_auto_resolves_per_shape_and_batch(graphs, name, fields, method,
                                           want):
    """``LocalEngine`` for the card resolves each kernel family where it
    covers the graph, and the loop's plan from them, without launching
    anything."""
    graph, config = (graphs[name] if isinstance(graphs[name], tuple)
                     else (graphs[name], GVIConfig()))
    config = replace(config, **fields)
    assert _routes(LocalEngine(graph, config, CARD), config, method) == want


def test_nonlinear_pair_batches_take_the_plain_quadrature(graphs):
    """A nonlinear batch spanning two states has no quadrature kernel:
    ``"auto"`` takes the plain version for it, ``"lanes"`` raises."""
    g = graphs["flagship"]
    pair = replace(g, nonlinear=(replace(g.nonlinear[0], nb=2),))
    eng = LocalEngine(pair, GVIConfig(), CARD)
    assert _routes(eng, GVIConfig()) == (True, (False,), PLAIN)
    assert not eng.fused_trials_ready and not eng.fused_gradient_ready
    with pytest.raises(ValueError, match="nb=2"):
        LocalEngine(pair, GVIConfig(quad_impl="lanes"), CARD)


@pytest.mark.parametrize("name,fields,match", [
    ("s=8", dict(chain_impl="lanes"), "block size s=8"),
    ("s=8", dict(fused_trials="on"), "fused_trials='on'"),
    ("cost_fn only", dict(quad_impl="lanes"), "kernel_cost"),
    ("cost_fn only", dict(fused_gradient="on"), "kernel_cost"),
    ("flagship", dict(chain_impl="seq", fused_gradient="on"),
     "forces the plain quadrature"),
])
def test_lanes_and_on_raise_for_what_no_kernel_covers(graphs, name, fields,
                                                      match):
    with pytest.raises(ValueError, match=match):
        LocalEngine(graphs[name], GVIConfig(**fields), CARD)


def test_fused_trials_need_the_batched_search(graphs):
    """``fused_trials="auto"`` with the sequential search keeps the
    separate trials (``"on"`` raises: ``check_config``)."""
    cfg = GVIConfig(linesearch="seq")
    eng = LocalEngine(graphs["flagship"], cfg, CARD)
    assert not eng.fused_trials_ready and eng.fused_gradient_ready
    assert eng.plan(cfg, "ngd").trials == "seq"


CFG = dict(niters=4, niters_lowtemp=2, step_size_base=0.9)


def _matches_jax(problems, port_graph=lambda g: g):
    """``optimize`` on the CPU under the defaults against
    ``jax.vmap(optimize)`` on four problems; ``port_graph`` edits the
    port's stacked graph."""
    graph_b, state_b = jax_stack([p[0] for p in problems],
                                 [p[1] for p in problems])
    jcfg = JaxConfig(**CFG)
    jstate, jhist = jax.jit(jax.vmap(
        lambda g, s: jax_optimize(g, s, jcfg)))(graph_b, state_b)
    described = [describe(g, s) for g, s in problems]
    graph, state0 = stack_problems(
        [graph_from_arrays(d, device=CPU) for d, _ in described],
        [state_from_arrays(s, device=CPU) for _, s in described])
    state, hist = optimize(port_graph(graph), state0, GVIConfig(**CFG))
    assert_same_run(jstate, jhist, state, hist, CFG["niters"])


def test_cost_fn_only_graph_matches_jax():
    """A range batch without a functor runs under the defaults with the
    JAX package's result (on the CPU the JAX package takes its default
    path, which reads ``cost_fn`` too)."""
    _matches_jax([build_chain_estimation(num_states=6, dim_x=2, gh_degree=4,
                                         seed=seed)[:2] for seed in range(4)],
                 _without_kernel_cost)


def test_six_dim_chain_matches_jax():
    """An s = 6 chain under the defaults (the plain routes on the CPU)."""
    _matches_jax([_six_dim_problem(6, seed) for seed in range(4)])


@pytest.mark.parametrize("interp,want", [
    # the gather names the planar SDF functor: every kernel covers it
    ("auto", (True, (True,), KERNELS)),
    ("gather", (True, (True,), KERNELS)),
    # the hat-function matmul is a cost_fn-only batch: the plain
    # quadrature, the fused kernels off, the chain kernels on
    ("matmul", (True, (False,), PLAIN)),
])
def test_planner_resolves_per_batch(interp, want):
    """The planar planner built for the card resolves to the chain kernels
    (s = 4), K3 for its obstacle batch and the fused K5 / K6; its
    ``interp="matmul"`` variant to the plain quadrature.  ``"lanes"`` and
    ``"on"`` raise for the variant no kernel covers."""
    from gaussianvi_tpu_torch.examples.planar_planning import (
        build_planar_planning,
    )

    graph, _, config, _ = build_planar_planning(num_states=6, interp=interp,
                                                device=CPU)
    assert _routes(LocalEngine(graph, config, CARD), config) == want
    if interp == "matmul":
        for fields in (dict(quad_impl="lanes"), dict(fused_trials="on")):
            with pytest.raises(ValueError, match="kernel_cost"):
                LocalEngine(graph, replace(config, **fields), CARD)
    # a field the kernels cannot take keeps the batch on the plain routes
    if interp == "gather":
        bad = replace(graph, nonlinear=(replace(
            graph.nonlinear[0],
            kernel_field=graph.nonlinear[0].kernel_field.float()),))
        assert _routes(LocalEngine(bad, config, CARD), config) == (
            True, (False,), PLAIN)


def _s6_model(name):
    """The three models at s = 6, built for the card on the CPU."""
    if name == "point3d":
        from gaussianvi_tpu_torch.examples.point3d_planning import (
            build_point3d_planning,
        )

        graph, _, config, _ = build_point3d_planning(num_states=6,
                                                     device=CPU)
        return graph, config
    if name == "quadrotor":
        from gaussianvi_tpu_torch.examples.quadrotor_planning import (
            build_quadrotor_planning,
        )

        graph, _, config, _ = build_quadrotor_planning(num_states=6,
                                                       device=CPU)
        return graph, config
    from gaussianvi_tpu_torch.examples.chain_estimation import (
        build_chain_estimation as port_build,
    )

    graph, _, config = port_build(num_states=6, dim_x=3, gh_degree=4,
                                  device=CPU)
    return graph, config


@pytest.mark.parametrize("name,want", [
    # the 3-D point planner names the "sdf3d" functor: every kernel
    ("point3d", (True, (True,), KERNELS)),
    # chain estimation at dim_x = 3: the range functor at d = 6
    ("dim_x=3", (True, (True,), KERNELS)),
    # the quadrotor's five balls are cost_fn only, as in JAX: the chain
    # kernels (K1 / K2) and the plain quadrature, no fused kernel
    ("quadrotor", (True, (False,), PLAIN)),
])
def test_s6_models_resolve(name, want):
    """``"auto"`` on the card at s = 6: the planners and chain estimation
    at dim_x = 3 take every kernel that covers them; ``"lanes"`` / ``"on"``
    raise for the quadrotor's cost_fn-only batch with the reason."""
    graph, config = _s6_model(name)
    assert _routes(LocalEngine(graph, config, CARD), config) == want
    if name == "quadrotor":
        for fields in (dict(quad_impl="lanes"), dict(fused_trials="on"),
                       dict(fused_gradient="on")):
            with pytest.raises(ValueError, match="kernel_cost"):
                LocalEngine(graph, replace(config, **fields), CARD)


@pytest.mark.parametrize("fp,want", [(1, ("full",)), (2, ("accum", "solve"))])
def test_s6_factor_parallel_gradient(fp, want):
    """K6's split pair (``accum`` / ``solve``) is instantiated at s = 6: a
    factor-parallel engine with fp >= 2 takes it there under ``"auto"``
    beside K5, as the JAX engine builds the pair for any s, and
    ``fused_gradient="on"`` builds; with fp = 1 it runs K6 ``full``."""
    from types import SimpleNamespace

    from gaussianvi_tpu_torch.parallel.sharding import FactorShardEngine

    graph, config = _s6_model("point3d")
    mesh = SimpleNamespace(fp=fp)
    eng = FactorShardEngine(graph, config, CARD, mesh)
    assert eng.fused_trials_ready and eng.fused_gradient_ready
    assert eng.gradient_modes == want
    on = FactorShardEngine(graph, replace(config, fused_gradient="on"), CARD,
                           mesh)
    assert on.fused_gradient_ready and on.gradient_modes == want


@pytest.mark.parametrize("name,method,want", [
    # bfloat16 offsets keep both fused kernels, rounded in the kernels
    (None, "ngd", (True, True)),
    ("bfloat16", "ngd", (True, True)),
    # prox never quantizes: the kernels' bfloat16 rounding does not match
    # its run, so it takes neither fused kernel
    ("bfloat16", "prox", (False, False)),
    # float16 keeps the plain quadrature and no fused kernel
    ("float16", "ngd", (False, False)),
])
def test_eval_dtype_resolves_as_jax(graphs, name, method, want):
    """The fused kernels a run takes under ``moments_eval_dtype`` (the
    engine's plan), resolved for the card on the CPU, against the JAX
    engine's rule (``run_gvi`` takes a fused kernel only where the run's
    eval_dtype is the one the engine built it with), and the rounding the
    run takes, the JAX loop's."""
    from gaussianvi_tpu.inference.engine import LocalEngine as JaxEngine
    from gaussianvi_tpu.inference.optimize import _eval_dtype

    cfg = GVIConfig(moments_eval_dtype=name)
    plan = LocalEngine(graphs["flagship"], cfg, CARD).plan(cfg, method)
    assert (plan.trials == "fused", plan.gradient == "fused") == want
    jg = build_chain_estimation(num_states=8, dim_x=2, gh_degree=4,
                                seed=0)[0]
    jcfg = JaxConfig(chain_impl="lanes", moments_eval_dtype=name)
    jeng = JaxEngine(jg, jcfg)
    jed = _eval_dtype(jcfg, method)
    assert plan.eval_dtype == (None if jed is None
                               else getattr(torch, jnp.dtype(jed).name))
    jax_routes = (jeng.fused_trials_ready and jed == jeng.fused_eval_dtype,
                  method == "ngd" and jeng.fused_gradient_ready
                  and jed == jeng.fused_grad_eval_dtype)
    assert jax_routes == want


@pytest.mark.parametrize("field", ["fused_trials", "fused_gradient"])
def test_fused_on_with_float16_raises_as_jax(graphs, field):
    """``"on"`` with float16 offsets raises ``ValueError`` in both
    packages: the kernels round through bfloat16 only."""
    from gaussianvi_tpu.inference.engine import LocalEngine as JaxEngine

    with pytest.raises(ValueError, match="bfloat16"):
        LocalEngine(graphs["flagship"], GVIConfig(
            moments_eval_dtype="float16", **{field: "on"}), CARD)
    jg = build_chain_estimation(num_states=8, dim_x=2, gh_degree=4,
                                seed=0)[0]
    with pytest.raises(ValueError, match="bfloat16"):
        JaxEngine(jg, JaxConfig(chain_impl="lanes",
                                moments_eval_dtype="float16",
                                **{field: "on"}))
