"""PyTorch port, the samplers (``samplers/{target,hmc,smc,diagnostics,
validate}.py``) against the JAX package (CPU, f64).

``jax.random`` streams cannot be reproduced in PyTorch, so the port's
samplers take each transition's randomness from a draw source
(``samplers/_draws.py``), and these tests hand them the draws JAX makes
from its keys (the key splits of ``gaussianvi_tpu/samplers/{hmc,smc}.py``
replayed here): the samples then agree draw for draw.  The pointwise
density and its autograd gradient are held to JAX's on four graphs.

The draw-for-draw runs use the flagship at N = 4 from small initial steps,
where rounding does not grow: early in the warmup, dual averaging feeds
each accept probability into the next step size (times 20 sqrt(m)), and
trajectories near the leapfrog's stability limit amplify rounding, so some
runs move by more than 1e-10 under a 1e-15 nudge of their initial
position, in the JAX package alone (``run_chains`` below with 20 warmup
transitions: 2.8e-5 in JAX, 5.8e-7 between the packages; with 10, key 13:
3.8e-14 and 1.0e-14).  The runs held here are ones a nudge leaves within
1e-12."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gaussianvi_tpu.examples import build_barfoot_1d as jax_barfoot  # noqa: E402
from gaussianvi_tpu.examples.chain_estimation import (  # noqa: E402
    build_chain_estimation as jax_flagship,
)
from gaussianvi_tpu.examples.planar_planning import (  # noqa: E402
    build_planar_planning as jax_planar,
)
from gaussianvi_tpu.inference.graph import FactorGraph as JaxGraph  # noqa: E402
from gaussianvi_tpu.inference.graph import GaussianState as JaxState  # noqa: E402
from gaussianvi_tpu.ops import BlockTridiag as JaxBlockTridiag  # noqa: E402
from gaussianvi_tpu import samplers as js  # noqa: E402
from gaussianvi_tpu.samplers import validate as jvalidate  # noqa: E402
from gaussianvi_tpu_torch import samplers as ts  # noqa: E402
from gaussianvi_tpu_torch.convert import (  # noqa: E402
    graph_from_arrays,
    state_from_arrays,
)
from gaussianvi_tpu_torch.examples import build_barfoot_1d  # noqa: E402
from gaussianvi_tpu_torch.examples.planar_planning import (  # noqa: E402
    build_planar_planning,
)
from gaussianvi_tpu_torch.inference.graph import FactorGraph  # noqa: E402
from gaussianvi_tpu_torch.samplers import validate as tvalidate  # noqa: E402
from gaussianvi_tpu_torch.samplers.hmc import _run_hmc, value_and_grad  # noqa: E402
from gaussianvi_tpu_torch.samplers.smc import _run_smc  # noqa: E402
from test_torch_slice import describe  # noqa: E402
from test_validation_harness import small_linear_graph  # noqa: E402

CPU = torch.device("cpu")
F64 = jnp.float64
# the draw-for-draw runs (see the module docstring)
N4, WARMUP, SAMPLES, LEAPFROG, EPS0 = 4, 20, 40, 12, 0.01


def _t(a):
    return torch.tensor(np.array(a))


def _graphs(name):
    """``(jax_graph, port_graph, N, s)``; graphs cross packages through
    ``convert.graph_from_arrays`` where no port builder makes them."""
    if name == "barfoot":
        return jax_barfoot()[0], build_barfoot_1d(device=CPU)[0], 1, 1
    if name == "flagship":
        jg, ji, _ = jax_flagship(num_states=8, dim_x=2, dtype=F64)
        return jg, graph_from_arrays(describe(jg, ji)[0], device=CPU), 8, 4
    if name == "small_linear":
        jg = small_linear_graph()
        ji = JaxState(jnp.zeros((4, 2)), JaxBlockTridiag.identity(4, 2, 1.0))
        return jg, graph_from_arrays(describe(jg, ji)[0], device=CPU), 4, 2
    if name == "planar_sdf":
        jg = jax_planar(num_states=8, dtype=F64)[0]
        return jg, build_planar_planning(num_states=8, device=CPU)[0], 8, 4
    raise KeyError(name)


def _flagship4():
    jg, ji, _ = jax_flagship(num_states=N4, dim_x=2, dtype=F64)
    return jg, graph_from_arrays(describe(jg, ji)[0], device=CPU), np.asarray(
        ji.mu).reshape(-1)


@pytest.mark.parametrize("name", ["barfoot", "flagship", "small_linear",
                                  "planar_sdf"])
def test_neg_log_prob_and_gradient_match_jax(name):
    """psi(x) and the gradient of make_log_density at a batch of points
    (the port's leading axis; JAX vmapped) equal JAX's value and
    ``jax.grad`` to 1e-12 of their scale."""
    jg, tg, n, s = _graphs(name)
    rng = np.random.default_rng(5)
    base = {"barfoot": 22.0, "planar_sdf": 4.0}.get(name, 0.5)
    x = base + rng.standard_normal((6, n, s))
    want = np.asarray(jax.vmap(lambda xx: js.neg_log_prob(jg, xx))(
        jnp.asarray(x)))
    got = ts.neg_log_prob(tg, _t(x))
    assert got.shape == (6,) and np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    # one point without a leading axis, as JAX evaluates it
    np.testing.assert_allclose(ts.neg_log_prob(tg, _t(x[0])).numpy(), want[0],
                               rtol=1e-12)
    theta = x.reshape(6, n * s)
    jgrad = np.asarray(jax.vmap(jax.grad(js.make_log_density(jg, n, s)))(
        jnp.asarray(theta)))
    lp, grad = value_and_grad(ts.make_log_density(tg, n, s), _t(theta))
    np.testing.assert_allclose(lp.numpy(), -want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    np.testing.assert_allclose(grad.numpy(), jgrad, rtol=1e-12,
                               atol=1e-12 * np.abs(jgrad).max())


def test_a_stacked_graph_raises():
    """One problem per graph, as in JAX."""
    from gaussianvi_tpu_torch import stack_problems
    from gaussianvi_tpu_torch.examples import build_chain_estimation

    problems = [build_chain_estimation(num_states=4, dim_x=2, seed=k,
                                       device=CPU)[:2] for k in range(2)]
    graph, _ = stack_problems([p[0] for p in problems],
                              [p[1] for p in problems])
    with pytest.raises(ValueError, match="one problem per graph"):
        ts.neg_log_prob(graph, torch.zeros(3, 4, 4, dtype=torch.float64))


# ---- HMC, draw for draw ----

def jax_hmc_draws(key, transitions, dim):
    """The draws of ``gaussianvi_tpu.samplers.hmc`` from ``key``: the
    standard-normal momenta ``[T, D]`` and accept uniforms ``[T]``."""
    def one(k):
        k1, k2 = jax.random.split(k)
        return (jax.random.normal(k1, (dim,), F64),
                jax.random.uniform(k2, (), F64))
    return jax.jit(jax.vmap(one))(jax.random.split(key, transitions))


class HMCDraws:
    """JAX's HMC draws for the chains: normals ``[C, T, D]``, uniforms
    ``[C, T]``."""

    def __init__(self, normal, uniform):
        self.normal, self.uniform = _t(normal), _t(uniform)

    def hmc(self, t):
        return self.normal[:, t], self.uniform[:, t]


def _assert_same_hmc(got, want):
    np.testing.assert_allclose(got.samples.numpy(), np.asarray(want.samples),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.step_size.numpy(),
                               np.asarray(want.step_size), rtol=1e-12)
    alpha = np.asarray(want.accept_prob)
    np.testing.assert_allclose(got.accept_prob.numpy(), alpha, rtol=0,
                               atol=1e-10)


def test_hmc_draw_for_draw():
    """One chain over 60 transitions (20 of them warmup): samples within
    1e-10, step size within 1e-12 (relative), the same accept decisions."""
    jg, tg, x0 = _flagship4()
    d = x0.shape[0]
    key = jax.random.key(3)
    kw = dict(num_samples=SAMPLES, num_warmup=WARMUP, num_leapfrog=LEAPFROG,
              init_step_size=EPS0)
    want = js.hmc(js.make_log_density(jg, N4, 4), jnp.asarray(x0), key, **kw)
    normal, uniform = jax_hmc_draws(key, WARMUP + SAMPLES, d)
    got = _run_hmc(ts.make_log_density(tg, N4, 4), _t(x0)[None],
                   HMCDraws(normal[None], uniform[None]), SAMPLES, WARMUP,
                   LEAPFROG, EPS0, 0.8, 1.0)
    got = ts.HMCResult(*(x[0] for x in got))
    _assert_same_hmc(got, want)
    # the same accept decisions: a rejected transition repeats its sample
    moved = np.any(np.diff(np.asarray(want.samples), axis=0) != 0, axis=1)
    np.testing.assert_array_equal(
        np.any(np.diff(got.samples.numpy(), axis=0) != 0, axis=1), moved)
    assert 0 < moved.sum() < SAMPLES - 1


def test_run_chains_draw_for_draw():
    """C = 3 chains as one batch against ``jax.vmap`` of the chains, with a
    diagonal inverse mass: per-chain step sizes, the same samples."""
    jg, tg, x0 = _flagship4()
    d = x0.shape[0]
    rng = np.random.default_rng(1)
    init = x0 + 0.02 * rng.standard_normal((3, d))
    inv_mass = np.linspace(0.5, 1.5, d)
    key = jax.random.key(13)
    warmup, samples = 10, 50
    kw = dict(num_samples=samples, num_warmup=warmup, num_leapfrog=LEAPFROG,
              init_step_size=EPS0)
    want = js.run_chains(js.make_log_density(jg, N4, 4), jnp.asarray(init),
                         key, inv_mass=jnp.asarray(inv_mass), **kw)
    normal, uniform = jax.vmap(
        lambda k: jax_hmc_draws(k, warmup + samples, d))(
        jax.random.split(key, 3))
    got = _run_hmc(ts.make_log_density(tg, N4, 4), _t(init),
                   HMCDraws(normal, uniform), samples, warmup, LEAPFROG, EPS0,
                   0.8, _t(inv_mass))
    assert got.samples.shape == (3, samples, d) and got.step_size.shape == (3,)
    _assert_same_hmc(got, want)
    steps = got.step_size.numpy()
    assert len(set(steps.tolist())) == 3


# ---- SMC, draw for draw ----

def jax_smc_draws(key, stages, moves, particles, dim):
    """The draws of ``gaussianvi_tpu.samplers.smc`` for its first
    ``stages`` stages: per stage the resampling uniform, the mutation
    momenta ``[moves, P, D]`` and accept uniforms ``[moves, P]``."""
    def move(k):
        def particle(ki):
            k1, k2 = jax.random.split(ki)
            return (jax.random.normal(k1, (dim,), F64),
                    jax.random.uniform(k2, (), F64))
        return jax.vmap(particle)(jax.random.split(k, particles))

    out, key_c = [], key
    for _ in range(stages):
        key_c, _, k_res, k_mut = jax.random.split(key_c, 4)
        mom, acc = jax.vmap(move)(jax.random.split(k_mut, moves))
        out.append((_t(jax.random.uniform(k_res, ())), _t(mom), _t(acc)))
    return out


class SMCDraws:
    def __init__(self, stages):
        self.stages = stages

    def smc_stage(self, stage, moves):
        u, mom, acc = self.stages[stage]
        assert mom.shape[0] == moves
        return u, mom, acc


def _split_graph(graph, cls):
    """(linear part, nonlinear part) of a one-problem graph."""
    return (cls(num_states=graph.num_states, state_dim=graph.state_dim,
                linear=graph.linear),
            cls(num_states=graph.num_states, state_dim=graph.state_dim,
                nonlinear=graph.nonlinear))


def test_smc_draw_for_draw():
    """Three stages of adaptive SMC from the flagship's linear part (sampled
    exactly through its dense precision) to the whole graph: the same
    particles, temperatures and log evidence."""
    jg, tg, x0 = _flagship4()
    d, p, moves, stages = x0.shape[0], 64, 2, 3
    jref, jdelta = _split_graph(jg, JaxGraph)
    tref, tdelta = _split_graph(tg, FactorGraph)
    # the reference N(m, H^-1): its gradient is -H (x - m), so at 0 and at
    # the unit vectors it gives H m and the columns of H
    eye = torch.eye(d, dtype=torch.float64)
    _, g = value_and_grad(ts.make_log_density(tref, N4, 4),
                          torch.cat([torch.zeros_like(eye[:1]), eye]))
    prec = (g[0] - g[1:]).numpy()
    mean = np.linalg.solve(prec, g[0].numpy())
    chol = np.linalg.cholesky(np.linalg.inv(prec))
    init = mean + np.random.default_rng(2).standard_normal((p, d)) @ chol.T
    key = jax.random.key(4)
    kw = dict(ess_threshold=0.8, mutation_step_size=0.002, mutation_steps=4,
              mutations_per_stage=moves, max_stages=stages)
    want = js.smc_adaptive(js.make_log_density(jref, N4, 4),
                           js.make_log_density(jdelta, N4, 4),
                           jnp.asarray(init), key, **kw)
    got = _run_smc(ts.make_log_density(tref, N4, 4),
                   ts.make_log_density(tdelta, N4, 4), _t(init),
                   SMCDraws(jax_smc_draws(key, stages, moves, p, d)),
                   0.8, kw["mutation_step_size"], kw["mutation_steps"], moves,
                   stages)
    assert int(got.num_stages) == int(want.num_stages) == stages
    np.testing.assert_allclose(got.particles.numpy(),
                               np.asarray(want.particles), rtol=0, atol=1e-10)
    np.testing.assert_array_equal(got.weights.numpy(), np.asarray(want.weights))
    np.testing.assert_allclose(float(got.log_evidence),
                               float(want.log_evidence), rtol=1e-10)


# ---- the public entry points ----

def test_entry_points_take_a_generator_and_follow_the_device():
    """hmc / run_chains / nuts / nuts_chains / smc_adaptive on CPU tensors
    with a CPU generator: shapes, finite samples on the tensors' device,
    the same seed the same bits."""
    def log_density(x):
        return -0.5 * torch.sum((x - 1.0) ** 2 / torch.tensor([1.0, 4.0]),
                                dim=-1)

    def gen(seed):
        return torch.Generator(device="cpu").manual_seed(seed)

    init = torch.zeros(2, dtype=torch.float64)
    chains = torch.zeros(3, 2, dtype=torch.float64)
    kw = dict(num_samples=30, num_warmup=20)
    one = ts.hmc(log_density, init, gen(0), num_leapfrog=4, **kw)
    assert one.samples.shape == (30, 2) and one.accept_prob.shape == (30,)
    assert one.step_size.shape == ()
    again = ts.hmc(log_density, init, gen(0), num_leapfrog=4, **kw)
    assert torch.equal(one.samples, again.samples)
    many = ts.run_chains(log_density, chains, gen(1), num_leapfrog=4, **kw)
    assert many.samples.shape == (3, 30, 2)
    n1 = ts.nuts(log_density, init, gen(2), max_depth=3, **kw)
    assert n1.samples.shape == (30, 2) and n1.mean_accept.shape == ()
    nc = ts.nuts_chains(log_density, chains, gen(3), max_depth=3,
                        tree_method="unrolled", **kw)
    assert nc.samples.shape == (3, 30, 2) and nc.step_size.shape == (3,)
    smc = ts.smc_adaptive(lambda x: -0.5 * torch.sum(x**2, -1),
                          lambda x: -0.5 * torch.sum((x - 1.0) ** 2, -1),
                          torch.randn(32, 2, generator=gen(4),
                                      dtype=torch.float64), gen(5),
                          mutation_step_size=0.3)
    assert smc.particles.shape == (32, 2) and float(smc.weights.sum()) == 1.0
    for x in (one.samples, many.samples, n1.samples, nc.samples,
              smc.particles):
        assert x.device == CPU and bool(torch.isfinite(x).all())
    with pytest.raises(ValueError, match="tree_method"):
        ts.nuts(log_density, init, gen(0), tree_method="recursive", **kw)


# ---- diagnostics and the validation harness ----

def _stacks():
    rng = np.random.default_rng(9)
    walk = np.cumsum(0.3 * rng.standard_normal((4, 200, 3)), axis=1)
    return {
        "iid": rng.standard_normal((4, 200, 3)),
        "autocorrelated": walk,
        "heavy tails": rng.standard_cauchy((3, 150, 2)),
        "one chain off": np.concatenate(
            [rng.standard_normal((3, 120, 2)),
             2.0 + rng.standard_normal((1, 120, 2))]),
    }


@pytest.mark.parametrize("name", sorted(_stacks()))
def test_diagnostics_equal_jax(name):
    """split-R-hat, rank-normalized R-hat, ESS and summarize on fixed
    stacks, from NumPy arrays and from tensors, equal JAX's bit for bit."""
    samples = _stacks()[name]
    for fn in ("split_rhat", "rank_normalized_rhat", "ess"):
        want = getattr(js, fn)(samples)
        np.testing.assert_array_equal(getattr(ts, fn)(samples), want)
        np.testing.assert_array_equal(getattr(ts, fn)(_t(samples)), want)
    want = js.summarize(samples)
    got = ts.summarize(_t(samples))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("sampler", ["hmc", "nuts"])
def test_validate_posterior_report_equals_jax(sampler, monkeypatch):
    """Given the same samples (each package's sampler replaced by one that
    returns them), the report equals JAX's: GVI moments from the chain
    covariance, the sampler's moments, the errors."""
    jg = small_linear_graph()
    ji = JaxState(jnp.zeros((4, 2)), JaxBlockTridiag.identity(4, 2, 1.0))
    tg = graph_from_arrays(describe(jg, ji)[0], device=CPU)
    rng = np.random.default_rng(3)
    a = rng.standard_normal((4, 2, 2))
    diag = a @ np.swapaxes(a, -1, -2) + 3 * np.eye(2)
    off = 0.3 * rng.standard_normal((3, 2, 2))
    mu = rng.standard_normal((4, 2))
    jstate = JaxState(jnp.asarray(mu), JaxBlockTridiag(jnp.asarray(diag),
                                                       jnp.asarray(off)))
    tstate = state_from_arrays(dict(mu=mu, prec_diag=diag, prec_off=off),
                               device=CPU)
    samples = mu.reshape(-1) + rng.standard_normal((500, 8)) @ (
        0.3 * rng.standard_normal((8, 8)))
    seen = {}

    def fake(result_cls, tensor):
        def run(log_density, init, key, num_samples, num_warmup, **kw):
            seen[result_cls] = (float(log_density(init)), num_samples,
                                num_warmup, kw)
            return result_cls(tensor(samples), None, None)
        return run

    monkeypatch.setattr(jvalidate, sampler, fake(
        js.HMCResult if sampler == "hmc" else js.NUTSResult, jnp.asarray))
    monkeypatch.setattr(tvalidate, sampler, fake(
        ts.HMCResult if sampler == "hmc" else ts.NUTSResult, _t))
    want = js.validate_posterior(jg, jstate, jax.random.key(0),
                                 sampler=sampler, num_samples=500,
                                 num_warmup=7, max_depth=3)
    got = ts.validate_posterior(tg, tstate, torch.Generator(), sampler=sampler,
                                num_samples=500, num_warmup=7, max_depth=3)
    (jv, *jrest), (tv, *trest) = (seen[js.HMCResult if sampler == "hmc"
                                       else js.NUTSResult],
                                  seen[ts.HMCResult if sampler == "hmc"
                                       else ts.NUTSResult])
    np.testing.assert_allclose(tv, jv, rtol=1e-12)
    assert trest == jrest
    for name in want._fields:
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-12, atol=1e-14, err_msg=name)
    with pytest.raises(ValueError, match="unknown sampler"):
        ts.validate_posterior(tg, tstate, torch.Generator(), sampler="mala")

