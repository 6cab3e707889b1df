"""PyTorch port, NUTS (``samplers/nuts.py``) against the JAX package (CPU,
f64), draw for draw: the port's NUTS takes each depth's randomness from a
draw source (``samplers/_draws.py``) and these tests hand it the draws
JAX's ``gaussianvi_tpu/samplers/nuts.py`` makes from its keys (its key
splits replayed here).  Both tree builders, a target whose trees reach the
depth bound, one that diverges, and C = 3 chains whose trees stop at
different depths in one batch, against ``jax.vmap`` of the chains."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gaussianvi_tpu import samplers as js  # noqa: E402
from gaussianvi_tpu.examples.chain_estimation import (  # noqa: E402
    build_chain_estimation as jax_flagship,
)
from gaussianvi_tpu_torch import samplers as ts  # noqa: E402
from gaussianvi_tpu_torch.convert import graph_from_arrays  # noqa: E402
from gaussianvi_tpu_torch.samplers.hmc import value_and_grad  # noqa: E402
from test_torch_slice import describe  # noqa: E402

# the modules (the packages' ``samplers.nuts`` is the function)
jnuts = importlib.import_module("gaussianvi_tpu.samplers.nuts")
tnuts = importlib.import_module("gaussianvi_tpu_torch.samplers.nuts")
CPU = torch.device("cpu")
F64 = jnp.float64
SCALES = np.array([1.0, 30.0, 4.0])


def _t(a):
    return torch.tensor(np.array(a))


def jax_nuts_draws(key, transitions, dim, max_depth, tree_method):
    """The draws of ``gaussianvi_tpu.samplers.nuts`` from ``key``: momenta
    ``[T, D]``, and per depth the direction ``[T, depth]``, the swap
    uniform ``[T, depth]`` and the tree's uniforms ``[T, depth, width]``
    (per leaf, or per merge node in post-order), zero-padded."""
    width = 1 << (max_depth - 1)

    def merges(depth, key_t):
        if depth == 0:
            return []
        k1, k2, k3 = jax.random.split(key_t, 3)
        return (merges(depth - 1, k1) + merges(depth - 1, k2)
                + [jax.random.uniform(k3, (), F64)])

    def transition(key_t):
        k_mom, key_d = jax.random.split(key_t)
        mom = jax.random.normal(k_mom, (dim,), F64)
        fwd, swap, tree = [], [], []
        for depth in range(max_depth):
            key_d, k = jax.random.split(key_d)
            k_dir, k_sub, k_swap = jax.random.split(k, 3)
            fwd.append(jax.random.bernoulli(k_dir))
            swap.append(jax.random.uniform(k_swap, (), F64))
            if tree_method == "iterative":
                u = [jax.random.uniform(jax.random.fold_in(k_sub, n), (), F64)
                     for n in range(1 << depth)]
            else:
                u = merges(depth, k_sub)
            u = jnp.stack(u) if u else jnp.zeros((0,), F64)
            tree.append(jnp.pad(u, (0, width - u.shape[0])))
        return mom, jnp.stack(fwd), jnp.stack(swap), jnp.stack(tree)

    return jax.jit(jax.vmap(transition))(jax.random.split(key, transitions))


class NUTSDraws:
    """JAX's NUTS draws for the chains (leading axis C); records the depths
    asked for, per transition."""

    def __init__(self, mom, fwd, swap, tree):
        self.mom, self.fwd, self.swap, self.tree = map(_t, (mom, fwd, swap,
                                                           tree))
        self.depths = {}

    def nuts_momentum(self, t):
        return self.mom[:, t]

    def nuts_depth(self, t, depth, count):
        self.depths[t] = depth + 1
        return (self.fwd[:, t, depth], self.swap[:, t, depth],
                self.tree[:, t, depth, :count])


def _gaussian():
    """An ill-conditioned Gaussian (scales 1, 30, 4): trees reach the depth
    bound."""
    def jax_ld(x):
        return -0.5 * jnp.sum((x / SCALES) ** 2)

    def port_ld(x):
        return -0.5 * torch.sum((x / _t(SCALES)) ** 2, dim=-1)

    return jax_ld, port_ld


def _flagship4():
    jg, ji, _ = jax_flagship(num_states=4, dim_x=2, dtype=F64)
    tg = graph_from_arrays(describe(jg, ji)[0], device=CPU)
    return (js.make_log_density(jg, 4, 4), ts.make_log_density(tg, 4, 4),
            np.asarray(ji.mu).reshape(-1))


def _port_run(port_ld, init, keys, max_depth, tree_method, warmup, samples,
              init_step_size):
    """The port on JAX's draws for the chain keys ``keys``: ``(result,
    draws)``."""
    draws = NUTSDraws(*jax.vmap(lambda k: jax_nuts_draws(
        k, warmup + samples, init.shape[-1], max_depth, tree_method))(keys))
    got = tnuts._run_nuts(port_ld, _t(init).reshape(-1, init.shape[-1]),
                          draws, samples, warmup, max_depth, init_step_size,
                          0.8, tree_method)
    return got, draws


def _run_both(jax_ld, port_ld, init, key, max_depth, tree_method, warmup,
              samples, init_step_size, chains=False):
    """JAX's run (one chain, or ``jax.vmap`` over the rows of ``init``) and
    the port's on JAX's draws: ``(want, got, draws)``."""
    kw = dict(num_samples=samples, num_warmup=warmup, max_depth=max_depth,
              init_step_size=init_step_size, tree_method=tree_method)
    run = js.nuts_chains if chains else js.nuts
    want = run(jax_ld, jnp.asarray(init), key, **kw)
    keys = jax.random.split(key, init.shape[0]) if chains else key[None]
    got, draws = _port_run(port_ld, init, keys, max_depth, tree_method,
                           warmup, samples, init_step_size)
    if not chains:
        got = ts.NUTSResult(*(x[0] for x in got))
    return want, got, draws


def _assert_same(want, got):
    np.testing.assert_allclose(got.samples.numpy(), np.asarray(want.samples),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.step_size.numpy(),
                               np.asarray(want.step_size), rtol=1e-12)
    np.testing.assert_allclose(got.mean_accept.numpy(),
                               np.asarray(want.mean_accept), rtol=0,
                               atol=1e-10)


def test_ckpt_idxs_match_jax():
    for n in range(64):
        lo, hi = jnuts._ckpt_idxs(jnp.int32(n))
        assert tnuts._ckpt_idxs(n) == (int(lo), int(hi)), n


def test_is_turning_matches_jax():
    rng = np.random.default_rng(0)
    qm, pm, qp, pp = rng.standard_normal((4, 200, 3))
    want = jax.vmap(jnuts._is_turning)(qm, pm, qp, pp)
    got = tnuts._is_turning(*map(_t, (qm, pm, qp, pp)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < 200


def test_iterative_trees_reach_the_depth_bound():
    """max_depth 4 on the ill-conditioned Gaussian: 15 warmup + 25
    samples, trees of the full depth, the same draws as JAX's."""
    jax_ld, port_ld = _gaussian()
    want, got, draws = _run_both(jax_ld, port_ld, np.array([0.5, -3.0, 1.0]),
                                 jax.random.key(8), 4, "iterative", 15, 25,
                                 0.5)
    _assert_same(want, got)
    depths = np.array(list(draws.depths.values()))
    assert depths.max() == 4 and depths.min() < 4


def test_iterative_diverging_trees():
    """The flagship at N = 4 from a step of 1.0: the first transitions'
    trees diverge (|dH| > 1000 at the first leaf) until dual averaging
    shrinks the step; the same samples as JAX's."""
    jax_ld, port_ld, x0 = _flagship4()
    q = _t(x0)[None]
    lp, g = value_and_grad(port_ld, q)
    p = torch.ones_like(q)
    leaf = tnuts._leaf(port_ld, q, p, g, torch.tensor([1.0], dtype=q.dtype),
                       -lp + 0.5 * torch.sum(p**2, -1))
    assert bool(leaf.diverging.all())
    want, got, _ = _run_both(jax_ld, port_ld, x0, jax.random.key(2), 4,
                             "iterative", 15, 15, 1.0)
    _assert_same(want, got)
    assert float(got.step_size) < 0.1


def test_unrolled_matches_jax():
    """The recursion at max_depth 3 (every leaf of every depth, one uniform
    per merge node)."""
    jax_ld, port_ld = _gaussian()
    want, got, draws = _run_both(jax_ld, port_ld, np.array([0.5, -3.0, 1.0]),
                                 jax.random.key(5), 3, "unrolled", 10, 20,
                                 0.5)
    _assert_same(want, got)
    assert set(draws.depths.values()) == {3}


def test_chains_stop_at_different_depths_in_one_batch():
    """C = 3 chains as one batch against ``jax.vmap`` of the chains; alone,
    the same chains' trees stop at different depths in a transition, so the
    batch carried stopped chains unchanged while others grew."""
    jax_ld, port_ld = _gaussian()
    init = np.array([[0.5, -3.0, 1.0], [3.0, 40.0, -6.0], [-0.1, 0.2, 0.3]])
    key = jax.random.key(21)
    want, got, draws = _run_both(jax_ld, port_ld, init, key, 5, "iterative",
                                 10, 15, 0.5, chains=True)
    assert got.samples.shape == (3, 15, 3)
    _assert_same(want, got)
    alone = []
    for c, k in enumerate(jax.random.split(key, 3)):
        one, d = _port_run(port_ld, init[c], k[None], 5, "iterative", 10, 15,
                           0.5)
        np.testing.assert_allclose(one.samples[0].numpy(),
                                   got.samples[c].numpy(), rtol=0, atol=1e-12)
        alone.append([d.depths[t] for t in range(25)])
    alone = np.array(alone)
    assert (alone.min(0) != alone.max(0)).any()
    np.testing.assert_array_equal(
        [draws.depths[t] for t in range(25)], alone.max(0))
