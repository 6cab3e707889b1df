"""No-U-Turn Sampler (multinomial variant), chains batched on the device.

Counterpart of ``gaussianvi_tpu/samplers/nuts.py``: Hoffman & Gelman (2014)
tree doubling with Betancourt's multinomial state selection, and the same
dual-averaging step-size adaptation as :mod:`.hmc`.  Two tree builders:

* ``tree_method="iterative"`` (default): the subtree is grown leaf by leaf
  with a checkpoint stack for the U-turn checks.  A leaf's state is stored
  when its index is even and, at each odd leaf, the U-turn condition is
  checked against exactly the stored endpoints of every balanced subtree
  that closes there: the segment set the recursive algorithm examines.
* ``tree_method="unrolled"``: the recursion, every leaf of every depth
  (kept for cross-validation).

The C chains run as one batch of ``[C, D]`` tensors, as ``jax.vmap`` runs
JAX's loops: the doubling loop and the subtree loop go on while any chain
is alive, and a chain that has turned, diverged or reached its bound keeps
its carry unchanged (a per-chain mask).  The chains alive in a loop have
all taken its same number of steps, so the leaf index, and with it the
checkpoint slots to store and check, is one Python integer.  A stopped
chain's checkpoint slots may be overwritten: it never reads them again.
Positions carry their log density and gradient (one evaluation a leaf).
Each depth's randomness is drawn before its subtree grows (:mod:`._draws`),
for the depths some chain reaches.
"""

from __future__ import annotations

from itertools import count
from typing import Callable, NamedTuple

import torch

from ._draws import GeneratorDraws
from .hmc import DualAveraging, value_and_grad

_MAX_DELTA = 1000.0


class NUTSResult(NamedTuple):
    samples: torch.Tensor      # [num_samples, D] ([C, num_samples, D] from nuts_chains)
    step_size: torch.Tensor
    mean_accept: torch.Tensor


class _Tree(NamedTuple):
    """A (sub)tree of each chain: its two ends (position, momentum and
    the gradient there), its multinomial proposal with the proposal's log
    density and gradient, and its bookkeeping."""
    q_minus: torch.Tensor
    p_minus: torch.Tensor
    g_minus: torch.Tensor
    q_plus: torch.Tensor
    p_plus: torch.Tensor
    g_plus: torch.Tensor
    q_prop: torch.Tensor       # multinomial proposal from the subtree
    lp_prop: torch.Tensor
    g_prop: torch.Tensor
    log_weight: torch.Tensor   # logsumexp of -H over subtree leaves
    turning: torch.Tensor
    diverging: torch.Tensor
    sum_alpha: torch.Tensor    # sum of accept probs (for adaptation)
    n_leaves: torch.Tensor


def _where(mask: torch.Tensor, a: _Tree, b: _Tree) -> _Tree:
    """Per chain, ``a`` where ``mask [C]`` else ``b``."""
    return _Tree(*(torch.where(mask.view(-1, *(1,) * (x.ndim - 1)), x, y)
                   for x, y in zip(a, b)))


def _live(mask: torch.Tensor) -> int:
    """How many chains ``mask`` keeps (one sync with the host)."""
    return int(mask.sum())


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _is_turning(q_minus, p_minus, q_plus, p_plus):
    dq = q_plus - q_minus
    return (_dot(dq, p_minus) < 0) | (_dot(dq, p_plus) < 0)


def _ckpt_idxs(n: int) -> tuple[int, int]:
    """Checkpoint slots to compare leaf ``n`` against (inclusive range).

    ``idx_max`` = popcount(n >> 1) is the slot where an even leaf is stored;
    the balanced subtrees closing at an odd leaf ``n`` start at the leaves
    stored in slots ``idx_min..idx_max`` (one per trailing 1-bit of n).
    For even n the range is empty (idx_min > idx_max).
    """
    idx_max = (n >> 1).bit_count()
    trailing_ones = (n & ~(n + 1)).bit_count()
    return idx_max - trailing_ones + 1, idx_max


def _leaf(log_density, q, p, g, eps_dir, h0) -> _Tree:
    """One leapfrog step of size ``eps_dir [C]`` (signed) from ``(q, p)``
    whose gradient is ``g``: a one-leaf tree."""
    half = (0.5 * eps_dir)[:, None]
    p1 = p + half * g
    q1 = q + eps_dir[:, None] * p1
    lp1, g1 = value_and_grad(log_density, q1)
    p1 = p1 + half * g1
    h1 = -lp1 + 0.5 * torch.sum(p1**2, dim=-1)
    h1 = torch.where(torch.isfinite(h1), h1, torch.inf)
    log_w = h0 - h1
    alpha = torch.clamp(torch.exp(torch.clamp(log_w, max=0.0)), max=1.0)
    return _Tree(q1, p1, g1, q1, p1, g1, q1, lp1, g1, log_w,
                 torch.zeros_like(h0, dtype=torch.bool),
                 (h1 - h0) > _MAX_DELTA, alpha, torch.ones_like(h0))


def _subtree_iter(log_density, depth, max_depth, q, p, g, eps_dir,
                  direction, h0, leaf_u, live) -> _Tree:
    """Subtree of ``2**depth`` leaves grown leaf by leaf from ``(q, p)``
    in ``direction``, for the chains ``live [C]``; ``leaf_u [C, 2**depth]``
    picks the proposal at each leaf."""
    chains, dim = q.shape
    q_ck = q.new_zeros(chains, max_depth, dim)
    p_ck = q.new_zeros(chains, max_depth, dim)
    no = torch.zeros_like(live)
    zero = torch.zeros_like(h0)
    # generation-order ends while growing: *_minus the first leaf (the
    # inner end), *_plus the last
    sub = _Tree(q, p, g, q, p, g, q, zero, g, torch.full_like(h0, -torch.inf),
                no, no, zero, zero)
    for n in range(1 << depth):
        live = live & ~(sub.turning | sub.diverging)
        n_live = _live(live)
        if n_live == 0:
            break
        new = _leaf(log_density, sub.q_plus, sub.p_plus, sub.g_plus, eps_dir,
                    h0)
        q1, p1 = new.q_plus, new.p_plus
        log_w = torch.logaddexp(sub.log_weight, new.log_weight)
        take = torch.log(leaf_u[:, n]) < new.log_weight - log_w
        idx_min, idx_max = _ckpt_idxs(n)
        if n % 2 == 0:
            q_ck[:, idx_max] = q1
            p_ck[:, idx_max] = p1
        turning = sub.turning
        for i in range(idx_min, idx_max + 1):
            # time-ordered segment between the leaf stored at slot i and
            # this leaf; for direction=-1 generation order reverses time
            dq = direction[:, None] * (q1 - q_ck[:, i])
            turning = turning | (_dot(dq, p_ck[:, i]) < 0) | (_dot(dq, p1) < 0)
        first = new if n == 0 else sub
        tk = take[:, None]
        grown = _Tree(
            first.q_minus, first.p_minus, first.g_minus, q1, p1, new.g_plus,
            torch.where(tk, q1, sub.q_prop), torch.where(take, new.lp_prop,
                                                         sub.lp_prop),
            torch.where(tk, new.g_prop, sub.g_prop),
            log_w, turning, sub.diverging | new.diverging,
            sub.sum_alpha + new.sum_alpha, sub.n_leaves + 1.0)
        sub = grown if n_live == chains else _where(live, grown, sub)
    # generation-order ends to position order (minus = earlier time)
    fwd = (direction > 0)[:, None]
    first, last = sub[:3], sub[3:6]
    return _Tree(*(torch.where(fwd, a, b) for a, b in zip(first, last)),
                 *(torch.where(fwd, b, a) for a, b in zip(first, last)),
                 *sub[6:])


def _merge(first: _Tree, second: _Tree, direction, u) -> _Tree:
    """Combine two adjacent subtrees; ``second`` extends in ``direction``;
    ``u [C]`` decides the proposal."""
    fwd = (direction > 0)[:, None]
    q_minus = torch.where(fwd, first.q_minus, second.q_minus)
    p_minus = torch.where(fwd, first.p_minus, second.p_minus)
    g_minus = torch.where(fwd, first.g_minus, second.g_minus)
    q_plus = torch.where(fwd, second.q_plus, first.q_plus)
    p_plus = torch.where(fwd, second.p_plus, first.p_plus)
    g_plus = torch.where(fwd, second.g_plus, first.g_plus)
    log_w = torch.logaddexp(first.log_weight, second.log_weight)
    take = torch.log(u) < second.log_weight - log_w
    tk = take[:, None]
    return _Tree(
        q_minus, p_minus, g_minus, q_plus, p_plus, g_plus,
        torch.where(tk, second.q_prop, first.q_prop),
        torch.where(take, second.lp_prop, first.lp_prop),
        torch.where(tk, second.g_prop, first.g_prop),
        log_w,
        first.turning | second.turning
        | _is_turning(q_minus, p_minus, q_plus, p_plus),
        first.diverging | second.diverging,
        first.sum_alpha + second.sum_alpha,
        first.n_leaves + second.n_leaves)


def _build_tree(log_density, depth, q, p, g, eps_dir, direction, h0,
                merge_u, slots) -> _Tree:
    """The recursion: subtree of ``2**depth`` leaves from ``(q, p)`` in
    ``direction``; its merges take the columns of ``merge_u`` in the order
    ``slots`` yields them (post-order)."""
    if depth == 0:
        return _leaf(log_density, q, p, g, eps_dir, h0)
    left = _build_tree(log_density, depth - 1, q, p, g, eps_dir, direction,
                       h0, merge_u, slots)
    fwd = (direction > 0)[:, None]
    right = _build_tree(
        log_density, depth - 1,
        torch.where(fwd, left.q_plus, left.q_minus),
        torch.where(fwd, left.p_plus, left.p_minus),
        torch.where(fwd, left.g_plus, left.g_minus),
        eps_dir, direction, h0, merge_u, slots)
    merged = _merge(left, right, direction, merge_u[:, next(slots)])
    # if left already terminated, the whole subtree is invalid
    stop_early = left.turning | left.diverging
    return _where(stop_early, left, merged)._replace(
        turning=stop_early | merged.turning,
        diverging=left.diverging | merged.diverging)


def _grow(state: _Tree, sub: _Tree, direction, u_swap) -> _Tree:
    """Absorb the subtree built off the current edge (biased progressive
    sampling, Betancourt: take its proposal with prob min(1, w_new/w_old))."""
    valid = ~(sub.turning | sub.diverging)
    stopped = state.turning | state.diverging
    grow = ~stopped & valid
    take = grow & (torch.log(u_swap)
                   < torch.clamp(sub.log_weight - state.log_weight, max=0.0))
    back = (grow & (direction < 0))[:, None]
    fore = (grow & (direction > 0))[:, None]
    q_minus = torch.where(back, sub.q_minus, state.q_minus)
    p_minus = torch.where(back, sub.p_minus, state.p_minus)
    g_minus = torch.where(back, sub.g_minus, state.g_minus)
    q_plus = torch.where(fore, sub.q_plus, state.q_plus)
    p_plus = torch.where(fore, sub.p_plus, state.p_plus)
    g_plus = torch.where(fore, sub.g_plus, state.g_plus)
    tk = take[:, None]
    return _Tree(
        q_minus, p_minus, g_minus, q_plus, p_plus, g_plus,
        torch.where(tk, sub.q_prop, state.q_prop),
        torch.where(take, sub.lp_prop, state.lp_prop),
        torch.where(tk, sub.g_prop, state.g_prop),
        torch.where(grow, torch.logaddexp(state.log_weight, sub.log_weight),
                    state.log_weight),
        state.turning | sub.turning
        | _is_turning(q_minus, p_minus, q_plus, p_plus),
        state.diverging | sub.diverging,
        state.sum_alpha + torch.where(grow, sub.sum_alpha, 0.0),
        state.n_leaves + torch.where(grow, sub.n_leaves, 0.0))


def _draw(log_density, t, q0, lp0, g0, eps, draws, max_depth, tree_method):
    """One NUTS transition of every chain from ``q0`` (log density ``lp0``,
    gradient ``g0``): the new positions with theirs, and the accept
    statistics ``[C]``."""
    p0 = draws.nuts_momentum(t)
    h0 = -lp0 + 0.5 * torch.sum(p0**2, dim=-1)
    no = torch.zeros_like(h0, dtype=torch.bool)
    state = _Tree(q0, p0, g0, q0, p0, g0, q0, lp0, g0, torch.zeros_like(h0),
                  no, no, torch.zeros_like(h0), torch.ones_like(h0))
    iterative = tree_method == "iterative"
    for depth in range(max_depth):
        alive = ~(state.turning | state.diverging)
        # iterative: early exit once every tree turned or diverged, the
        # same result as the remaining depths with grow=False
        n_alive = _live(alive) if iterative else 0
        if iterative and n_alive == 0:
            break
        forward, u_swap, u_tree = draws.nuts_depth(
            t, depth, 1 << depth if iterative else (1 << depth) - 1)
        direction = torch.where(forward, 1.0, -1.0).to(q0.dtype)
        fwd = forward[:, None]
        edge = (torch.where(fwd, state.q_plus, state.q_minus),
                torch.where(fwd, state.p_plus, state.p_minus),
                torch.where(fwd, state.g_plus, state.g_minus))
        eps_dir = direction * eps
        if iterative:
            sub = _subtree_iter(log_density, depth, max_depth, *edge, eps_dir,
                                direction, h0, u_tree, alive)
            grown = _grow(state, sub, direction, u_swap)
            state = (grown if n_alive == alive.numel()
                     else _where(alive, grown, state))
        else:
            sub = _build_tree(log_density, depth, *edge, eps_dir, direction,
                              h0, u_tree, count())
            state = _grow(state, sub, direction, u_swap)
    return (state.q_prop, state.lp_prop, state.g_prop,
            state.sum_alpha / state.n_leaves)


def _run_nuts(log_density, init: torch.Tensor, draws, num_samples: int,
              num_warmup: int, max_depth: int, init_step_size: float,
              target_accept: float, tree_method: str) -> NUTSResult:
    """Adaptive NUTS on the chains ``init [C, D]`` with the draws of
    ``draws`` (:mod:`._draws`)."""
    if tree_method not in ("iterative", "unrolled"):
        raise ValueError(f"unknown tree_method {tree_method!r}")
    chains, dim = init.shape
    adapt = DualAveraging(init_step_size, target_accept, num_warmup, chains,
                          init.dtype, init.device)
    q = init.detach()
    lp, g = value_and_grad(log_density, q)
    samples = init.new_empty(chains, num_samples, dim)
    alphas = init.new_empty(chains, num_samples)
    for m in range(num_warmup + num_samples):
        q, lp, g, alpha = _draw(log_density, m, q, lp, g,
                                torch.exp(adapt.log_eps), draws, max_depth,
                                tree_method)
        adapt.update(alpha)
        if m >= num_warmup:
            samples[:, m - num_warmup] = q
            alphas[:, m - num_warmup] = alpha
    return NUTSResult(samples, torch.exp(adapt.log_eps_bar),
                      torch.mean(alphas, dim=1))


def nuts_chains(
    log_density: Callable[[torch.Tensor], torch.Tensor],
    init_positions: torch.Tensor,
    generator: torch.Generator,
    num_samples: int = 1000,
    num_warmup: int = 500,
    max_depth: int = 6,
    init_step_size: float = 0.1,
    target_accept: float = 0.8,
    tree_method: str = "iterative",
) -> NUTSResult:
    """Multi-chain NUTS, the chains one batch on their device:
    ``init_positions [C, D]`` -> samples ``[C, T, D]``, step sizes and mean
    accept statistics ``[C]``.

    Feed ``result.samples`` straight into the [C, T, D] diagnostics
    (:func:`.diagnostics.split_rhat` etc.).
    """
    chains, dim = init_positions.shape
    draws = GeneratorDraws(generator, chains, dim, init_positions.dtype,
                           init_positions.device)
    return _run_nuts(log_density, init_positions, draws, num_samples,
                     num_warmup, max_depth, init_step_size, target_accept,
                     tree_method)


def nuts(
    log_density: Callable[[torch.Tensor], torch.Tensor],
    init_position: torch.Tensor,
    generator: torch.Generator,
    num_samples: int = 1000,
    num_warmup: int = 500,
    max_depth: int = 6,
    init_step_size: float = 0.1,
    target_accept: float = 0.8,
    tree_method: str = "iterative",
) -> NUTSResult:
    """Adaptive NUTS on one chain ``init_position [D]``."""
    res = nuts_chains(log_density, init_position[None], generator,
                      num_samples, num_warmup, max_depth, init_step_size,
                      target_accept, tree_method)
    return NUTSResult(*(x[0] for x in res))
