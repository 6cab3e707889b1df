"""PyTorch port on the GPU: each CUDA kernel against its plain PyTorch
version on the card (the split fused gradient pair also against the single
kernel), and the NGD loop (separate, fused and block-form moments paths)
and the proximal optimizer on the kernels against the plain loop (float64).
Skipped without a CUDA device.
On a GPU machine (no JAX needed):

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

ATOL = 1e-10


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only there)")
    return torch.device("cuda", 0)


def _chains(nb, n, s, seed, dev):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((nb, n, s, s))
    diag = a @ np.swapaxes(a, -1, -2) + 3 * s * np.eye(s)
    off = 0.5 * rng.standard_normal((nb, max(n - 1, 0), s, s))
    rhs = rng.standard_normal((nb, n, s))
    return [torch.tensor(x, device=dev) for x in (diag, off, rhs)]


# name -> (leading shape, N, s): chains shorter and longer than a warp's
# lanes, s = 2, a ragged last warp and lane group (chains and pairs not a
# multiple of a warp's), the trial batch's and the solve pair's leading
# shapes, and a chain too long for shared memory (the global-scratch
# route); s = 6 (two chains a warp, its last 8 lanes repeating its first)
# at an odd count, N = 1 and on the global-scratch route; s = 1 (16 chains
# a warp) and s = 14 (a warp a chain, a lane a column) the same way
CHAIN_LAYOUTS = {"N=1": ((7,), 1, 4), "N=2": ((7,), 2, 4),
                 "N=33": ((5,), 33, 4), "N=70, s=2": ((9,), 70, 2),
                 "ragged": ((13,), 6, 4), "(11, B)": ((11, 6), 5, 4),
                 "(2, B), s=2": ((2, 5), 6, 2), "long chain": ((3,), 1100, 4),
                 "s=6": ((5,), 9, 6), "s=6, N=1": ((3,), 1, 6),
                 "s=6, long chain": ((3,), 700, 6),
                 "s=1": ((37,), 5, 1), "s=1, N=1": ((21,), 1, 1),
                 "s=1, long chain": ((3,), 500, 1),
                 "s=14": ((5,), 9, 14), "s=14, N=1": ((3,), 1, 14),
                 "s=14, long chain": ((2,), 70, 14)}


def _twice(fn):
    """Two launches give the same bits; returns the first result."""
    first, second = fn(), fn()
    for a, b in zip(first, second):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
        assert torch.equal(a.isnan(), b.isnan())
    return first


@pytest.mark.parametrize("layout", sorted(CHAIN_LAYOUTS))
def test_chain_kernels_match_plain(dev, layout):
    """K1 and K2 (both entry points, an expanded right-hand side for the
    pair) against their plain versions, each launched twice."""
    from gaussianvi_tpu_torch.kernels import chain

    lead, n, s = CHAIN_LAYOUTS[layout]
    count = int(np.prod(lead))
    diag, off, rhs = (x.reshape(*lead, *x.shape[1:])
                      for x in _chains(count, n, s, seed=n, dev=dev))
    if layout.endswith("long chain"):
        assert chain.gbp_plan(n, s, 8).scratch
        assert chain.solve_plan(n, s, 8).scratch
    before = (chain.gbp_covariance_logdet_lanes.launches,
              chain.solve_lanes.launches)
    got = _twice(lambda: chain.gbp_covariance_logdet_lanes(diag, off))
    want = chain.gbp_covariance_logdet_plain(diag, off)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=ATOL)
    x = _twice(lambda: (chain.solve_lanes(diag, off, rhs),))[0]
    torch.testing.assert_close(x, chain.solve_plain(diag, off, rhs), rtol=0,
                               atol=ATOL)
    shifted = diag + torch.eye(s, dtype=diag.dtype, device=dev)
    one = rhs.reshape(-1, n, s)[0].expand(*lead, n, s)
    pair = _twice(lambda: chain.solve_pair_lanes(diag, off, shifted, off,
                                                 one))
    for g, w in zip(pair, chain.solve_pair_plain(diag, off, shifted, off,
                                                 one)):
        torch.testing.assert_close(g, w, rtol=0, atol=ATOL)
    assert (chain.gbp_covariance_logdet_lanes.launches,
            chain.solve_lanes.launches) == (before[0] + 2, before[1] + 4)


# name -> (leading shape, K, dim_x, degree, marginal rule, params' leading
# shape, view) of the quadrature kernels' layouts: the flagship's rules on
# a (3, 8) batch, factor counts that are not a multiple of a warp's
# factors (1, 3, 33, 1025), leading shapes (), (B,) and (T, B), params
# [K, P], [1, K, P] and [B, K, P] broadcast, rules of 4, 7, 29 and 137
# nodes at d = 2 and 4, and mu / cov views: a slice of the state axis (a
# batch stride) and a transposed (T, B) pair of axes
QUAD_LAYOUTS = {
    "(3, 8), M=29": ((3,), 8, 2, 4, True, (), None),
    "(3, 8), M=137": ((3,), 8, 2, 4, False, (3,), None),
    "(3, 8), d=2, M=4": ((3,), 8, 1, 4, True, (1,), None),
    "1 factor, ()": ((), 1, 2, 4, True, (), None),
    "3, (B,)": ((3,), 1, 2, 4, True, (3,), None),
    "33, (T, B)": ((3, 11), 1, 2, 4, True, (11,), None),
    "1025, [1, K, P]": ((25,), 41, 2, 4, True, (1,), None),
    "d=2, M=7": ((5,), 7, 1, 7, True, (), None),
    "d=2, M=137": ((3,), 6, 1, 7, False, (3,), None),
    "state slice": ((9,), 5, 2, 4, True, (9,), "slice"),
    "(T, B) transposed": ((4, 3), 6, 2, 4, True, (3,), "transposed"),
    "d=6, M=69": ((3,), 8, 3, 4, True, (3,), None),
}


def _quad_layout(name, dtype, dev):
    """``(mu, cov, nodes, weights, params, rdim)`` of a ``QUAD_LAYOUTS``
    entry: numpy-seeded, well-conditioned covariances, range params."""
    from gaussianvi_tpu_torch.examples.chain_estimation import (
        build_chain_estimation,
    )

    lead, k, dim_x, degree, marginal, plead, view = QUAD_LAYOUTS[name]
    fb = build_chain_estimation(num_states=2, dim_x=dim_x, gh_degree=degree,
                                marginal_quad=marginal, dtype=dtype,
                                device=dev)[0].nonlinear[0]
    d = 2 * dim_x
    rng = np.random.default_rng(len(name))
    shape = {"slice": (*lead, k + 3), "transposed": (*lead[::-1], k)}.get(
        view, (*lead, k))

    def t(a):
        return torch.tensor(a, dtype=dtype, device=dev)

    mu = t(rng.standard_normal((*shape, d)))
    a = 0.3 * rng.standard_normal((*shape, d, d))
    cov = t(a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(d))
    if view == "slice":
        mu, cov = mu.narrow(-2, 2, k), cov.narrow(-3, 2, k)
    elif view == "transposed":
        mu, cov = mu.transpose(0, 1), cov.transpose(0, 1)
    par = rng.standard_normal((*plead, k, fb.kernel_params.shape[-1]))
    par[..., -2] = 1.0 + np.abs(par[..., -2])
    par[..., -1] = 0.1 + np.abs(par[..., -1])
    return mu, cov, fb.nodes, fb.weights, t(par), fb.quad_rdim


@pytest.mark.parametrize("layout", sorted(QUAD_LAYOUTS))
@pytest.mark.parametrize("with_moments", [False, True])
def test_quad_kernel_matches_plain(dev, with_moments, layout):
    """K3, either variant, against its plain version (float64), launched
    twice for the same bits."""
    from gaussianvi_tpu_torch.kernels import quad

    mu, cov, nodes, weights, par, rdim = _quad_layout(layout, torch.float64,
                                                      dev)
    args = (mu, cov, nodes, weights, "range", par)
    if with_moments:
        got = _twice(lambda: quad.quad_lanes_moments(*args, rdim=rdim))
        want = quad.quad_moments_plain(*args, rdim=rdim)
    else:
        got = _twice(lambda: (quad.quad_lanes_phi(*args, nonneg=True),))
        want = (quad.quad_phi_plain(*args, nonneg=True),)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=ATOL, equal_nan=True)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("layout", sorted(QUAD_LAYOUTS))
def test_fused_moments_kernel_matches_plain(dev, layout, dtype):
    """K4 against its plain version (the packed params through the
    functor's PyTorch form) and against K3 moments, which runs the same
    kernel body (the same bits), launched twice for the same bits."""
    from gaussianvi_tpu_torch.kernels import fused_moments as fm
    from gaussianvi_tpu_torch.kernels import quad

    mu, cov, nodes, weights, par, rdim = _quad_layout(layout, dtype, dev)
    d = mu.shape[-1]
    before = fm.fused_moments.launches
    got = _twice(lambda: fm.fused_moments(nodes, weights, mu, cov, "range",
                                          par, rdim=rdim))
    assert fm.fused_moments.launches == before + 2
    lead = mu.shape[:-1]
    count = int(np.prod(lead))
    want = fm.fused_moments_plain(
        nodes, weights, mu.reshape(count, d), cov.reshape(count, d, d),
        quad.KERNEL_COSTS["range"][1],
        (par.expand(*lead, par.shape[-1]).reshape(count, -1),), rdim)
    other = quad.quad_lanes_moments(mu, cov, nodes, weights, "range", par,
                                    rdim=rdim)
    for g, w, o in zip(got, want, other):
        assert g.shape == o.shape and g.is_contiguous()
        _assert_close(g, w.reshape(g.shape), dtype, scaled=True)
        assert torch.equal(g, o)


def test_use_pallas_without_a_functor_raises(dev):
    """A batch with a block form but no CUDA functor raises on the card
    under ``use_pallas``: never the plain version."""
    from dataclasses import replace

    from gaussianvi_tpu_torch import GVIConfig, optimize
    from gaussianvi_tpu_torch.inference.graph import FactorGraph

    graph, state = _flagship(6, 2, torch.float64, dev, count=2)
    fb = replace(graph.nonlinear[0], kernel_cost=None, kernel_params=None)
    graph = FactorGraph(graph.num_states, graph.state_dim, (fb,),
                        graph.linear)
    with pytest.raises(ValueError, match="kernel_cost"):
        optimize(graph, state, GVIConfig(niters=1, use_pallas=True,
                                         quad_impl="xla", chain_impl="seq"))


def _flagship(n, dim_x, dtype, dev, count=4):
    from gaussianvi_tpu_torch import stack_problems
    from gaussianvi_tpu_torch.examples.chain_estimation import (
        build_chain_estimation,
    )

    problems = [build_chain_estimation(num_states=n, dim_x=dim_x,
                                       gh_degree=4, seed=seed, dtype=dtype,
                                       device=dev)[:2]
                for seed in range(count)]
    return stack_problems(*map(list, zip(*problems)))


def _assert_close(got, want, dtype, scaled=False):
    """float64: atol 1e-10.  float32: rtol 1e-4 with an absolute floor of
    1e-6, scaled to the output's range for the moments-derived outputs
    (their entries pass through zero)."""
    if dtype == torch.float64:
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL,
                                   equal_nan=True)
        return
    fin = torch.isfinite(want)
    floor = 1e-6 * (float(want[fin].abs().max()) if scaled and fin.any()
                    else 1.0)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=floor,
                               equal_nan=True)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,dim_x", [(6, 2), (5, 1), (6, 3)])
def test_fused_trials_kernel_matches_plain(dev, n, dim_x, dtype):
    from gaussianvi_tpu_torch.inference.engine import fused_operands
    from gaussianvi_tpu_torch.kernels import fused_trials as ft

    graph, state = _flagship(n, dim_x, dtype, dev)
    ops = fused_operands(graph)
    s, b = 2 * dim_x, state.mu.shape[0]
    rng = np.random.default_rng(n)

    def t(a):
        return torch.tensor(a, dtype=dtype, device=dev)

    q = rng.standard_normal((b, n, s, s))
    dq = rng.standard_normal((b, n, s, s))
    x = (state.mu + t(0.1 * rng.standard_normal((b, n, s))),
         t(0.5 * rng.standard_normal((b, n, s))),
         t(10.0 * np.eye(s) + 0.5 * q @ np.swapaxes(q, -1, -2)),
         t(0.5 * rng.standard_normal((b, n - 1, s, s))),
         t(0.5 * (dq + np.swapaxes(dq, -1, -2))),
         t(0.5 * rng.standard_normal((b, n - 1, s, s))),
         t(0.9 * 0.75 ** np.arange(1, 12)))
    before = ft.trial_costs_lanes.launches
    ld, fc = ft.trial_costs_lanes(*x, *ops)
    assert ft.trial_costs_lanes.launches == before + 1
    ld_p, fc_p = ft.trial_costs_plain(*x, *ops)
    if dtype == torch.float64:
        _assert_close(ld, ld_p, dtype)
    else:
        torch.testing.assert_close(ld, ld_p, rtol=1e-5, atol=0)
    for got, want in zip(fc, fc_p):
        _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,dim_x", [(6, 2), (5, 1), (6, 3)])
def test_fused_gradient_kernel_matches_plain(dev, n, dim_x, dtype):
    """At the initial iterate (Vddmu indefinite on the flagship: the main
    solve is NaN there in both) and at a perturbed one."""
    from gaussianvi_tpu_torch.inference.engine import fused_operands
    from gaussianvi_tpu_torch.kernels import fused_gradient as fg

    graph, state = _flagship(n, dim_x, dtype, dev)
    ops = fused_operands(graph)
    b = state.mu.shape[0]
    rng = np.random.default_rng(n)
    mu = state.mu.clone()
    mu[1:] += torch.tensor(0.05 * rng.standard_normal(mu[1:].shape),
                           dtype=dtype, device=dev)
    temp = torch.linspace(1.0, 10.0, b, dtype=dtype, device=dev)
    x = (mu, state.precision.diag, state.precision.off, temp)
    before = fg.gradient_lanes.launches
    got = fg.gradient_lanes(*x, *ops)
    assert fg.gradient_lanes.launches == before + 1
    want = fg.gradient_plain(*x, *ops)
    for i, (g, w) in enumerate(zip(got, want)):
        if dtype == torch.float64 or i < 2:
            _assert_close(g, w, dtype)
        elif i == 2:
            torch.testing.assert_close(g, w, rtol=1e-5, atol=0)
        elif i < 5:
            _assert_close(g, w, dtype, scaled=True)
    if dtype == torch.float32:
        # float32 solves of nearly indefinite systems differ by the
        # condition number times eps: the NaN patterns agree, and the
        # kernel is no further from the float64 plain version than 4x the
        # float32 plain version is
        ref = fg.gradient_plain(*(t.double() for t in x), *_as_f64(ops))
        for g, w, r in zip(got[5:], want[5:], ref[5:]):
            assert torch.equal(torch.isnan(g), torch.isnan(w))
            fin = torch.isfinite(g) & torch.isfinite(r)
            err_k = (g.double() - r)[fin].abs().max()
            err_p = (w.double() - r)[fin].abs().max()
            assert err_k <= 4 * err_p + 1e-6, (err_k, err_p)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,dim_x", [(6, 2), (8, 1), (6, 3)])
def test_split_gradient_kernels_match_plain(dev, n, dim_x, dtype):
    """K6 ``accum`` on each half of the nonlinear factors against its plain
    version, ``solve`` on their sum against its plain version, and the pair
    against the single ``full`` kernel (which it equals up to the
    reassociation of one sum), at a perturbed iterate; every mode's
    launches are counted on its own wrapper."""
    from gaussianvi_tpu_torch.inference.engine import fused_operands
    from gaussianvi_tpu_torch.kernels import fused_gradient as fg

    graph, state = _flagship(n, dim_x, dtype, dev)
    nl_specs, lin_specs, nl_arrays, lin_arrays = fused_operands(graph)
    b = state.mu.shape[0]
    rng = np.random.default_rng(n)
    mu = state.mu + torch.tensor(0.05 * rng.standard_normal(state.mu.shape),
                                 dtype=dtype, device=dev)
    temp = torch.linspace(1.0, 10.0, b, dtype=dtype, device=dev)
    x = (mu, state.precision.diag, state.precision.off, temp)
    counts = lambda: (fg.gradient_lanes.launches,  # noqa: E731
                      fg.gradient_accum_lanes.launches,
                      fg.gradient_solve_lanes.launches)
    before = counts()
    total = None
    for i in range(2):
        sp, (start, nodes, weights, params) = nl_specs[0], nl_arrays[0]
        k = sp.k // 2
        specs = (sp._replace(k=k, slice_offset=None),)
        arrays = ((start[i * k:(i + 1) * k], nodes, weights,
                   params[:, i * k:(i + 1) * k]),)
        got = fg.gradient_lanes(*x, specs, (), arrays, (), mode="accum")
        want = fg.gradient_plain(*x, specs, (), arrays, (), mode="accum")
        for g, w in zip(got, want):
            _assert_close(g, w, dtype, scaled=True)
        if total is None:
            total = got
        else:
            total.buffer.add_(got.buffer)
    seeds = [t.clone() for t in total]
    got = fg.gradient_lanes(*x, (), lin_specs, (), lin_arrays, mode="solve",
                            seeds=total)
    assert counts() == (before[0], before[1] + 2, before[2] + 1)
    for t, t0 in zip(total, seeds):         # the kernel only reads them
        assert torch.equal(t, t0)
    want = fg.gradient_plain(*x, (), lin_specs, (), lin_arrays, mode="solve",
                             seeds=total)
    full = fg.gradient_lanes(*x, nl_specs, lin_specs, nl_arrays, lin_arrays)
    for i, (g, w, f) in enumerate(zip(got, want, full)):
        assert torch.equal(torch.isnan(g), torch.isnan(f))
        if dtype == torch.float64 or i < 2:
            _assert_close(g, w, dtype)
            _assert_close(g, f, dtype)
        elif i == 2:
            torch.testing.assert_close(g, w, rtol=1e-5, atol=0)
            torch.testing.assert_close(g, f, rtol=1e-5, atol=0)
        elif i < 5:
            _assert_close(g, w, dtype, scaled=True)
            _assert_close(g, f, dtype, scaled=True)
        else:
            # the float32 solves of nearly indefinite systems differ from
            # the plain version by the condition number times eps (the full
            # kernel's test holds them to float64); the pair is held to the
            # full kernel, from which it differs by one reassociated sum
            _assert_close(g, f, dtype, scaled=True)


def _layout_case(name, dtype, dev):
    """Operands at shapes the warp-per-chain layout can get wrong:
    ``(x6, x5, nl_specs, lin_specs, nl_arrays, lin_arrays)``.  The batch is
    never a multiple of the gradient kernel's problems per block.  The
    ``_s6`` cases (dim_x = 3) hold the s = 6 layout, an edge on a lane
    group: one edge, more edges than K6's four groups and K5's sixteen
    take in a turn, dynamic starts, two nonlinear batches, a ragged block,
    a chain long enough for the global scratch (float64)."""
    from gaussianvi_tpu_torch.inference.engine import fused_operands

    n, dim_x, count = {"n2": (2, 2, 3), "n5_s2": (5, 1, 5), "n33": (33, 2, 3),
                       "n70_s2": (70, 1, 2), "dynamic": (9, 2, 3),
                       "two_batches": (8, 2, 5),
                       "long_chain": (520, 2, 2),
                       "n2_s6": (2, 3, 3), "n33_s6": (33, 3, 3),
                       "dynamic_s6": (9, 3, 3), "two_batches_s6": (8, 3, 5),
                       "ragged_s6": (12, 3, 6),
                       "long_chain_s6": (160, 3, 2)}[name]
    graph, state = _flagship(n, dim_x, dtype, dev, count=count)
    nl_specs, lin_specs, nl_arrays, lin_arrays = fused_operands(graph)
    sp, (start, nodes, weights, params) = nl_specs[0], nl_arrays[0]
    if name.startswith("dynamic"):
        # the factors in another order than the states, some states bare
        keep = torch.tensor([7, 2, 5, 0, 3], device=dev)
        nl_specs = (sp._replace(k=len(keep), slice_offset=None),)
        nl_arrays = ((start[keep], nodes, weights, params[:, keep]),)
    elif name.startswith("two_batches"):
        halves = [torch.arange(0, n, 2, device=dev),
                  torch.arange(1, n, 2, device=dev)]
        nl_specs = tuple(sp._replace(k=len(h), slice_offset=None)
                         for h in halves)
        nl_arrays = tuple((start[h], nodes, weights, params[:, h])
                          for h in halves)
    s, b = 2 * dim_x, count
    rng = np.random.default_rng(n)

    def t(a):
        return torch.tensor(a, dtype=dtype, device=dev)

    mu = state.mu + t(0.05 * rng.standard_normal((b, n, s)))
    temp = torch.linspace(1.0, 3.0, b, dtype=dtype, device=dev)
    x6 = (mu, state.precision.diag, state.precision.off, temp)
    dq = rng.standard_normal((b, n, s, s))
    x5 = (mu, t(0.5 * rng.standard_normal((b, n, s))),
          state.precision.diag, state.precision.off,
          t(0.5 * (dq + np.swapaxes(dq, -1, -2))),
          t(0.5 * rng.standard_normal((b, n - 1, s, s))),
          t(0.9 * 0.75 ** np.arange(1, 12)))
    return x6, x5, nl_specs, lin_specs, nl_arrays, lin_arrays


def _same_bits(a, b):
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        a.nan_to_num(), b.nan_to_num())


LAYOUT_CASES = ["n2", "n5_s2", "n33", "n70_s2", "dynamic", "two_batches",
                "long_chain", "n2_s6", "n33_s6", "dynamic_s6",
                "two_batches_s6", "ragged_s6", "long_chain_s6"]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", LAYOUT_CASES)
def test_fused_kernels_at_awkward_layouts(dev, name, dtype):
    """K5 and the three modes of K6 against their plain versions at chain
    lengths around the warp's width, s = 2, dynamic starts, two nonlinear
    batches, a ragged last block and a chain that takes the global-scratch
    route; two launches on the same inputs give the same bits, and
    ``accum`` + ``solve`` equals ``full``."""
    from gaussianvi_tpu_torch.kernels import fused_gradient as fg
    from gaussianvi_tpu_torch.kernels import fused_trials as ft

    x6, x5, nl_specs, lin_specs, nl_arrays, lin_arrays = _layout_case(
        name, dtype, dev)
    ops = (nl_specs, lin_specs, nl_arrays, lin_arrays)
    b, n, s = x6[0].shape
    size = x6[0].element_size()
    f64 = dtype == torch.float64
    if name == "long_chain":
        # K6 takes the global scratch; K5 too in float64, while in float32
        # one trial at a time still fits shared memory (the chunk loop)
        assert fg.grad_plan("t", n, s, size, 0).scratch
        plan = ft.trial_plan("t", n, s, 11, size, 0)
        assert plan.scratch if f64 else plan.chunk < 11
    if name == "long_chain_s6":
        # float64 on the global scratch (both kernels); float32 in shared
        # memory, one K6 problem a block and K5 in chunks of trials
        g6, t6 = (fg.grad_plan("t", n, s, size, 0),
                  ft.trial_plan("t", n, s, 11, size, 0))
        assert (g6.scratch, t6.scratch) == (f64, f64)
        assert f64 or (g6.warps == 1 and t6.chunk < 11)
    if not f64:
        # float32 rounding grows along a chain and through the solves: the
        # kernel must take the float32 plain version's NaN decisions and be
        # no further from the float64 plain version than 4x the float32
        # plain version is (plus 1e-6 of the output's range), as for the
        # solves of test_fused_gradient_kernel_matches_plain
        x6_ref = tuple(t.double() for t in x6)
        x5_ref = tuple(t.double() for t in x5)
        ops_ref = _as_f64(ops)

    def check(got, want, ref):
        for g, w, r in zip(got, want, want if f64 else ref()):
            if f64:     # atol 1e-10 of the output's range
                fin = w[torch.isfinite(w)]
                scale = max(1.0, float(fin.abs().max())) if fin.numel() else 1.0
                torch.testing.assert_close(g, w, rtol=0, atol=ATOL * scale,
                                           equal_nan=True)
                continue
            assert torch.equal(torch.isnan(g), torch.isnan(w))
            fin = torch.isfinite(g) & torch.isfinite(r)
            if not fin.any():
                continue
            err_k = (g.double() - r)[fin].abs().max()
            err_p = (w.double() - r)[fin].abs().max()
            floor = 1e-6 * max(1.0, float(r[fin].abs().max()))
            assert err_k <= 4 * err_p + floor, (err_k, err_p)

    full = fg.gradient_lanes(*x6, *ops)
    again = fg.gradient_lanes(*x6, *ops)
    assert all(_same_bits(a, c) for a, c in zip(full, again))
    check(full, fg.gradient_plain(*x6, *ops),
          lambda: fg.gradient_plain(*x6_ref, *ops_ref))

    part = fg.gradient_accum_lanes(*x6, nl_specs, nl_arrays)
    assert all(_same_bits(a, c) for a, c in zip(
        part, fg.gradient_accum_lanes(*x6, nl_specs, nl_arrays)))
    check(part,
          fg.gradient_plain(*x6, nl_specs, (), nl_arrays, (), mode="accum"),
          lambda: fg.gradient_plain(*x6_ref, ops_ref[0], (), ops_ref[2], (),
                                    mode="accum"))
    seeds = [t.clone() for t in part]
    pair = fg.gradient_solve_lanes(*x6, part, lin_specs, lin_arrays)
    assert all(torch.equal(a, c) for a, c in zip(part, seeds))
    assert all(_same_bits(a, c) for a, c in zip(
        pair, fg.gradient_solve_lanes(*x6, part, lin_specs, lin_arrays)))
    # one rank's accumulators, then the linear factors: the order in which
    # the full kernel adds them, so the pair gives the full kernel's bits
    assert all(_same_bits(a, c) for a, c in zip(pair, full))

    ld, fc = ft.trial_costs_lanes(*x5, *ops)
    ld2, fc2 = ft.trial_costs_lanes(*x5, *ops)
    assert _same_bits(ld, ld2) and all(
        _same_bits(a, c) for a, c in zip(fc, fc2))
    ld_p, fc_p = ft.trial_costs_plain(*x5, *ops)

    def ref5():
        ld_r, fc_r = ft.trial_costs_plain(*x5_ref, *ops_ref)
        return (ld_r, *fc_r)

    check((ld, *fc), (ld_p, *fc_p), ref5)


def test_device_none_builds_on_the_card(dev):
    """``device=None`` is the card wherever tensors are built."""
    from gaussianvi_tpu_torch import default_device
    from gaussianvi_tpu_torch.examples.chain_estimation import (
        build_chain_estimation,
    )

    assert default_device().type == "cuda"
    graph, state, _ = build_chain_estimation(num_states=4)
    assert state.mu.device.type == "cuda"
    assert graph.linear[0].lam.device.type == "cuda"
    assert graph.nonlinear[0].nodes.device.type == "cuda"


def test_sharded_engine_on_one_rank_is_the_local_engine(dev):
    """A 1 x 1 mesh on the card (no process group): ``optimize_sharded``
    runs the single fused gradient kernel, not the pair, and returns
    ``optimize``'s result to the bit."""
    from gaussianvi_tpu_torch import GVIConfig, optimize
    from gaussianvi_tpu_torch.kernels import launch_counts, reset_launch_counts
    from gaussianvi_tpu_torch.parallel import make_mesh, optimize_sharded

    graph, state = _flagship(8, 2, torch.float64, dev, count=8)
    cfg = GVIConfig(niters=4, niters_lowtemp=4, step_size_base=0.9)
    reset_launch_counts()
    _, hs = optimize_sharded(graph, state, cfg, make_mesh(1, 1))
    counts = launch_counts()
    assert counts["fused_gradient"] == counts["fused_trials"] == 4
    assert (counts["fused_gradient_accum"] == counts["fused_gradient_solve"]
            == 0)
    _, hl = optimize(graph, state, cfg)
    assert torch.equal(hs.cost, hl.cost)
    assert torch.equal(hs.accepted_step, hl.accepted_step)


def _as_f64(ops):
    nl_specs, lin_specs, nl_arrays, lin_arrays = ops

    def cast(arrays):
        return tuple(tuple(x.double() if x.is_floating_point() else x
                           for x in arr) for arr in arrays)

    return nl_specs, lin_specs, cast(nl_arrays), cast(lin_arrays)


def test_optimize_on_kernels_matches_plain(dev):
    from gaussianvi_tpu_torch import GVIConfig, optimize, stack_problems
    from gaussianvi_tpu_torch.examples.chain_estimation import (
        build_chain_estimation,
    )
    from gaussianvi_tpu_torch.kernels import launch_counts, reset_launch_counts

    problems = [build_chain_estimation(num_states=8, dim_x=2, gh_degree=4,
                                       seed=seed, device=dev)[:2]
                for seed in range(3)]
    graph, state = stack_problems(*map(list, zip(*problems)))
    cfg = dict(niters=5, niters_lowtemp=5, step_size_base=0.9)
    reset_launch_counts()
    _, hk = optimize(graph, state, GVIConfig(fused_trials="off",
                                             fused_gradient="off", **cfg))
    counts = launch_counts()
    assert (counts.pop("fused_trials") == counts.pop("fused_gradient")
            == counts.pop("fused_moments") == counts.pop("fused_gradient_accum")
            == counts.pop("fused_gradient_solve") == counts.pop("quad_arm_phi")
            == counts.pop("quad_arm_moments") == counts.pop("gbp_trials") == 0)
    assert all(n > 0 for n in counts.values())
    _, hp = optimize(graph, state,
                     GVIConfig(chain_impl="seq", quad_impl="xla", **cfg))
    torch.testing.assert_close(hk.cost, hp.cost, rtol=1e-9, atol=0)
    assert torch.equal(hk.accepted_step, hp.accepted_step)


def test_fused_optimize_on_kernels_matches_plain(dev):
    """The default configuration on the card runs the fused kernels once
    per iteration each; against the plain path, 8 problems, float64."""
    from gaussianvi_tpu_torch import GVIConfig, optimize
    from gaussianvi_tpu_torch.kernels import launch_counts, reset_launch_counts

    graph, state = _flagship(8, 2, torch.float64, dev, count=8)
    cfg = dict(niters=5, niters_lowtemp=3, step_size_base=0.9)
    reset_launch_counts()
    _, hk = optimize(graph, state, GVIConfig(**cfg))
    counts = launch_counts()
    assert counts["fused_trials"] == counts["fused_gradient"] == 5
    assert counts["gbp_covariance_logdet"] > 0 and counts["quad_phi"] > 0
    _, hp = optimize(graph, state,
                     GVIConfig(chain_impl="seq", quad_impl="xla", **cfg))
    torch.testing.assert_close(hk.cost, hp.cost, rtol=1e-9, atol=0)
    assert torch.equal(hk.accepted_step, hp.accepted_step)


def test_new_paths_on_kernels_match_plain(dev):
    """Block-form moments (K4 once per iteration, no K6) and the proximal
    optimizer (K3 moments + K5 per iteration, no K2, no K6) on the card
    against the plain path; 8 problems, float64."""
    from gaussianvi_tpu_torch import GVIConfig, optimize
    from gaussianvi_tpu_torch.kernels import launch_counts, reset_launch_counts

    graph, state = _flagship(8, 2, torch.float64, dev, count=8)
    cfg = dict(niters=5, niters_lowtemp=5, step_size_base=0.9)
    plain = dict(chain_impl="seq", quad_impl="xla")
    reset_launch_counts()
    _, hk = optimize(graph, state, GVIConfig(use_pallas=True,
                                             fused_gradient="off", **cfg))
    counts = launch_counts()
    assert counts["fused_moments"] == 5 and counts["fused_gradient"] == 0
    assert counts["quad_moments"] == 0 and counts["solve"] == 5
    _, hp = optimize(graph, state, GVIConfig(**plain, **cfg))
    torch.testing.assert_close(hk.cost, hp.cost, rtol=1e-9, atol=0)
    assert torch.equal(hk.accepted_step, hp.accepted_step)

    cfg["step_size_base"] = 0.1
    reset_launch_counts()
    _, hk = optimize(graph, state, GVIConfig(**cfg), method="prox")
    counts = launch_counts()
    assert counts["quad_moments"] == counts["fused_trials"] == 5
    assert counts["fused_gradient"] == counts["solve"] == 0
    assert counts["fused_moments"] == 0
    _, hp = optimize(graph, state, GVIConfig(**plain, **cfg), method="prox")
    torch.testing.assert_close(hk.cost, hp.cost, rtol=1e-9, atol=0)
    assert torch.equal(hk.accepted_step, hp.accepted_step)
    assert bool((hk.accepted_step > 0).any())


def test_eigh_root_beyond_the_batched_solver_limit(dev):
    """``sqrtm_product(method="eigh")`` on more matrices than one batched
    eigensolver call takes on the card (the flagship's 32,768 blocks):
    chunked, and equal to the CPU result."""
    from gaussianvi_tpu_torch.ops import psd

    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, psd._EIGH_MAX_BATCH + 5, 4, 4))
    a = torch.tensor(q @ np.swapaxes(q, -1, -2) + 0.1 * np.eye(4))
    got = psd.sqrtm_product(a.to(dev), 0.3, method="eigh")
    want = psd.sqrtm_product(a, 0.3, method="eigh")
    torch.testing.assert_close(got.cpu(), want, rtol=1e-10, atol=1e-10)


def _six_dim(count, n, dev, dim_x=3):
    """``count`` chains of s = 2 dim_x (s = 6 by default: a
    constant-velocity GP prior and an anchor, no nonlinear factor),
    float64."""
    from gaussianvi_tpu_torch import stack_problems
    from gaussianvi_tpu_torch.factors.priors import (
        fixed_prior,
        minimum_acc_prior,
    )
    from gaussianvi_tpu_torch.inference.graph import FactorGraph, GaussianState
    from gaussianvi_tpu_torch.ops.blocktridiag import BlockTridiag

    graphs, states = [], []
    s = 2 * dim_x
    for seed in range(count):
        rng = np.random.default_rng(seed)
        mu0 = rng.standard_normal(s)
        graphs.append(FactorGraph(n, s, (), (
            fixed_prior(0, mu0, 0.01 * np.eye(s), device=dev),
            minimum_acc_prior(np.eye(dim_x), 0.1, n, device=dev))))
        mu = mu0 + 0.3 * np.cumsum(rng.standard_normal((n, s)), axis=0)
        states.append(GaussianState(
            torch.tensor(mu, device=dev),
            BlockTridiag.identity((), n, s, 10.0, device=dev)))
    return stack_problems(graphs, states)


def test_uncovered_graphs_run_under_the_defaults(dev):
    """On the card ``"auto"`` takes the plain version for what no kernel
    covers, per batch and shape: a range batch without a CUDA functor
    (plain quadrature and no fused kernels, the chain kernels still) and
    an s = 8 chain (no kernel at all) run under the default config and
    equal the plain path; 4 problems, float64."""
    from dataclasses import replace

    from gaussianvi_tpu_torch import GVIConfig, optimize
    from gaussianvi_tpu_torch.kernels import launch_counts, reset_launch_counts

    graph, state = _flagship(8, 2, torch.float64, dev, count=4)
    graph = replace(graph, nonlinear=tuple(
        replace(fb, kernel_cost=None, kernel_params=None)
        for fb in graph.nonlinear))
    cfg = dict(niters=4, niters_lowtemp=2, step_size_base=0.9)
    plain = GVIConfig(chain_impl="seq", quad_impl="xla", **cfg)
    for g, s, kernels in ((graph, state, {"gbp_covariance_logdet", "solve"}),
                          (*_six_dim(4, 8, dev, dim_x=4), set())):
        reset_launch_counts()
        _, hk = optimize(g, s, GVIConfig(**cfg))
        assert {k for k, v in launch_counts().items() if v} == kernels
        _, hp = optimize(g, s, plain)
        torch.testing.assert_close(hk.cost, hp.cost, rtol=1e-9, atol=0)
        assert torch.equal(hk.accepted_step, hp.accepted_step)


# ---------------------------------------------------------------------------
# the planar planner's cost functor (PlanarSdfCost) in K3, K5 and K6
# ---------------------------------------------------------------------------

def _planner(dtype, dev, n=8, count=6, seed=0):
    """The planar planner's graph with ``count`` restarts on the card:
    ``(graph_b, state_b)``, the means jittered around the straight line
    (through the obstacle)."""
    from gaussianvi_tpu_torch.examples.planar_planning import (
        build_planar_planning,
    )
    from gaussianvi_tpu_torch.inference.graph import GaussianState
    from gaussianvi_tpu_torch.ops.blocktridiag import BlockTridiag
    from gaussianvi_tpu_torch.parallel.restarts import _batch_graph

    graph, init, _, _ = build_planar_planning(num_states=n, dtype=dtype,
                                              device=dev)
    rng = np.random.default_rng(seed)
    noise = 0.3 * rng.standard_normal((count, n, 4))
    noise[0] = 0.0
    prec = init.precision
    state = GaussianState(
        init.mu + torch.tensor(noise, dtype=dtype, device=dev),
        BlockTridiag(prec.diag.expand(count, n, 4, 4).clone(),
                     prec.off.expand(count, n - 1, 4, 4).clone()))
    return _batch_graph(graph, count), state


def _planner_marginals(count, dtype, dev, seed=0):
    """Factor marginals over every kind of point the planar cost meets:
    clear of the obstacle (E[phi] exactly 0), inside it, off the field, on
    its last row and column, on grid nodes."""
    rng = np.random.default_rng(seed)
    cell = 10.0 / 99
    kinds = [np.c_[rng.uniform(-3.0, 13.0, (count, 2)),
                   rng.standard_normal((count, 2))],
             np.c_[rng.uniform(4.0, 6.0, (count, 1)),
                   rng.uniform(3.0, 5.0, (count, 1)), np.zeros((count, 2))],
             np.c_[np.full((count, 1), 10.0), rng.uniform(0, 10, (count, 1)),
                   np.zeros((count, 2))],
             np.c_[rng.uniform(0, 10, (count, 1)), np.full((count, 1), 10.0),
                   np.zeros((count, 2))],
             np.c_[cell * rng.integers(0, 100, (count, 2)),
                   np.zeros((count, 2))],
             np.tile([1.0, 1.0, 0.5, 0.5], (count, 1))]
    mu = np.stack(kinds, 1)                                   # [count, 6, 4]
    a = 0.2 * rng.standard_normal((*mu.shape, 4))
    cov = a @ np.swapaxes(a, -1, -2) + 0.01 * np.eye(4)
    cov[:, -1] = 0.001 * np.eye(4)
    t = lambda x: torch.tensor(x, dtype=dtype, device=dev)  # noqa: E731
    return t(mu), t(cov)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("with_moments", [False, True])
def test_planar_sdf_quad_kernel_matches_plain(dev, with_moments, dtype):
    """K3 (both variants) with the planar SDF cost against its plain
    version, twice for the same bits; exact zeros (all-clear factors) in
    the same places, never NaN."""
    from gaussianvi_tpu_torch.kernels import quad

    graph, _ = _planner(dtype, dev)
    fb = graph.nonlinear[0]
    mu, cov = _planner_marginals(5, dtype, dev)
    args = (mu, cov, fb.nodes, fb.weights, "planar_sdf",
            fb.kernel_params[0, 0])
    if with_moments:
        got = _twice(lambda: quad.quad_lanes_moments(
            *args, rdim=fb.quad_rdim, field=fb.kernel_field))
        want = quad.quad_moments_plain(*args, rdim=fb.quad_rdim,
                                       field=fb.kernel_field)
    else:
        got = _twice(lambda: (quad.quad_lanes_phi(
            *args, nonneg=True, field=fb.kernel_field),))
        want = (quad.quad_phi_plain(*args, nonneg=True,
                                    field=fb.kernel_field),)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_close(g, w, dtype, scaled=i > 0)
    assert torch.equal(got[0] == 0, want[0] == 0)
    assert (want[0][:, -1] == 0).all() and not torch.isnan(got[0]).any()
    assert (want[0][:, 1] > 0).all()
    with pytest.raises(ValueError, match="carries none"):
        quad.quad_lanes_phi(*args, nonneg=True)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_planar_sdf_fused_kernels_match_plain(dev, dtype):
    """K5 and K6 (``full``, and ``accum`` + ``solve``) on the planner's
    graph against their plain versions."""
    from gaussianvi_tpu_torch.inference.engine import fused_operands
    from gaussianvi_tpu_torch.kernels import fused_gradient as fg
    from gaussianvi_tpu_torch.kernels import fused_trials as ft

    graph, state = _planner(dtype, dev)
    ops = fused_operands(graph)
    b, n, s = state.mu.shape
    rng = np.random.default_rng(1)

    def t(a):
        return torch.tensor(a, dtype=dtype, device=dev)

    q = rng.standard_normal((b, n, s, s))
    dq = rng.standard_normal((b, n, s, s))
    pd = t(10.0 * np.eye(s) + 0.5 * q @ np.swapaxes(q, -1, -2))
    po = t(0.5 * rng.standard_normal((b, n - 1, s, s)))
    x5 = (state.mu, t(0.5 * rng.standard_normal((b, n, s))), pd, po,
          t(0.5 * (dq + np.swapaxes(dq, -1, -2))),
          t(0.5 * rng.standard_normal((b, n - 1, s, s))),
          t(0.9 * 0.75 ** np.arange(1, 12)))
    got5 = _twice(lambda: (lambda ld, fc: (ld, *fc))(
        *ft.trial_costs_lanes(*x5, *ops)))
    want5 = ft.trial_costs_plain(*x5, *ops)
    if dtype == torch.float64:
        _assert_close(got5[0], want5[0], dtype)
    else:
        torch.testing.assert_close(got5[0], want5[0], rtol=1e-5, atol=0,
                                   equal_nan=True)
    for g, w in zip(got5[1:], want5[1]):
        _assert_close(g, w, dtype)
    assert (want5[1][0] == 0).any() and (want5[1][0] > 0).any()
    x6 = (state.mu, pd, po, torch.full((b,), 0.5, dtype=dtype, device=dev))
    got6 = _twice(lambda: fg.gradient_lanes(*x6, *ops))
    want6 = fg.gradient_plain(*x6, *ops)
    for i, (g, w) in enumerate(zip(got6, want6)):
        _assert_close(g, w, dtype, scaled=i > 2)
    nl_specs, lin_specs, nl_arrays, lin_arrays = ops
    part = fg.gradient_accum_lanes(*x6, nl_specs, nl_arrays)
    for g, w in zip(part, fg.gradient_plain(*x6, nl_specs, (), nl_arrays, (),
                                            mode="accum")):
        _assert_close(g, w, dtype, scaled=True)
    split = fg.gradient_solve_lanes(*x6, part, lin_specs, lin_arrays)
    for i, (g, w) in enumerate(zip(split, want6)):
        _assert_close(g, w, dtype, scaled=i > 2)


def test_planner_optimize_on_kernels_matches_plain(dev):
    """The planner under the defaults on the card runs K5 and K6 once per
    iteration (K1 and K3 phi at init) and the separate path K1-K3; both
    equal the plain path on 6 restarts (float64, rtol 1e-9, the same
    accepted steps)."""
    from dataclasses import replace

    from gaussianvi_tpu_torch import GVIConfig, optimize
    from gaussianvi_tpu_torch.kernels import launch_counts, reset_launch_counts

    graph, state = _planner(torch.float64, dev)
    cfg = GVIConfig(niters=6, niters_lowtemp=4, step_size_base=0.9,
                    temperature=0.1, high_temperature=1.0)
    reset_launch_counts()
    _, hk = optimize(graph, state, cfg)
    counts = launch_counts()
    assert counts["fused_trials"] == counts["fused_gradient"] == 6
    assert counts["gbp_covariance_logdet"] > 0 and counts["quad_phi"] > 0
    reset_launch_counts()
    _, hs = optimize(graph, state, replace(cfg, fused_trials="off",
                                           fused_gradient="off"))
    counts = launch_counts()
    assert all(counts[k] > 0 for k in ("gbp_covariance_logdet", "solve",
                                       "quad_phi", "quad_moments"))
    _, hp = optimize(graph, state, replace(cfg, chain_impl="seq",
                                           quad_impl="xla"))
    for h in (hk, hs):
        torch.testing.assert_close(h.cost, hp.cost, rtol=1e-9, atol=0)
        assert torch.equal(h.accepted_step, hp.accepted_step)


# ---------------------------------------------------------------------------
# s = 6: the 3-D point planner's cost functor (Sdf3dCost) in K3, K5 and K6,
# and the three s = 6 models on the kernels
# ---------------------------------------------------------------------------

def _point3d(dtype, dev, n=8, count=6, seed=0):
    """The 3-D point planner's graph with ``count`` restarts on the card:
    ``(graph_b, state_b)``, the means jittered around the straight line
    (through the obstacle)."""
    from gaussianvi_tpu_torch.examples.point3d_planning import (
        build_point3d_planning,
    )
    from gaussianvi_tpu_torch.inference.graph import GaussianState
    from gaussianvi_tpu_torch.ops.blocktridiag import BlockTridiag
    from gaussianvi_tpu_torch.parallel.restarts import _batch_graph

    graph, init, _, _ = build_point3d_planning(num_states=n, dtype=dtype,
                                               device=dev)
    rng = np.random.default_rng(seed)
    mu = init.mu + torch.tensor(0.4 * rng.standard_normal((count, n, 6)),
                                dtype=dtype, device=dev)
    prec = init.precision
    state = GaussianState(mu, BlockTridiag(
        prec.diag.expand(count, n, 6, 6).clone(),
        prec.off.expand(count, n - 1, 6, 6).clone()))
    return _batch_graph(graph, count), state


def _point3d_marginals(count, dtype, dev, seed=0):
    """Factor marginals over every kind of point the 3-D cost meets: clear
    of the box (E[phi] exactly 0), inside it, off the field past each
    face, on the field's last plane, row and column, on grid nodes."""
    rng = np.random.default_rng(seed)
    cell = 10.0 / 49

    def pos(x, y, z):
        return np.c_[x, y, z, rng.standard_normal((count, 3))]

    u = lambda lo, hi: rng.uniform(lo, hi, (count, 1))  # noqa: E731
    full = lambda v: np.full((count, 1), v)  # noqa: E731
    kinds = [pos(u(-3, 13), u(-3, 13), u(-3, 13)),
             pos(u(4, 6), u(3, 5), u(2, 7)),
             pos(full(10.0), u(0, 10), u(0, 10)),
             pos(u(0, 10), full(10.0), u(0, 10)),
             pos(u(0, 10), u(0, 10), full(10.0)),
             np.c_[cell * rng.integers(0, 50, (count, 3)),
                   np.zeros((count, 3))],
             np.tile([1.0, 1.0, 4.5, 0.5, 0.5, 0.0], (count, 1))]
    mu = np.stack(kinds, 1)                                   # [count, 7, 6]
    a = 0.2 * rng.standard_normal((*mu.shape, 6))
    cov = a @ np.swapaxes(a, -1, -2) + 0.01 * np.eye(6)
    cov[:, -1] = 0.001 * np.eye(6)
    t = lambda x: torch.tensor(x, dtype=dtype, device=dev)  # noqa: E731
    return t(mu), t(cov)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("with_moments", [False, True])
def test_sdf3d_quad_kernel_matches_plain(dev, with_moments, dtype):
    """K3 (both variants) with the 3-D SDF cost at d = 6 against its plain
    version, twice for the same bits; exact zeros (all-clear factors) in
    the same places, never NaN."""
    from gaussianvi_tpu_torch.kernels import quad

    graph, _ = _point3d(dtype, dev)
    fb = graph.nonlinear[0]
    mu, cov = _point3d_marginals(5, dtype, dev)
    args = (mu, cov, fb.nodes, fb.weights, "sdf3d", fb.kernel_params[0, 0])
    if with_moments:
        got = _twice(lambda: quad.quad_lanes_moments(
            *args, rdim=fb.quad_rdim, field=fb.kernel_field))
        want = quad.quad_moments_plain(*args, rdim=fb.quad_rdim,
                                       field=fb.kernel_field)
    else:
        got = _twice(lambda: (quad.quad_lanes_phi(
            *args, nonneg=True, field=fb.kernel_field),))
        want = (quad.quad_phi_plain(*args, nonneg=True,
                                    field=fb.kernel_field),)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_close(g, w, dtype, scaled=i > 0)
    assert torch.equal(got[0] == 0, want[0] == 0)
    assert (want[0][:, -1] == 0).all() and not torch.isnan(got[0]).any()
    assert (want[0][:, 1] > 0).all()
    with pytest.raises(ValueError, match="carries none"):
        quad.quad_lanes_phi(*args, nonneg=True)
    with pytest.raises(ValueError, match="3-D field"):
        quad.quad_lanes_phi(*args, nonneg=True, field=fb.kernel_field[0])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sdf3d_fused_kernels_match_plain(dev, dtype):
    """K5, K6 ``full`` and the split pair (``accum`` on each half of the
    obstacle factors, ``solve`` on their sum) on the 3-D point planner's
    graph (s = 6) against their plain versions, twice for the same
    bits."""
    from gaussianvi_tpu_torch.inference.engine import fused_operands
    from gaussianvi_tpu_torch.kernels import fused_gradient as fg
    from gaussianvi_tpu_torch.kernels import fused_trials as ft

    graph, state = _point3d(dtype, dev)
    ops = fused_operands(graph)
    b, n, s = state.mu.shape
    rng = np.random.default_rng(1)

    def t(a):
        return torch.tensor(a, dtype=dtype, device=dev)

    q = rng.standard_normal((b, n, s, s))
    dq = rng.standard_normal((b, n, s, s))
    pd = t(10.0 * np.eye(s) + 0.5 * q @ np.swapaxes(q, -1, -2))
    po = t(0.5 * rng.standard_normal((b, n - 1, s, s)))
    x5 = (state.mu, t(0.5 * rng.standard_normal((b, n, s))), pd, po,
          t(0.5 * (dq + np.swapaxes(dq, -1, -2))),
          t(0.5 * rng.standard_normal((b, n - 1, s, s))),
          t(0.9 * 0.75 ** np.arange(1, 12)))
    got5 = _twice(lambda: (lambda ld, fc: (ld, *fc))(
        *ft.trial_costs_lanes(*x5, *ops)))
    want5 = ft.trial_costs_plain(*x5, *ops)
    if dtype == torch.float64:
        _assert_close(got5[0], want5[0], dtype)
    else:
        torch.testing.assert_close(got5[0], want5[0], rtol=1e-5, atol=0,
                                   equal_nan=True)
    for g, w in zip(got5[1:], want5[1]):
        _assert_close(g, w, dtype)
    assert (want5[1][0] == 0).any() and (want5[1][0] > 0).any()
    x6 = (state.mu, pd, po, torch.full((b,), 0.5, dtype=dtype, device=dev))
    got6 = _twice(lambda: fg.gradient_lanes(*x6, *ops))
    want6 = fg.gradient_plain(*x6, *ops)
    for i, (g, w) in enumerate(zip(got6, want6)):
        _assert_close(g, w, dtype, scaled=i > 2)
    nl_specs, lin_specs, nl_arrays, lin_arrays = ops
    sp, (start, nodes, weights, params, field) = nl_specs[0], nl_arrays[0]
    k = sp.k // 2
    total = None
    for i in range(2):
        half = ((sp._replace(k=k, slice_offset=None),),
                ((start[i * k:(i + 1) * k], nodes, weights,
                  params[:, i * k:(i + 1) * k], field),))
        got = _twice(lambda: fg.gradient_accum_lanes(*x6, *half))
        want = fg.gradient_plain(*x6, half[0], (), half[1], (), mode="accum")
        for g, w in zip(got, want):
            _assert_close(g, w, dtype, scaled=True)
        total = [t.clone() for t in got] if total is None else [
            a + b for a, b in zip(total, got)]
    got = _twice(lambda: fg.gradient_solve_lanes(*x6, total, lin_specs,
                                                 lin_arrays))
    want = fg.gradient_plain(*x6, (), lin_specs, (), lin_arrays,
                             mode="solve", seeds=total)
    for i, (g, w, f) in enumerate(zip(got, want, got6)):
        _assert_close(g, w, dtype, scaled=i > 2)
        if dtype == torch.float64:
            _assert_close(g, f, dtype, scaled=i > 2)


def test_s6_models_on_kernels_match_plain(dev):
    """The three s = 6 models under the defaults on the card, against the
    plain path (float64, rtol 1e-9, the same accepted steps): the 3-D
    point planner on K5 / K6 once per iteration (K1 and K3 phi at init)
    and on the separate kernels; chain estimation at dim_x = 3 on K5 / K6;
    the quadrotor on K1 / K2 with the plain quadrature."""
    from dataclasses import replace

    from gaussianvi_tpu_torch import GVIConfig, optimize
    from gaussianvi_tpu_torch.examples.quadrotor_planning import (
        build_quadrotor_planning,
    )
    from gaussianvi_tpu_torch.inference.graph import GaussianState
    from gaussianvi_tpu_torch.kernels import launch_counts, reset_launch_counts
    from gaussianvi_tpu_torch.ops.blocktridiag import BlockTridiag
    from gaussianvi_tpu_torch.parallel.restarts import _batch_graph

    f64 = torch.float64
    cfg = GVIConfig(niters=6, niters_lowtemp=4, step_size_base=0.9,
                    temperature=0.1, high_temperature=1.0)
    qg, qi, qcfg, _ = build_quadrotor_planning(device=dev)
    quad_state = GaussianState(qi.mu.expand(3, *qi.mu.shape).clone(),
                               BlockTridiag(
                                   qi.precision.diag.expand(3, 12, 6, 6),
                                   qi.precision.off.expand(3, 11, 6, 6)))
    fused = {"fused_trials", "fused_gradient", "gbp_covariance_logdet",
             "quad_phi"}
    runs = [(*_point3d(f64, dev), cfg, fused),
            (*_point3d(f64, dev), replace(cfg, fused_trials="off",
                                           fused_gradient="off"),
             {"gbp_covariance_logdet", "solve", "quad_phi", "quad_moments"}),
            (*_flagship(8, 3, f64, dev), cfg, fused),
            (_batch_graph(qg, 3), quad_state, qcfg,
             {"gbp_covariance_logdet", "solve"})]
    for graph, state, config, kernels in runs:
        reset_launch_counts()
        _, hk = optimize(graph, state, config)
        counts = launch_counts()
        assert {k for k, v in counts.items() if v} == kernels, counts
        if "fused_trials" in kernels:
            assert counts["fused_trials"] == counts["fused_gradient"] == \
                config.niters
        _, hp = optimize(graph, state, replace(config, chain_impl="seq",
                                               quad_impl="xla"))
        torch.testing.assert_close(hk.cost, hp.cost, rtol=1e-9, atol=0)
        assert torch.equal(hk.accepted_step, hp.accepted_step)


# ---------------------------------------------------------------------------
# s = 14 and s = 1: the arm planner and the Barfoot 1-D example on K1 / K2
# ---------------------------------------------------------------------------

def test_s14_s1_models_on_kernels_match_plain(dev):
    """The arm planner (N = 10, s = 14, four restarts) under the defaults
    on K1 / K2 and its K3 instance against the plain path over all 15
    iterations (f64, rtol 1e-9, the same steps), and the Barfoot example
    (s = 1) on K1 / K2 against the golden trajectories (atol 1e-9)."""
    from dataclasses import replace

    from gaussianvi_tpu_torch import optimize
    from gaussianvi_tpu_torch.examples.arm_planning import build_arm_planning
    from gaussianvi_tpu_torch.examples.barfoot_1d import run_barfoot_1d
    from gaussianvi_tpu_torch.inference.graph import GaussianState
    from gaussianvi_tpu_torch.kernels import launch_counts, reset_launch_counts
    from gaussianvi_tpu_torch.ops.blocktridiag import BlockTridiag

    graph, init, cfg, _ = build_arm_planning(device=dev)
    noise = 0.3 * np.random.default_rng(1).standard_normal((4, 10, 14))
    noise[0] = 0.0
    prec = init.precision
    state = GaussianState(
        init.mu + torch.tensor(noise, device=dev),
        BlockTridiag(prec.diag.expand(4, 10, 14, 14).clone(),
                     prec.off.expand(4, 9, 14, 14).clone()))
    reset_launch_counts()
    _, hk = optimize(graph, state, cfg)
    assert {k for k, v in launch_counts().items() if v} == {
        "gbp_covariance_logdet", "gbp_trials", "solve", "quad_arm_phi",
        "quad_arm_moments"}
    _, hp = optimize(graph, state, replace(cfg, chain_impl="seq",
                                           quad_impl="xla"))
    torch.testing.assert_close(hk.cost, hp.cost, rtol=1e-9, atol=0)
    assert torch.equal(hk.accepted_step, hp.accepted_step)
    # tests/test_golden_1d.py REF_NGD_MEAN[-1], REF_NGD_COST[-1]
    reset_launch_counts()
    _, hb = run_barfoot_1d("ngd", device=dev)
    assert launch_counts()["solve"] == 10
    assert abs(float(hb.mu[-1, 0, 0]) - 23.798263483531) < 1e-9
    assert abs(float(hb.cost[-1]) - 1.7901555302211) < 1e-9


# ---------------------------------------------------------------------------
# the log-depth chain and the sequence-parallel loop on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [2, 4, 6])
def test_assoc_matches_chain_kernels(dev, s):
    """``gbp_covariance_logdet_assoc`` and ``solve_assoc`` (torch ops on
    the card) against K1 and K2 on the same chains, float64."""
    from gaussianvi_tpu_torch.kernels import chain
    from gaussianvi_tpu_torch.ops import parallel_chain as pc
    from gaussianvi_tpu_torch.ops.blocktridiag import BlockTridiag

    diag, off, rhs = _chains(64, 33, s, seed=s, dev=dev)
    got = pc.gbp_covariance_logdet_assoc(BlockTridiag(diag, off))
    want = chain.gbp_covariance_logdet_lanes(diag, off)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=ATOL)
    x = pc.solve_assoc(BlockTridiag(diag, off), rhs)
    torch.testing.assert_close(x, chain.solve_lanes(diag, off, rhs), rtol=0,
                               atol=ATOL)


def test_one_rank_sp_mesh_on_the_card(dev):
    """``optimize_time_sharded`` on a one-rank sp mesh on the card: no
    collective, the same bits twice, and the local run with the log-depth
    chain (``chain_impl="assoc"``) to 1e-9 with the same accepted steps
    (the segment's scan composes one more, padded, element than the local
    scan: the two differ by reassociation).  With ``quad_impl="lanes"`` it
    launches K3 and agrees with the plain quadrature's run."""
    from gaussianvi_tpu_torch import GVIConfig, optimize, parallel
    from gaussianvi_tpu_torch.examples.chain_estimation import (
        build_chain_estimation,
    )
    from gaussianvi_tpu_torch.kernels import quad

    graph, init, _ = build_chain_estimation(num_states=64, dim_x=2,
                                            gh_degree=4, seed=0, device=dev)
    chain_graph = parallel.to_chain_layout(graph)
    cfg = GVIConfig(niters=6, step_size_base=0.9)
    mesh = parallel.make_mesh(1, 1, sp=1)
    runs = [parallel.optimize_time_sharded(chain_graph, init, cfg, mesh)
            for _ in range(2)]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)
    assert not mesh.inventory
    _, local = optimize(graph, init, GVIConfig(niters=6, step_size_base=0.9,
                                               chain_impl="assoc"))
    hist = runs[0][1]
    torch.testing.assert_close(hist.cost, local.cost, rtol=1e-9, atol=0)
    assert torch.equal(hist.accepted_step, local.accepted_step)
    before = quad.quad_lanes_phi.launches
    _, lanes = parallel.optimize_time_sharded(
        chain_graph, init, GVIConfig(niters=6, step_size_base=0.9,
                                     quad_impl="lanes"), mesh)
    assert quad.quad_lanes_phi.launches > before
    torch.testing.assert_close(lanes.cost, hist.cost, rtol=1e-9, atol=0)
    assert torch.equal(lanes.accepted_step, hist.accepted_step)


class _SameDraws:
    """One set of sampler draws (``samplers/_draws.py``), made with numpy
    from a seed and handed over on any device."""

    def __init__(self, seed, chains, dim, transitions, depth, moves):
        rng = np.random.default_rng(seed)
        width = 1 << max(depth - 1, 0)
        self.arrays = dict(
            normal=rng.standard_normal((chains, transitions, dim)),
            uniform=rng.uniform(size=(chains, transitions)),
            forward=rng.uniform(size=(chains, transitions, depth)) < 0.5,
            swap=rng.uniform(size=(chains, transitions, depth)),
            tree=rng.uniform(size=(chains, transitions, depth, width)),
            res=rng.uniform(size=transitions),
            momenta=rng.standard_normal((transitions, moves, chains, dim)),
            accept=rng.uniform(size=(transitions, moves, chains)))
        self.device = torch.device("cpu")

    def __getattr__(self, name):
        return torch.as_tensor(self.__dict__["arrays"][name],
                               device=self.__dict__["device"])

    def hmc(self, t):
        return self.normal[:, t], self.uniform[:, t]

    def nuts_momentum(self, t):
        return self.normal[:, t]

    def nuts_depth(self, t, depth, count):
        return (self.forward[:, t, depth], self.swap[:, t, depth],
                self.tree[:, t, depth, :count])

    def smc_stage(self, stage, moves):
        return self.res[stage], self.momenta[stage], self.accept[stage]


@pytest.mark.parametrize("sampler", ["hmc", "nuts iterative", "nuts unrolled",
                                     "smc"])
def test_samplers_on_the_card_match_the_cpu(dev, sampler):
    """The samplers on the flagship (N = 8) on the card against the CPU on
    the same draws (float64): samples within 1e-10, the same accept
    decisions; the entry points keep the card's tensors on the card."""
    from gaussianvi_tpu_torch.examples.chain_estimation import (
        build_chain_estimation,
    )
    from gaussianvi_tpu_torch.inference.graph import FactorGraph
    from gaussianvi_tpu_torch.samplers import make_log_density, run_chains
    from gaussianvi_tpu_torch.samplers.hmc import _run_hmc
    from gaussianvi_tpu_torch.samplers.nuts import _run_nuts
    from gaussianvi_tpu_torch.samplers.smc import _run_smc

    chains, n = (64, 8) if sampler == "smc" else (4, 8)
    draws = _SameDraws(1, chains, 4 * n, 20, 4, 2)
    out = {}
    for where in (torch.device("cpu"), dev):
        graph, init, _ = build_chain_estimation(num_states=n, dim_x=2,
                                                device=where)
        x0 = init.mu.reshape(1, -1) + 0.01 * torch.as_tensor(
            np.random.default_rng(2).standard_normal((chains, 4 * n)),
            device=where)
        ld = make_log_density(graph, n, 4)
        draws.device = where
        if sampler == "hmc":
            # a short warmup from a small step: longer ones feed rounding
            # through dual averaging (10 from 0.01: a 1e-15 nudge of x0
            # moves the CPU run by 5e-9; 5 from 0.003: 2e-15)
            out[where.type] = _run_hmc(ld, x0, draws, 15, 5, 12, 0.003, 0.8,
                                       1.0)
        elif sampler.startswith("nuts"):
            out[where.type] = _run_nuts(ld, x0, draws, 5, 5, 4, 0.01, 0.8,
                                        sampler.split()[1])
        else:
            ref = FactorGraph(num_states=n, state_dim=4, linear=graph.linear)
            delta = FactorGraph(num_states=n, state_dim=4,
                                nonlinear=graph.nonlinear)
            out[where.type] = _run_smc(make_log_density(ref, n, 4),
                                       make_log_density(delta, n, 4), x0,
                                       draws, 0.9, 0.003, 8, 2, 2)
    cpu, card = out["cpu"], out["cuda"]
    got, want = (card.particles, cpu.particles) if sampler == "smc" else (
        card.samples, cpu.samples)
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-10)
    if sampler == "smc":
        assert int(card.num_stages) == int(cpu.num_stages) == 2
        assert abs(float(card.log_evidence) - float(cpu.log_evidence)) < 1e-10
    else:
        def moved(s):
            return torch.diff(s.cpu(), dim=1).abs().amax(-1) > 0
        assert torch.equal(moved(got), moved(want))
    gen = torch.Generator(device=dev).manual_seed(0)
    res = run_chains(ld, x0[:2], gen, num_samples=3, num_warmup=2,
                     num_leapfrog=2, init_step_size=0.01)
    assert res.samples.device.type == "cuda" and res.samples.shape[:2] == (2, 3)


# ---------------------------------------------------------------------------
# the planners' patch mode: the window functors in K3 and K6
# ---------------------------------------------------------------------------

def _patch_planner(name, dtype, dev, patch=4):
    """The planar (``name="planar"``) or 3-D point planner in the patch
    mode with the restarts of :func:`_planner` / :func:`_point3d`, windows
    of ``patch`` cells so that the clamp bites: ``(graph_b, state_b)``."""
    from gaussianvi_tpu_torch.examples.planar_planning import (
        build_planar_planning,
    )
    from gaussianvi_tpu_torch.examples.point3d_planning import (
        build_point3d_planning,
    )
    from gaussianvi_tpu_torch.parallel.restarts import _batch_graph

    _, state = (_planner if name == "planar" else _point3d)(dtype, dev)
    build = (build_planar_planning if name == "planar"
             else build_point3d_planning)
    graph = build(num_states=state.mu.shape[1], patch_size=patch,
                  dtype=dtype, device=dev)[0]
    return _batch_graph(graph, state.mu.shape[0]), state


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("with_moments", [False, True])
@pytest.mark.parametrize("name", ["planar", "point3d"])
def test_window_quad_kernel_matches_plain(dev, name, with_moments, dtype):
    """K3 (both variants) with the patch mode's functors
    (``PlanarPatchCost``, ``Sdf3dPatchCost``) on params their prep forms
    from the means, against the plain forms, twice for the same bits;
    exact zeros in the same places, never NaN; K4 has no instance of
    them (the patch mode's batches have no block form, as in the JAX
    package)."""
    from gaussianvi_tpu_torch.kernels import fused_moments, quad

    graph, _ = _patch_planner(name, dtype, dev)
    fb = graph.nonlinear[0]
    mu, cov = (_planner_marginals if name == "planar"
               else _point3d_marginals)(5, dtype, dev)
    cov = 25.0 * cov       # sigma points well outside 4-cell windows
    args = (mu, cov, fb.nodes, fb.weights, fb.kernel_cost,
            fb.kernel_prep(mu))
    if with_moments:
        got = _twice(lambda: quad.quad_lanes_moments(
            *args, field=fb.kernel_field))
        want = quad.quad_moments_plain(*args, field=fb.kernel_field)
    else:
        got = _twice(lambda: (quad.quad_lanes_phi(
            *args, nonneg=True, field=fb.kernel_field),))
        want = (quad.quad_phi_plain(*args, nonneg=True,
                                    field=fb.kernel_field),)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_close(g, w, dtype, scaled=i > 0)
    assert torch.equal(got[0] == 0, want[0] == 0)
    assert not torch.isnan(got[0]).any() and (want[0] > 0).any()
    with pytest.raises(ValueError, match="no kernel instantiated"):
        fused_moments.fused_moments(fb.nodes, fb.weights, mu, cov,
                                    fb.kernel_cost, args[-1],
                                    field=fb.kernel_field)


def _backward_error(x, ref, diag, off):
    """Backward error of a solution ``x`` of the block-tridiagonal system
    ``A = (diag, off)`` whose solution is ``ref``, per problem, in float64:
    ``||A (x - ref)|| / (||A|| ||x|| + ||A ref||)`` (Frobenius norms of
    the blocks); the largest over the problems where both are finite."""
    x, ref, diag, off = (t.double() for t in (x, ref, diag, off))

    def matvec(v):
        y = torch.einsum("bnij,bnj->bni", diag, v)
        y[:, :-1] += torch.einsum("bnij,bnj->bni", off, v[:, 1:])
        y[:, 1:] += torch.einsum("bnji,bnj->bni", off, v[:, :-1])
        return y

    rows = (torch.isfinite(x).flatten(1).all(1)
            & torch.isfinite(ref).flatten(1).all(1))
    norm_a = (diag.flatten(1).norm(dim=1) ** 2
              + 2 * off.flatten(1).norm(dim=1) ** 2).sqrt()
    err = (matvec(x - ref).flatten(1).norm(dim=1)
           / (norm_a * x.flatten(1).norm(dim=1)
              + matvec(ref).flatten(1).norm(dim=1)))
    return float(err[rows].max()) if rows.any() else 0.0


def _to64(tree):
    """Every floating-point tensor of a nested tuple in float64 (the
    specs, named tuples of ints, as they are)."""
    if isinstance(tree, torch.Tensor):
        return tree.double() if tree.is_floating_point() else tree
    if isinstance(tree, tuple) and not hasattr(tree, "_fields"):
        return tuple(_to64(x) for x in tree)
    return tree


def _close_vs_f64(got, want, want64):
    """A float32 kernel output held to the float64 plain version on the
    same inputs as well as the float32 plain version is (``chip_smoke.py``
    ``compare_vs_f64``): no more NaNs that differ from float64's, and an
    error against float64 at most 4 times the plain version's plus 1e-6
    of the output's range (sums over the 41- and 85-node rules cancel)."""
    nan64 = torch.isnan(want64)
    assert int((torch.isnan(got) != nan64).sum()) <= int(
        (torch.isnan(want) != nan64).sum())
    fin = torch.isfinite(got) & torch.isfinite(want) & torch.isfinite(want64)
    ref = want64[fin]
    err_k = float((got.double()[fin] - ref).abs().max())
    err_p = float((want.double()[fin] - ref).abs().max())
    assert err_k <= 4 * err_p + 1e-6 * float(ref.abs().max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["planar", "point3d"])
def test_window_gradient_kernels_match_plain(dev, name, dtype):
    """K6 ``full`` and ``accum`` (each half of the obstacle factors) with
    the patch mode's functors, the windows formed from the iterate's
    means as the engine forms them, against the plain versions, twice for
    the same bits; K5 refuses the window costs.  float32 is held as
    ``chip_smoke.py`` holds it (:func:`_close_vs_f64`; the main solve's
    ``dmu`` by its backward error in the float64 plain version's system:
    on the rows where ``Vddmu`` is nearly singular a forward bound says
    nothing in float32)."""
    from gaussianvi_tpu_torch.inference.engine import fused_operands
    from gaussianvi_tpu_torch.inference.graph import take_states
    from gaussianvi_tpu_torch.kernels import fused_gradient as fg
    from gaussianvi_tpu_torch.kernels import fused_trials as ft

    graph, state = _patch_planner(name, dtype, dev)
    nl_specs, lin_specs, nl_arrays, lin_arrays = fused_operands(
        graph, trials=False)
    fb = graph.nonlinear[0]
    start, nodes, weights, _, field = nl_arrays[0]
    params = fb.kernel_prep(take_states(state.mu, start, fb.slice_offset, 1))
    nl_arrays = ((start, nodes, weights, params, field),)
    b, n, s = state.mu.shape
    rng = np.random.default_rng(2)
    q = rng.standard_normal((b, n, s, s))
    pd = torch.tensor(10.0 * np.eye(s) + 0.5 * q @ np.swapaxes(q, -1, -2),
                      dtype=dtype, device=dev)
    po = torch.tensor(0.5 * rng.standard_normal((b, n - 1, s, s)),
                      dtype=dtype, device=dev)
    x6 = (state.mu, pd, po, torch.full((b,), 0.5, dtype=dtype, device=dev))
    ops = (nl_specs, lin_specs, nl_arrays, lin_arrays)
    sp, k = nl_specs[0], nl_specs[0].k // 2
    halves = [((sp._replace(k=k, slice_offset=None),),
               ((start[i * k:(i + 1) * k], nodes, weights,
                 params[:, i * k:(i + 1) * k], field),)) for i in range(2)]
    runs = [(lambda: fg.gradient_lanes(*x6, *ops),
             lambda x, o: fg.gradient_plain(*x, *o), ops)]
    runs += [(lambda h=h: fg.gradient_accum_lanes(*x6, *h),
              lambda x, h: fg.gradient_plain(*x, h[0], (), h[1], (),
                                             mode="accum"), h)
             for h in halves]
    for kern, plain, operands in runs:
        got = _twice(kern)
        want = plain(x6, operands)
        want64 = plain(_to64(x6), _to64(operands))
        for i, (g, w, w64) in enumerate(zip(got, want, want64)):
            if dtype == torch.float64:
                _assert_close(g, w, dtype)
            elif len(got) == 7 and i == 5:
                assert torch.equal(torch.isnan(g), torch.isnan(w64))
                assert _backward_error(g, w64, want64[3] + pd.double(),
                                       want64[4] + po.double()) < 1e-5
            else:
                _close_vs_f64(g, w, w64)
    x5 = (state.mu, torch.zeros_like(state.mu), pd, po, torch.zeros_like(pd),
          torch.zeros_like(po), torch.ones(2, dtype=dtype, device=dev))
    with pytest.raises(ValueError, match="trial kernel"):
        ft.trial_costs_lanes(*x5, *ops)


def test_patch_planner_on_kernels_matches_plain(dev):
    """The 3-D point planner in the patch mode under the defaults on the
    card (K3 phi and K6 ``full`` once an iteration, K5 never) against the
    same routes' plain versions on the CPU (float64, rtol 1e-9, the same
    accepted steps)."""
    from dataclasses import replace

    from gaussianvi_tpu_torch import optimize
    from gaussianvi_tpu_torch.examples.point3d_planning import (
        build_point3d_planning,
    )
    from gaussianvi_tpu_torch.inference.engine import LocalEngine
    from gaussianvi_tpu_torch.inference.graph import GaussianState
    from gaussianvi_tpu_torch.inference.optimize import run_gvi
    from gaussianvi_tpu_torch.kernels import launch_counts, reset_launch_counts
    from gaussianvi_tpu_torch.ops.blocktridiag import BlockTridiag
    from gaussianvi_tpu_torch.parallel.restarts import _batch_graph

    runs = {}
    for where in (dev, torch.device("cpu")):
        graph, init, cfg, _ = build_point3d_planning(
            num_states=8, patch_size=4, device=where)
        cfg = replace(cfg, niters=8, niters_lowtemp=6)
        prec = init.precision
        rng = np.random.default_rng(4)
        state = GaussianState(
            init.mu + torch.tensor(0.3 * rng.standard_normal((3, 8, 6)),
                                   device=where),
            BlockTridiag(prec.diag.expand(3, 8, 6, 6).clone(),
                         prec.off.expand(3, 7, 6, 6).clone()))
        graph = _batch_graph(graph, 3)
        if where.type == "cuda":
            reset_launch_counts()
            runs["cuda"] = optimize(graph, state, cfg)[1]
            counts = launch_counts()
        else:
            runs["cpu"] = run_gvi(LocalEngine(graph, cfg, dev), state,
                                  cfg)[1]
    assert counts["fused_gradient"] == 8 and counts["fused_trials"] == 0
    assert counts["quad_phi"] > 8 and counts["gbp_covariance_logdet"] > 8
    got, want = runs["cuda"], runs["cpu"]
    torch.testing.assert_close(got.cost.cpu(), want.cost, rtol=1e-9, atol=0)
    assert torch.equal(got.accepted_step.cpu(), want.accepted_step)


# ---------------------------------------------------------------------------
# the loop replayed as a CUDA graph (inference/loop_graph.py)
# ---------------------------------------------------------------------------

def _graph_chain(k, dev):
    """Problem set ``k`` of ``chain_est``'s shape: 64 range chains of N =
    32, s = 4, float32, 10 iterations."""
    from gaussianvi_tpu_torch import GVIConfig, stack_problems
    from gaussianvi_tpu_torch.examples.chain_estimation import (
        build_chain_estimation,
    )

    problems = [build_chain_estimation(num_states=32, dim_x=2, gh_degree=4,
                                       seed=64 * k + i, dtype=torch.float32,
                                       device=dev)[:2] for i in range(64)]
    graph, state = stack_problems(*map(list, zip(*problems)))
    return graph, state, GVIConfig(niters=10, niters_lowtemp=10,
                                   step_size_base=0.9)


def _graph_plan(k, dev):
    """Problem set ``k`` of ``point3d_plan``'s shape: one plan request
    (endpoints moved by set), 64 restarts of N = 20, s = 6, float32, 30
    iterations across the scheduled switch at 20."""
    from gaussianvi_tpu_torch.examples.point3d_planning import (
        build_point3d_planning,
    )
    from gaussianvi_tpu_torch.inference.graph import GaussianState
    from gaussianvi_tpu_torch.ops.blocktridiag import BlockTridiag
    from gaussianvi_tpu_torch.parallel.restarts import _batch_graph

    shift = 0.25 * k
    graph, init, cfg, _ = build_point3d_planning(
        num_states=20, start=(1.0 + shift, 1.0, 4.5),
        goal=(8.5, 8.5 - shift, 4.5), dtype=torch.float32, device=dev)
    rng = np.random.default_rng(k)
    noise = 0.4 * rng.standard_normal((64, 20, 6))
    noise[0] = 0.0
    prec = init.precision
    state = GaussianState(
        init.mu + torch.tensor(noise, dtype=torch.float32, device=dev),
        BlockTridiag(prec.diag.expand(64, 20, 6, 6).clone(),
                     prec.off.expand(64, 19, 6, 6).clone()))
    return _batch_graph(graph, 64), state, cfg


def _graph_resumed(k, dev):
    """``chain_est``'s shape over 24 iterations, resumed at iteration 1
    from the per-problem loop values there: the window holds the late
    escalations and the convergence freezes."""
    from dataclasses import replace

    from gaussianvi_tpu_torch.inference.engine import LocalEngine
    from gaussianvi_tpu_torch.inference.optimize import run_gvi_carry

    graph, state, cfg = _graph_chain(k, dev)
    cfg = replace(cfg, niters=24, niters_lowtemp=24)
    with torch.no_grad():
        carry, _ = run_gvi_carry(LocalEngine(graph, cfg, dev), state,
                                 replace(cfg, niters=1))
    loop = (carry.temperature, carry.is_lowtemp, carry.converged)
    return graph, carry.state, cfg, 1, loop


def _graph_with(make, **fields):
    """``make``'s problem sets under ``fields`` of their config."""
    from dataclasses import replace

    def made(k, dev):
        graph, state, cfg, *rest = make(k, dev)
        return (graph, state, replace(cfg, **fields), *rest)

    return made


_SEPARATE = {"fused_trials": "off", "fused_gradient": "off"}
LOOP_GRAPH_CASES = {
    "chain_est": _graph_chain, "point3d_plan": _graph_plan,
    "resumed": _graph_resumed,
    "separate": _graph_with(_graph_chain, **_SEPARATE),
    "point3d separate": _graph_with(_graph_plan, **_SEPARATE),
    "block-form K4": _graph_with(_graph_chain, use_pallas=True,
                                 fused_gradient="off"),
    "bfloat16 offsets": _graph_with(_graph_chain,
                                    moments_eval_dtype="bfloat16"),
    "ema": _graph_with(_graph_chain, ema_alpha=0.7),
    "assoc chain": _graph_with(_graph_chain, chain_impl="assoc",
                               quad_impl="lanes"),
    "seq chain": _graph_with(_graph_chain, chain_impl="seq",
                             quad_impl="lanes"),
}
# the kernels each case's route launches, and those it does not
_FUSED = {"fused_trials", "fused_gradient"}
LOOP_GRAPH_ROUTES = {
    "separate": ({"quad_phi", "quad_moments", "solve"}, _FUSED),
    "point3d separate": ({"quad_phi", "quad_moments", "solve"}, _FUSED),
    "block-form K4": ({"fused_moments", "fused_trials"}, {"fused_gradient"}),
    "assoc chain": (_FUSED, {"gbp_covariance_logdet", "solve"}),
    "seq chain": (_FUSED, {"gbp_covariance_logdet", "solve"}),
}


def _bits(x):
    """``x``'s bits as integers (NaNs compare by their bits)."""
    return x if x.dtype == torch.bool else x.view(
        {4: torch.int32, 8: torch.int64}[x.element_size()])


def _assert_same_bits(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(_bits(a), _bits(b))


def _flat_outputs(out):
    state, hist, loop = out
    return (state.mu, state.precision.diag, state.precision.off, *hist,
            *loop)


@pytest.mark.parametrize("case", list(LOOP_GRAPH_CASES))
def test_loop_graph_replays_the_eager_loop_to_the_bit(dev, case):
    """Three calls on problem sets A, B, A: the first runs eager, the
    second captures the loop into a CUDA graph and replays it, the third
    replays it.  Each call's outputs (every history field, the final
    state, the loop values) equal the eager loop's on its own set bit for
    bit, the first call's are unchanged by the later replays, and the
    launch counts grow by the eager loop's launches on every call."""
    from gaussianvi_tpu_torch.inference import loop_graph
    from gaussianvi_tpu_torch.inference.engine import LocalEngine
    from gaussianvi_tpu_torch.inference.optimize import (
        LoopState,
        optimize_from,
        run_gvi_carry,
    )
    from gaussianvi_tpu_torch.kernels import (
        launch_counts,
        loop_graph_counts,
        reset_launch_counts,
    )
    from gaussianvi_tpu_torch.ops.precision import set_precision_policy

    sets = []
    for k in (0, 1):
        made = LOOP_GRAPH_CASES[case](k, dev)
        graph, state, cfg = made[:3]
        start, loop = made[3:] if len(made) > 3 else (0, None)
        sets.append((graph, state, cfg, start,
                     None if loop is None else LoopState(*loop)))
    set_precision_policy()
    eager, grown = [], []
    for graph, state, cfg, start, loop in sets:
        before = launch_counts()
        with torch.no_grad():
            carry, hist = run_gvi_carry(LocalEngine(graph, cfg, dev), state,
                                        cfg, "ngd", start, loop)
        after = launch_counts()
        grown.append({n: after[n] - before[n] for n in after})
        eager.append(_flat_outputs((carry.state, hist, LoopState(
            carry.temperature, carry.is_lowtemp, carry.converged))))
    if case == "resumed":
        # an escalation and a convergence freeze inside the window
        loop, (_, is_lowtemp, converged) = sets[0][4], eager[0][-3:]
        assert (loop.is_lowtemp & ~is_lowtemp).any()
        assert not loop.converged.any() and converged.any()
        assert not converged.all()
    if case == "point3d_plan":
        assert sets[0][2].niters_lowtemp < sets[0][2].niters
    launched, idle = LOOP_GRAPH_ROUTES.get(case, (_FUSED, set()))
    assert all(grown[0][n] > 0 for n in launched), grown[0]
    assert not any(grown[0][n] for n in idle), grown[0]

    loop_graph.clear()
    reset_launch_counts()
    kinds, outs, first = [], [], None
    for k in (0, 1, 0):
        graph, state, cfg, start, loop = sets[k]
        before, seen = launch_counts(), loop_graph_counts()
        out = _flat_outputs(optimize_from(graph, state, cfg, "ngd", start,
                                          loop))
        after, now = launch_counts(), loop_graph_counts()
        kinds += [n for n in now if now[n] > seen[n]]
        assert {n: after[n] - before[n] for n in after} == grown[k]
        _assert_same_bits(out, eager[k])
        outs.append(out)
        if first is None:
            first = tuple(x.clone() for x in out)
    assert kinds == ["eager", "captured", "replayed"]
    _assert_same_bits(outs[0], first)
    _assert_same_bits(outs[1], eager[1])


def _graph_sets(dev, *configs):
    """``chain_est``'s problem set 0 under each config of ``configs`` (a
    signature each) and the eager loop's outputs and launches on each."""
    from dataclasses import replace

    from gaussianvi_tpu_torch.inference.engine import LocalEngine
    from gaussianvi_tpu_torch.inference.optimize import LoopState, run_gvi_carry
    from gaussianvi_tpu_torch.kernels import launch_counts
    from gaussianvi_tpu_torch.ops.precision import set_precision_policy

    set_precision_policy()
    graph, state, base = _graph_chain(0, dev)
    out = []
    for fields in configs:
        cfg = replace(base, **fields)
        before = launch_counts()
        with torch.no_grad():
            carry, hist = run_gvi_carry(LocalEngine(graph, cfg, dev), state,
                                        cfg)
        after = launch_counts()
        out.append((cfg, _flat_outputs((carry.state, hist, LoopState(
            carry.temperature, carry.is_lowtemp, carry.converged))),
            {n: after[n] - before[n] for n in after}))
    return graph, state, out


def _graph_calls(graph, state, cfg, n):
    """``n`` ``optimize_from`` calls: each one's outputs, launches and
    kind (``loop_graph_counts()``' growth)."""
    from gaussianvi_tpu_torch.inference.optimize import optimize_from
    from gaussianvi_tpu_torch.kernels import launch_counts, loop_graph_counts

    calls = []
    for _ in range(n):
        before, seen = launch_counts(), loop_graph_counts()
        out = _flat_outputs(optimize_from(graph, state, cfg))
        after, now = launch_counts(), loop_graph_counts()
        calls.append((out, {k: after[k] - before[k] for k in after},
                      [k for k in now if now[k] > seen[k]]))
    return calls


def test_loop_graph_capture_that_raises_runs_eager(dev, monkeypatch):
    """A loop that waits for the card (an ``item()`` at its start) cannot
    be captured: the capturing call and every later one of its signature
    run eager, with the eager loop's bits and launches, and after it
    another signature captures and replays to the bit."""
    import importlib
    import warnings

    from gaussianvi_tpu_torch.inference import loop_graph
    from gaussianvi_tpu_torch.kernels import reset_launch_counts

    opt = importlib.import_module("gaussianvi_tpu_torch.inference.optimize")

    graph, state, ((cfg, want, grown), (cfg2, want2, grown2)) = _graph_sets(
        dev, {}, {"step_decay": 0.7})
    loop = opt._gvi_loop

    def waits(engine, init_state, *args):
        float(init_state.mu.sum())
        return loop(engine, init_state, *args)

    loop_graph.clear()
    reset_launch_counts()
    monkeypatch.setattr(opt, "_gvi_loop", waits)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        calls = _graph_calls(graph, state, cfg, 3)
    assert [w.category for w in caught] == [RuntimeWarning]
    for out, launches, kinds in calls:
        assert kinds == ["eager"] and launches == grown
        _assert_same_bits(out, want)
    monkeypatch.setattr(opt, "_gvi_loop", loop)
    calls = _graph_calls(graph, state, cfg2, 3)
    assert [k for _, _, (k,) in calls] == ["eager", "captured", "replayed"]
    for out, launches, _ in calls:
        assert launches == grown2
        _assert_same_bits(out, want2)
    loop_graph.clear()


def _graph_restarts(b, dev):
    """``b`` restarts of one problem of ``chain_est``'s shape (N = 32,
    s = 4, float32), their means drawn apart."""
    from gaussianvi_tpu_torch.examples.chain_estimation import (
        build_chain_estimation,
    )
    from gaussianvi_tpu_torch.inference.graph import GaussianState
    from gaussianvi_tpu_torch.ops.blocktridiag import BlockTridiag
    from gaussianvi_tpu_torch.parallel.restarts import _batch_graph

    graph, init = build_chain_estimation(num_states=32, dim_x=2, gh_degree=4,
                                         seed=0, dtype=torch.float32,
                                         device=dev)[:2]
    gen = torch.Generator(device=dev).manual_seed(b)
    mu = init.mu + 0.1 * torch.randn((b, *init.mu.shape), generator=gen,
                                     dtype=torch.float32, device=dev)
    prec = init.precision
    return _batch_graph(graph, b), GaussianState(mu, BlockTridiag(
        prec.diag.expand(b, *prec.diag.shape).clone(),
        prec.off.expand(b, *prec.off.shape).clone()))


def _out_of_memory_scenario(dev):
    """The card part of
    ``test_loop_graph_out_of_memory_frees_the_kept_graphs``."""
    import warnings

    from gaussianvi_tpu_torch import GVIConfig
    from gaussianvi_tpu_torch.inference import loop_graph
    from gaussianvi_tpu_torch.inference.engine import LocalEngine
    from gaussianvi_tpu_torch.inference.optimize import LoopState, run_gvi_carry
    from gaussianvi_tpu_torch.kernels import launch_counts, reset_launch_counts
    from gaussianvi_tpu_torch.ops.precision import set_precision_policy

    set_precision_policy()
    cfg = GVIConfig(niters=10, niters_lowtemp=10, step_size_base=0.9)
    big, small = _graph_restarts(8192, dev), _graph_restarts(1024, dev)
    before = launch_counts()
    with torch.no_grad():
        carry, hist = run_gvi_carry(LocalEngine(small[0], cfg, dev),
                                    small[1], cfg)
    after = launch_counts()
    grown = {n: after[n] - before[n] for n in after}
    want = _flat_outputs((carry.state, hist, LoopState(
        carry.temperature, carry.is_lowtemp, carry.converged)))
    del carry, hist
    loop_graph.clear()
    reset_launch_counts()
    kept = _graph_calls(*big, cfg, 2)
    assert [k for _, _, (k,) in kept] == ["eager", "captured"]
    del kept
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(dev).total_memory
    torch.cuda.set_per_process_memory_fraction(
        torch.cuda.memory_reserved(dev) / total, dev)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            calls = _graph_calls(*small, cfg, 3)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
    kinds = [k for _, _, (k,) in calls]
    assert kinds in (["eager", "captured", "replayed"],
                     ["eager", "eager", "eager"])
    assert sum(w.category is RuntimeWarning
               for w in caught) == (kinds[1] == "eager")
    assert not any(isinstance(g, loop_graph._Graph) and
                   g.static[0].shape[0] == 8192
                   for g in loop_graph._GRAPHS.values())
    loop_graph.clear()
    calls += _graph_calls(*small, cfg, 3)
    assert [k for _, _, (k,) in calls[3:]] == ["eager", "captured",
                                                "replayed"]
    for out, launches, _ in calls:
        assert launches == grown
        _assert_same_bits(out, want)
    loop_graph.clear()
    torch.cuda.empty_cache()


def test_loop_graph_out_of_memory_frees_the_kept_graphs(dev):
    """A large signature's graph kept (8,192 restarts) while the process
    is held to the card memory it has: a smaller signature's eager call
    (1,024 restarts) runs out of memory, the kept graph is dropped and
    the call runs again.  Its later calls under that limit either capture
    and replay, or, where the capture itself runs out (the memory given
    back may lie in segments the graph's pool cannot take), fall back to
    eager with one warning; with the limit lifted the signature captures
    and replays.  Every call the eager loop's bits and launches.
    The scenario runs in a process of its own: the memory earlier tests
    leave reserved in part-used segments would hold the eager call.
    """
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = ("import sys, torch; sys.path[:0] = [sys.argv[1], sys.argv[1] + "
            "'/tests']; import test_torch_cuda as t; "
            "t._out_of_memory_scenario(torch.device('cuda', 0))")
    run = subprocess.run([sys.executable, "-c", code, str(root)], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
