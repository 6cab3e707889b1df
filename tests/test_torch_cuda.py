"""PyTorch port on the GPU: each CUDA kernel against its plain PyTorch
version on the card, and the NGD loop on the kernels against the plain
loop (float64).  Skipped without a CUDA device.  On a GPU machine (no JAX
needed):

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


@pytest.mark.parametrize("n,s", [(1, 4), (6, 4), (5, 2)])
def test_chain_kernels_match_plain(dev, n, s):
    from gaussianvi_tpu_torch.kernels import chain

    diag, off, rhs = _chains(7, n, s, seed=n, dev=dev)
    before = (chain.gbp_covariance_logdet_lanes.launches,
              chain.solve_lanes.launches)
    got = chain.gbp_covariance_logdet_lanes(diag, off)
    want = chain.gbp_covariance_logdet_plain(diag, off)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=ATOL)
    torch.testing.assert_close(chain.solve_lanes(diag, off, rhs),
                               chain.solve_plain(diag, off, rhs),
                               rtol=0, atol=ATOL)
    assert (chain.gbp_covariance_logdet_lanes.launches,
            chain.solve_lanes.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("with_moments", [False, True])
def test_quad_kernel_matches_plain(dev, with_moments):
    from gaussianvi_tpu_torch.examples.chain_estimation import (
        build_chain_estimation,
    )
    from gaussianvi_tpu_torch.kernels import quad

    fb = build_chain_estimation(num_states=8, dim_x=2, gh_degree=4,
                                device=dev)[0].nonlinear[0]
    rng = np.random.default_rng(0)
    mu = torch.tensor(rng.standard_normal((3, 8, 4)), device=dev)
    a = rng.standard_normal((3, 8, 4, 4)) * 0.3
    cov = torch.tensor(a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(4),
                       device=dev)
    args = (mu, cov, fb.nodes, fb.weights, "range", fb.kernel_params)
    if with_moments:
        got = quad.quad_lanes_moments(*args, rdim=2)
        want = quad.quad_moments_plain(*args, rdim=2)
    else:
        got = (quad.quad_lanes_phi(*args, nonneg=True),)
        want = (quad.quad_phi_plain(*args, nonneg=True),)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=ATOL)


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
    _, hk = optimize(graph, state, GVIConfig(**cfg))
    assert all(n > 0 for n in launch_counts().values())
    _, hp = optimize(graph, state,
                     GVIConfig(chain_impl="seq", quad_impl="xla", **cfg))
    torch.testing.assert_close(hk.cost, hp.cost, rtol=1e-9, atol=0)
    assert torch.equal(hk.accepted_step, hp.accepted_step)
