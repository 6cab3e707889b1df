"""PyTorch port, ops layer: small-matrix algebra, block-tridiagonal chain
and the chain kernels' plain versions against the JAX package (CPU, f64).

The JAX chain kernels run in Pallas interpret mode, as their own tests run
them on the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gaussianvi_tpu.kernels import chain_lanes as jlanes  # noqa: E402
from gaussianvi_tpu.ops import blocktridiag as jbt  # noqa: E402
from gaussianvi_tpu.ops import smallmat as jsm  # noqa: E402
from gaussianvi_tpu_torch.kernels import chain as tchain  # noqa: E402
from gaussianvi_tpu_torch.ops import blocktridiag as tbt  # noqa: E402
from gaussianvi_tpu_torch.ops import smallmat as tsm  # noqa: E402

CPU = torch.device("cpu")

ATOL = 1e-10


def _spd(shape, s, rng):
    a = rng.standard_normal((*shape, s, s))
    return a @ np.swapaxes(a, -1, -2) + s * np.eye(s)


def _chain(b, n, s, seed):
    """B different SPD block-tridiagonal problems and right-hand sides."""
    rng = np.random.default_rng(seed)
    diag = _spd((b, n), s, rng) + 2 * s * np.eye(s)
    off = 0.5 * rng.standard_normal((b, max(n - 1, 0), s, s))
    rhs = rng.standard_normal((b, n, s))
    return diag, off, rhs


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("s", [1, 2, 4])
@pytest.mark.parametrize("fn", ["chol", "solve_vec", "solve_mat", "inv",
                                "logdet"])
def test_smallmat_matches_jax(fn, s):
    rng = np.random.default_rng(s)
    a = _spd((3, 5), s, rng)
    b_vec = rng.standard_normal((3, 5, s))
    b_mat = rng.standard_normal((3, 5, s, 2))
    cases = {
        "chol": (jsm.chol_small, tsm.chol_small, (a,)),
        "solve_vec": (jsm.spd_solve_small, tsm.spd_solve_small, (a, b_vec)),
        "solve_mat": (jsm.spd_solve_small, tsm.spd_solve_small, (a, b_mat)),
        "inv": (jsm.spd_inv_small, tsm.spd_inv_small, (a,)),
        "logdet": (jsm.logdet_spd_small, tsm.logdet_spd_small, (a,)),
    }
    jfn, tfn, args = cases[fn]
    want = np.asarray(jfn(*map(jnp.asarray, args)))
    got = tfn(*map(_t, args)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_chol_solve_small_matches_jax():
    rng = np.random.default_rng(7)
    l = np.linalg.cholesky(_spd((4,), 3, rng))
    b = rng.standard_normal((4, 3))
    want = np.asarray(jsm.chol_solve_small(jnp.asarray(l), jnp.asarray(b)))
    np.testing.assert_allclose(tsm.chol_solve_small(_t(l), _t(b)).numpy(),
                               want, atol=ATOL)


def _jax_reference(diag, off, rhs):
    def one(d, o, r):
        a = jbt.BlockTridiag(d, o)
        cd, co, ld = jbt.gbp_covariance_logdet(a)
        x = jbt.solve(a, r.reshape(-1)).reshape(r.shape)
        return cd, co, ld, x

    return [np.asarray(v) for v in jax.vmap(one)(
        jnp.asarray(diag), jnp.asarray(off), jnp.asarray(rhs))]


@pytest.mark.parametrize("n", [1, 6])
def test_blocktridiag_matches_jax(n):
    diag, off, rhs = _chain(3, n, 4, seed=n)
    cd, co, ld, x = _jax_reference(diag, off, rhs)
    a = tbt.BlockTridiag(_t(diag), _t(off))
    tcd, tco, tld = tbt.gbp_covariance_logdet(a)
    np.testing.assert_allclose(tcd.numpy(), cd, atol=ATOL)
    np.testing.assert_allclose(tco.numpy(), co, atol=ATOL)
    np.testing.assert_allclose(tld.numpy(), ld, atol=ATOL)
    np.testing.assert_allclose(tbt.solve(a, _t(rhs)).numpy(), x, atol=ATOL)
    # the covariance is the inverse's blocks: dense check of one problem
    dense_inv = np.linalg.inv(a.to_dense()[0].numpy())
    np.testing.assert_allclose(tcd[0, 0].numpy(), dense_inv[:4, :4],
                               atol=ATOL)


@pytest.mark.parametrize("n", [1, 6])
def test_chain_kernel_plain_matches_jax_kernels(n):
    """The plain versions of K1/K2 (what the wrappers run for CPU tensors)
    against the JAX Pallas kernels in interpret mode; the problems differ,
    so any reduction across the batch axis would show."""
    diag, off, rhs = _chain(3, n, 4, seed=10 + n)
    jcd, jco, jld = map(np.asarray, jlanes.gbp_covariance_logdet_lanes(
        jnp.asarray(diag), jnp.asarray(off), interpret=True))
    jx = np.asarray(jlanes.solve_lanes(jnp.asarray(diag), jnp.asarray(off),
                                       jnp.asarray(rhs), interpret=True))
    tcd, tco, tld = tchain.gbp_covariance_logdet_lanes(_t(diag), _t(off))
    np.testing.assert_allclose(tcd.numpy(), jcd, atol=ATOL)
    np.testing.assert_allclose(tco.numpy(), jco, atol=ATOL)
    np.testing.assert_allclose(tld.numpy(), jld, atol=ATOL)
    tx = tchain.solve_lanes(_t(diag), _t(off), _t(rhs))
    np.testing.assert_allclose(tx.numpy(), jx, atol=ATOL)
    assert tchain.gbp_covariance_logdet_lanes.launches == 0
    assert tchain.solve_lanes.launches == 0


def test_solve_pair_plain_matches_jax_kernel():
    """K2's pair entry (main system and fallback against one right-hand
    side; its plain version on the CPU) against the JAX kernel run on each
    system in interpret mode."""
    d0, o0, rhs = _chain(3, 5, 4, seed=20)
    d1, o1, _ = _chain(3, 5, 4, seed=21)
    got = tchain.solve_pair_lanes(_t(d0), _t(o0), _t(d1), _t(o1), _t(rhs))
    for x, (d, o) in zip(got, ((d0, o0), (d1, o1))):
        want = jlanes.solve_lanes(jnp.asarray(d), jnp.asarray(o),
                                  jnp.asarray(rhs), interpret=True)
        np.testing.assert_allclose(x.numpy(), np.asarray(want), atol=ATOL)
    assert tchain.solve_lanes.launches == 0


# (n, s, itemsize) -> bytes of one warp's arena: K1 (the pivots), K2;
# the flagship's f32 values are what the kernels asked for on the card
CHAIN_ARENAS = {(32, 4, 4): (17664, 63104),
                (32, 2, 8): (20736, 86656),
                (1, 4, 8): (1280, 4736)}


@pytest.mark.parametrize("n,s,size", sorted(CHAIN_ARENAS))
def test_chain_block_plans(n, s, size):
    """The chain kernels' arenas: each warp's chain (or pair) arrays start
    32 / slots banks apart, the sizes the C side checks, one-warp blocks
    in shared memory, and a chain too long for it on the scratch route."""
    gbp, solve = CHAIN_ARENAS[n, s, size]
    assert tchain.gbp_warp_elems(n, s, size) * size == gbp
    assert tchain.solve_warp_elems(n, s, size) * size == solve
    c = tchain.chains_per_warp(s)
    for slots, base in ((c, n * (s * s + 1)), (2 * c, n * (s + 1))):
        pitch = tchain.slot_pitch(base, slots, size)
        assert base <= pitch < base + 32 * 4 // size
        assert pitch * size // 4 % 32 == 32 // slots
    for arena in (gbp, solve):
        plan = tchain.chain_plan(arena // size, size)
        assert plan.warps == 1 and not plan.scratch and plan.smem == arena
    long = tchain.chain_plan(tchain.gbp_warp_elems(1100, s, size), size)
    assert long.scratch and long.smem == 0 and long.arena * size > (
        tchain.SMEM_LIMIT)


def test_trial_axis_matches_per_problem():
    """Extra leading axes (line-search trials x problems) give the same
    per-chain results as one problem at a time."""
    diag, off, _ = _chain(6, 5, 2, seed=3)
    d = _t(diag).reshape(2, 3, 5, 2, 2)
    o = _t(off).reshape(2, 3, 4, 2, 2)
    cd, co, ld = tbt.gbp_covariance_logdet(tbt.BlockTridiag(d, o))
    for i in range(6):
        cdi, coi, ldi = tbt.gbp_covariance_logdet(
            tbt.BlockTridiag(_t(diag[i]), _t(off[i])))
        np.testing.assert_allclose(cd.reshape(6, 5, 2, 2)[i], cdi, atol=1e-14)
        np.testing.assert_allclose(ld.reshape(6)[i], ldi, atol=1e-14)


def _cancelling_chain():
    """2-state 1x1-block chain whose Schur pivot cancels to ~2 ulp."""
    diag = np.asarray([[[1.0]], [[1.0 + 4e-16]]])
    off = np.asarray([[[1.0]]])
    return diag, off


def test_pivot_trust_poisons_like_jax():
    diag, off = _cancelling_chain()
    # one cancelling problem beside a healthy one: only the first is NaN
    diag_b = np.stack([diag, diag + np.eye(1)])
    off_b = np.stack([off, off])
    *_, jld = jlanes.gbp_covariance_logdet_lanes(
        jnp.asarray(diag_b), jnp.asarray(off_b), interpret=True)
    *_, tld = tchain.gbp_covariance_logdet_lanes(_t(diag_b), _t(off_b))
    assert np.isnan(np.asarray(jld)[0]) and np.isnan(tld[0].item())
    np.testing.assert_allclose(tld[1].item(), np.asarray(jld)[1], atol=ATOL)
    guarded = tbt._guarded_logdet(
        torch.eye(2, dtype=torch.float64).expand(3, 2, 2) * 1e-18,
        torch.eye(2, dtype=torch.float64).expand(3, 2, 2),
        -torch.eye(2, dtype=torch.float64).expand(3, 2, 2))
    assert torch.isnan(guarded)


def test_block_tridiag_algebra():
    diag, off, _ = _chain(2, 3, 2, seed=5)
    a = tbt.BlockTridiag(_t(diag), _t(off))
    z = tbt.BlockTridiag.zeros((2,), 3, 2, torch.float64, device=CPU)
    eye = tbt.BlockTridiag.identity((2,), 3, 2, 2.0, torch.float64, device=CPU)
    np.testing.assert_allclose((a + z - z).diag, a.diag)
    np.testing.assert_allclose((eye.scale(torch.tensor([1.0, 3.0]))).diag[1],
                               6.0 * np.broadcast_to(np.eye(2), (3, 2, 2)))
    asym = tbt.BlockTridiag(a.diag + torch.triu(torch.ones(2, 2)), a.off)
    sym = asym.symmetrize().diag
    np.testing.assert_allclose(sym, sym.transpose(-1, -2))
