"""Dense Gaussian variational inference by natural gradient: the plain
reference of every configuration.

Plain PyTorch on whole matrices.  It imports nothing of the program under
test and takes nothing the program made: the problem (:class:`Problems`)
is built from the benchmark's raw inputs by the configuration's reference
module (``reference/<family>.py``).

A problem has N states of dimension s and a Gaussian posterior
q = N(mu, Lambda^-1) with a block-tridiagonal precision, given by its
blocks ``diag [..., N, s, s]`` and ``off [..., N-1, s, s]`` (block
(i, i+1)).  Its cost is

    V(q) = sum_k E_q[psi_k] / T + 1/2 log det Lambda

over nonlinear factors (one state each, E[psi] by a sigma-point rule over
the leading r coordinates of the state) and linear-Gaussian factors
(psi = C ||Lam x - Psi m||^2_P over one state or a pair, in closed form).
One NGD iteration takes the joint gradients

    Vdmu  = sum_k P_k E[(x - mu) psi_k] / T          (nonlinear)
          + 2 C Lam^T P (Lam mu - Psi m) / T          (linear)
    Vddmu = sum_k (P_k E[(x-mu)(x-mu)^T psi_k] P_k - P_k E[psi_k]) / T
          + 2 C Lam^T P Lam / T

with P_k the inverse of factor k's marginal covariance (the marginal
rule's second moment adds L[:, r:] L[:, r:]^T E[psi], the exact Gaussian
lift of the trailing coordinates), the direction dmu = -Vddmu^-1 Vdmu
(where Vddmu is not positive definite: -Lambda^-1 Vdmu) and dLambda =
Vddmu - Lambda, and tries the steps base * decay^t, t = 1..T_max, taking
the first whose cost is below the current one.  An exhausted search
raises the temperature once, and a second one freezes the problem.

Rounding guards are part of the configuration's semantics, stated for its
float type (``guard_eps``, the machine epsilon of the configured dtype):
an E[psi] whose sum cancelled below 64 ulps of sum |w psi|, a negative
one inside 4096 ulps for a cost that is never negative, a negative
closed-form linear cost, and a log det whose Cholesky pivot is below 8
ulps of the magnitudes it was formed from, are not numbers (NaN), and a
NaN cost never decreases.

Every function takes a leading row axis Q and ``pid [Q]``, the problem of
each row, so that many iterates of many problems are evaluated at once.

``Problems.products = "tf32"`` computes every matrix product as TF32
does, from operands rounded to a 10-bit mantissa (the control of the
comparison, ``benchmark/control.py``): the card's small-matrix products
take no tensor cores, so the PyTorch flag alone would leave them float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

CANCEL_ULPS = 64.0
NONNEG_BAND = 4096.0
PIVOT_TRUST = 8.0
# where a guarded quantity lies this many times its rounding band or less
# from its threshold, the program's own rounding may fall on either side
# (``evaluate``'s ``border``)
BORDER = 8.0


@dataclass
class NonlinearGroup:
    """K nonlinear factors, one a state: ``cost(pts [Q, K, M, r], params)
    -> [Q, K, M]``, ``params`` a dict of ``[Q, K, ...]`` leaves (rows of
    the problem's ``[P, K, ...]`` leaves), the rule ``nodes [M, r]``,
    ``weights [M]``."""

    start: torch.Tensor
    nodes: torch.Tensor
    weights: torch.Tensor
    cost: Callable
    params: dict
    nonneg: bool


@dataclass
class LinearGroup:
    """K linear-Gaussian factors over ``nb`` consecutive states from
    ``start``: ``lam [P, K, r, nb s]``, ``psi [P, K, r, t]``,
    ``target [P, K, t]``, ``prec [P, K, r, r]``, ``const [P, K]`` (P may
    be 1: shared by every problem)."""

    start: torch.Tensor
    nb: int
    lam: torch.Tensor
    psi: torch.Tensor
    target: torch.Tensor
    prec: torch.Tensor
    const: torch.Tensor


@dataclass
class Problems:
    """P problems of one structure."""

    num_states: int
    state_dim: int
    nonlinear: list
    linear: list
    guard_eps: float
    products: str = "exact"


@dataclass
class Schedule:
    """The loop's constants (the configuration's ``gvi`` block)."""

    niters: int
    niters_lowtemp: int
    niters_backtrack: int
    step_size_base: float
    step_decay: float
    temperature: float
    high_temperature: float

    @classmethod
    def from_config(cls, gvi: dict) -> "Schedule":
        return cls(**{k: gvi[k] for k in cls.__dataclass_fields__})

    def steps(self) -> list[float]:
        return [self.step_size_base * self.step_decay ** t
                for t in range(1, self.niters_backtrack + 2)]


def _rows(x, pid):
    """A per-problem leaf's rows: ``x [P, ...]`` (or ``[1, ...]``, shared
    by every problem) -> ``[Q, ...]``."""
    if x.shape[0] == 1:
        return x.expand(pid.shape[0], *x.shape[1:])
    return x[pid]


def tf32(x):
    """``x`` (float32) rounded to TF32's 10-bit mantissa, to nearest."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def mm(prob: Problems, *mats):
    """The product of ``mats``, left to right, each product's operands
    rounded as ``prob.products`` says."""
    r = tf32 if prob.products == "tf32" else (lambda x: x)
    out = mats[0]
    for m in mats[1:]:
        out = r(out) @ r(m)
    return out


def dense(diag, off):
    """The whole symmetric matrix ``[Q, N s, N s]`` from its blocks."""
    q, n, s, _ = diag.shape
    a = diag.new_zeros(q, n, s, n, s)
    i = torch.arange(n, device=diag.device)
    a[:, i, :, i, :] = diag.transpose(0, 1)
    a[:, i[:-1], :, i[1:], :] = off.transpose(0, 1)
    a[:, i[1:], :, i[:-1], :] = off.transpose(-1, -2).transpose(0, 1)
    return a.reshape(q, n * s, n * s)


def _blocks(full, n, s):
    """``(diag [Q, N, s, s], off [Q, N-1, s, s])`` of a dense matrix."""
    a = full.reshape(-1, n, s, n, s)
    i = torch.arange(n, device=full.device)
    return (a[:, i, :, i, :].transpose(0, 1),
            a[:, i[:-1], :, i[1:], :].transpose(0, 1))


def _nan_rows(x, bad):
    return torch.where(bad.reshape(-1, *([1] * (x.ndim - 1))),
                       torch.full_like(x, float("nan")), x)


def cov_logdet(diag, off, guard_eps):
    """``(cov_d, cov_o, logdet, logdet_raw, border)``: the covariance
    blocks of Lambda^-1 and log det Lambda, rows that are not positive
    definite NaN, the log det NaN where a pivot is not trusted (see the
    module's docstring); the log det without that guard, and whether the
    pivot lies near the guard's threshold."""
    q, n, s, _ = diag.shape
    a = dense(diag, off)
    chol, info = torch.linalg.cholesky_ex(a)
    bad = (info != 0) | ~torch.isfinite(a).flatten(1).all(1)
    eye = torch.eye(n * s, dtype=a.dtype, device=a.device)
    chol = torch.where(bad[:, None, None], eye, chol)
    cd = torch.diagonal(chol, dim1=-2, dim2=-1)
    logdet = 2.0 * torch.log(cd).sum(-1)
    # pivot trust: the Cholesky factor's diagonal squared against the
    # magnitudes the block pivot was formed from
    lb = _blocks(chol, n, s)[0]                          # C_ii
    numer = cd.reshape(q, n, s) ** 2
    pdiag = (lb * lb).sum(-1)                            # diag(C_ii C_ii^T)
    ddiag = torch.diagonal(diag, dim1=-2, dim2=-1)
    denom = ddiag.abs() + (pdiag - ddiag).abs() + (pdiag - numer).abs()
    trust = (numer / denom).amin(dim=(-2, -1))
    guarded = torch.where(trust >= PIVOT_TRUST * guard_eps, logdet,
                          torch.full_like(logdet, float("nan")))
    # near the guard, or an eigenvalue near zero: whether the program's
    # Cholesky holds depends on its rounding
    border = _pd_flips(a, guard_eps) | (
        ~bad & (trust < BORDER * 32 * PIVOT_TRUST * guard_eps))
    cov = torch.cholesky_inverse(chol)
    cov_d, cov_o = _blocks(cov, n, s)
    return (_nan_rows(cov_d, bad), _nan_rows(cov_o, bad),
            _nan_rows(guarded, bad), _nan_rows(logdet, bad), border)


def _chol_small(cov):
    chol, info = torch.linalg.cholesky_ex(cov)
    return torch.where((info == 0)[..., None, None], chol,
                       torch.full_like(chol, float("nan")))


def _sigma(prob, group: NonlinearGroup, pid, mu, cov_d):
    """Offsets ``[Q, K, M, s]``, weighted costs ``[Q, K, M]`` and the
    factor ``L [Q, K, s, s]`` of each factor's marginal."""
    mu_k, cov_k = mu[:, group.start], cov_d[:, group.start]
    chol = _chol_small(cov_k)
    r = group.nodes.shape[-1]
    offs = mm(prob, chol[..., :r], group.nodes.T).transpose(-1, -2)
    pts = mu_k[:, :, None, :] + offs
    params = {k: _rows(v, pid) for k, v in group.params.items()}
    wphi = group.cost(pts[..., :r], params) * group.weights
    return offs, wphi, chol


def expected_phi(prob, group, pid, mu, cov_d):
    """``(E[psi_k] [Q, K] guarded, unguarded, border)``: border where the
    sum lies near a guard's threshold."""
    _, wphi, _ = _sigma(prob, group, pid, mu, cov_d)
    tot, absum = wphi.sum(-1), wphi.abs().sum(-1)
    band = prob.guard_eps * absum
    bad = tot.abs() < CANCEL_ULPS * band
    border = tot.abs() < BORDER * CANCEL_ULPS * band
    if group.nonneg:
        bad = bad | ((tot < 0) & (tot > -NONNEG_BAND * band))
        border = border | ((tot + NONNEG_BAND * band).abs()
                           < BORDER * CANCEL_ULPS * band)
    return torch.where(bad, torch.full_like(tot, float("nan")), tot), tot, \
        border


def _edge(group: LinearGroup, mu, cov_d, cov_o):
    """Each linear factor's mean ``[Q, K, nb s]`` and covariance."""
    st = group.start
    if group.nb == 1:
        return mu[:, st], cov_d[:, st]
    m = torch.cat([mu[:, st], mu[:, st + 1]], -1)
    top = torch.cat([cov_d[:, st], cov_o[:, st]], -1)
    bot = torch.cat([cov_o[:, st].transpose(-1, -2), cov_d[:, st + 1]], -1)
    return m, torch.cat([top, bot], -2)


def _linear_parts(prob, group, pid):
    lam, psi = _rows(group.lam, pid), _rows(group.psi, pid)
    tgt, prec = _rows(group.target, pid), _rows(group.prec, pid)
    const = _rows(group.const, pid)
    a = mm(prob, lam.transpose(-1, -2), prec, lam)
    return lam, psi, tgt, prec, const, a


def _residual(prob, lam, psi, tgt, m):
    return mm(prob, lam, m[..., None]) - mm(prob, psi, tgt[..., None])


def linear_cost(prob, group, pid, mu, cov_d, cov_o):
    """Closed-form E[psi_k] ``[Q, K]``, a negative one NaN."""
    lam, psi, tgt, prec, const, a = _linear_parts(prob, group, pid)
    m, c = _edge(group, mu, cov_d, cov_o)
    res = _residual(prob, lam, psi, tgt, m)
    quad = mm(prob, res.transpose(-1, -2), prec, res)[..., 0, 0]
    tr = torch.diagonal(mm(prob, a, c), dim1=-2, dim2=-1).sum(-1)
    cost = (tr + quad) * const
    return torch.where(cost < 0, torch.full_like(cost, float("nan")), cost)


def costs(prob: Problems, pid, mu, cov_d, cov_o, chain, temperature):
    """``(cost, scale, cost_raw, border)``, each ``[Q]``: the total cost
    at ``temperature [Q]``, the sum of its terms' magnitudes (against
    which its errors are read), the cost without the rounding guards and
    whether a guarded term lies near its threshold.  ``chain``: the log
    det's ``(guarded, raw, border)`` (``cov_logdet``)."""
    logdet, logdet_raw, border = chain
    total, raw = 0.5 * logdet, 0.5 * logdet_raw
    scale = 0.5 * logdet_raw.abs()
    for g in prob.nonlinear:
        f, f_raw, b = expected_phi(prob, g, pid, mu, cov_d)
        total = total + f.sum(-1) / temperature
        raw = raw + f_raw.sum(-1) / temperature
        scale = scale + f_raw.abs().sum(-1) / temperature
        border = border | b.any(-1)
    for g in prob.linear:
        f = linear_cost(prob, g, pid, mu, cov_d, cov_o).sum(-1)
        total, raw = total + f / temperature, raw + f / temperature
        scale = scale + f.abs() / temperature
    return total, scale, raw, border


def _scatter(vdmu, vdd_d, vdd_o, start, nb, s, gm, gh):
    """Add factor gradients ``gm [Q, K, nb s]``, ``gh [Q, K, nb s, nb s]``
    into the joint ones in place."""
    vdmu.index_add_(1, start, gm[..., :s])
    vdd_d.index_add_(1, start, gh[..., :s, :s])
    if nb == 2:
        vdmu.index_add_(1, start + 1, gm[..., s:])
        vdd_d.index_add_(1, start + 1, gh[..., s:, s:])
        vdd_o.index_add_(1, start, gh[..., :s, s:])


def gradients(prob: Problems, pid, mu, cov_d, cov_o, temperature,
              magnitudes: bool = False):
    """The joint ``(Vdmu [Q, N, s], Vddmu diag, Vddmu off)``; with
    ``magnitudes`` also the same sums of every term's magnitude (each
    product and each quadrature sum taken over absolute values), the
    scale of the rounding error their sums carry."""
    q, n, s = mu.shape
    t = temperature.reshape(q, 1)
    parts = [(torch.zeros_like(mu), cov_d.new_zeros(q, n, s, s),
              cov_d.new_zeros(q, n - 1, s, s))
             for _ in range(2 if magnitudes else 1)]
    for g in prob.nonlinear:
        offs, wphi, chol = _sigma(prob, g, pid, mu, cov_d)
        r = g.nodes.shape[-1]
        hi = chol[..., r:]
        p = torch.cholesky_inverse(chol)
        for part, f in zip(parts, (lambda x: x, torch.abs)):
            w, o, h, pk = f(wphi), f(offs), f(hi), f(p)
            e_phi = w.sum(-1)
            e_xmu = mm(prob, w[..., None, :], o)[..., 0, :]
            e_xxt = (mm(prob, o.transpose(-1, -2), w[..., None] * o)
                     + mm(prob, h, h.transpose(-1, -2)) * e_phi[..., None, None])
            gm = mm(prob, pk, e_xmu[..., None])[..., 0] / t[..., None]
            sign = -1.0 if f is not torch.abs else 1.0
            gh = ((mm(prob, pk, e_xxt, pk) + sign * pk * e_phi[..., None, None])
                  / t[..., None, None])
            gh = 0.5 * (gh + gh.transpose(-1, -2))
            _scatter(*part, g.start, 1, s, gm, gh)
    for g in prob.linear:
        lam, psi, tgt, prec, const, a = _linear_parts(prob, g, pid)
        m, _ = _edge(g, mu, cov_d, cov_o)
        res = _residual(prob, lam, psi, tgt, m)
        c = (const / t)
        for part, f in zip(parts, (lambda x: x, torch.abs)):
            gm = 2.0 * mm(prob, f(lam).transpose(-1, -2), f(prec),
                          f(res))[..., 0] * c[..., None]
            gh = 2.0 * (mm(prob, f(lam).transpose(-1, -2), f(prec), f(lam))
                        if f is torch.abs else a) * c[..., None, None]
            _scatter(*part, g.start, g.nb, s, gm, gh)
    return parts[0] if not magnitudes else (*parts[0], *parts[1])


def _spd_solve(diag, off, rhs):
    """``A^-1 rhs`` for each row, NaN where A is not positive definite."""
    q, n, s = rhs.shape
    a = dense(diag, off)
    chol, info = torch.linalg.cholesky_ex(a)
    bad = (info != 0) | ~torch.isfinite(a).flatten(1).all(1)
    eye = torch.eye(n * s, dtype=a.dtype, device=a.device)
    chol = torch.where(bad[:, None, None], eye, chol)
    x = torch.cholesky_solve(rhs.reshape(q, n * s, 1), chol).reshape(q, n, s)
    return _nan_rows(x, bad)


def _pd_flips(a, guard_eps):
    """Rows whose positive definiteness turns on a shift of 64 BORDER
    ulps of the largest row sum: an eigenvalue that close to zero."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    shift = (a.abs().sum(-1).amax(-1) * CANCEL_ULPS * BORDER
             * guard_eps)[:, None, None] * eye
    return (torch.linalg.cholesky_ex(a - shift)[1] != 0) != (
        torch.linalg.cholesky_ex(a + shift)[1] != 0)


def direction(prec_d, prec_o, vdmu, vdd_d, vdd_o, guard_eps=None):
    """``(dmu, dprec diag, dprec off)`` of one NGD step; with
    ``guard_eps`` also the other branch's mean step (the fallback where
    Vddmu is positive definite, else the solve with Vddmu regardless) and
    whether Vddmu lies so near indefinite that the program's rounding may
    take either branch."""
    dmu = _spd_solve(vdd_d, vdd_o, -vdmu)
    fallback = _spd_solve(prec_d, prec_o, -vdmu)
    ok = torch.isfinite(dmu).flatten(1).all(1)
    dmu = torch.where(ok[:, None, None], dmu, fallback)
    if guard_eps is None:
        return dmu, vdd_d - prec_d, vdd_o - prec_o
    a = dense(vdd_d, vdd_o)
    finite = torch.isfinite(a).flatten(1).all(1)
    a = torch.where(finite[:, None, None], a, torch.eye(
        a.shape[-1], dtype=a.dtype, device=a.device))
    solved = torch.linalg.solve_ex(a, -vdmu.reshape(a.shape[0], -1, 1))[0]
    other = torch.where(ok[:, None, None], fallback,
                        solved.reshape(vdmu.shape))
    return (dmu, vdd_d - prec_d, vdd_o - prec_o, other,
            finite & _pd_flips(a, guard_eps))


def _sym(d):
    return 0.5 * (d + d.transpose(-1, -2))


@dataclass
class Step:
    """One iteration evaluated at given iterates (each ``[Q, ...]``)."""

    cost: torch.Tensor          # V at the iterate
    scale: torch.Tensor
    cost_raw: torch.Tensor      # V without the rounding guards
    border: torch.Tensor        # a guarded term near its threshold
    dmu: torch.Tensor
    dprec_d: torch.Tensor
    dprec_o: torch.Tensor
    trials: torch.Tensor        # [Q, T] V at every trial step
    trials_raw: torch.Tensor
    trials_border: torch.Tensor
    other: torch.Tensor         # the other branch's mean step
    other_border: torch.Tensor  # Vddmu near indefinite: either branch
    cond: torch.Tensor          # condition number of Lambda
    cond_vdd: torch.Tensor      # |lambda|max / |lambda|min of Vddmu
    cancel: torch.Tensor        # the gradients' magnitude over their size


def evaluate(prob: Problems, pid, mu, prec_d, prec_o, temperature, steps,
             chunk: int = 256, conditions: bool = True) -> Step:
    """Everything one iteration computes at the iterates ``(mu, prec)``
    of rows ``pid``, at ``temperature [Q]``, with the trial steps
    ``steps``; ``chunk`` rows at a time.  The condition numbers, the
    cancellation and the direction's other branch only with
    ``conditions`` (what the comparison reads; the loop needs none)."""
    parts = []
    for lo in range(0, mu.shape[0], chunk):
        sl = slice(lo, lo + chunk)
        parts.append(_evaluate(prob, pid[sl], mu[sl], prec_d[sl], prec_o[sl],
                               temperature[sl], steps, conditions))
    return Step(*(torch.cat(x) for x in zip(*(
        (p.cost, p.scale, p.cost_raw, p.border, p.dmu, p.dprec_d,
         p.dprec_o, p.trials, p.trials_raw, p.trials_border, p.other,
         p.other_border, p.cond, p.cond_vdd, p.cancel) for p in parts))))


def condition(diag, off):
    """|lambda|max / |lambda|min of each row's symmetric matrix (inf where
    it is singular or not finite)."""
    a = dense(diag, off)
    ok = torch.isfinite(a).flatten(1).all(1)
    ev = torch.linalg.eigvalsh(torch.where(ok[:, None, None], a,
                                           torch.zeros_like(a))).abs()
    c = ev.amax(1) / ev.amin(1)
    return torch.where(ok & (ev.amin(1) > 0), c, torch.full_like(c, float("inf")))


def _evaluate(prob, pid, mu, prec_d, prec_o, temperature, steps,
              conditions):
    cd, co, *chain = cov_logdet(prec_d, prec_o, prob.guard_eps)
    cost, scale, cost_raw, border = costs(prob, pid, mu, cd, co, chain,
                                          temperature)
    grads = gradients(prob, pid, mu, cd, co, temperature, conditions)
    vdmu, vdd_d, vdd_o = grads[:3]
    dmu, dpd, dpo, *branch = direction(
        prec_d, prec_o, vdmu, vdd_d, vdd_o,
        prob.guard_eps if conditions else None)
    trials = _trials(prob, pid, mu, prec_d, prec_o, dmu, dpd, dpo,
                     temperature, steps)
    if conditions:
        def ratio(mag, val):
            dims = tuple(range(1, val.ndim))
            return mag.abs().amax(dims) / val.abs().amax(dims)

        cancel = torch.maximum(ratio(grads[3], vdmu), torch.maximum(
            ratio(grads[4], vdd_d), ratio(grads[5], vdd_o)))
        conds = (*branch, condition(prec_d, prec_o),
                 condition(vdd_d, vdd_o), cancel)
    else:
        conds = (dmu, torch.zeros_like(cost, dtype=torch.bool),
                 *(torch.full_like(cost, float("nan")),) * 3)
    return Step(cost, scale, cost_raw, border, dmu, dpd, dpo, *trials,
                *conds)


def _trials(prob, pid, mu, prec_d, prec_o, dmu, dpd, dpo, temperature,
            steps, conditions=False):
    """``(V, V without the guards, near a guard)``, each ``[Q, T]``, at
    the trial iterates ``(mu, prec) + t (dmu, dprec)`` of every step t,
    and with ``conditions`` each trial's kappa(Lambda)."""
    t = torch.as_tensor(steps, dtype=mu.dtype, device=mu.device)
    nt, q = t.shape[0], mu.shape[0]
    tt = t.repeat_interleave(q)
    rep = lambda x: x.repeat(nt, *([1] * (x.ndim - 1)))   # noqa: E731
    t_mu = rep(mu) + tt[:, None, None] * rep(dmu)
    t_pd = _sym(rep(prec_d) + tt[:, None, None, None] * rep(dpd))
    t_po = rep(prec_o) + tt[:, None, None, None] * rep(dpo)
    tcd, tco, *tchain = cov_logdet(t_pd, t_po, prob.guard_eps)
    tcost, _, traw, tborder = costs(prob, pid.repeat(nt), t_mu, tcd, tco,
                                    tchain, temperature.repeat(nt))
    per_trial = lambda x: x.reshape(nt, q).T                 # noqa: E731
    out = (per_trial(tcost), per_trial(traw), per_trial(tborder))
    return out + ((per_trial(condition(t_pd, t_po)),) if conditions else ())


def trials_along(prob: Problems, pid, mu, prec_d, prec_o, dmu, dpd, dpo,
                 temperature, steps, chunk: int = 256):
    """The trial costs along a given direction ``(dmu, dprec)`` (the
    program's own, recovered from its iterates), as ``evaluate`` gives
    them along the reference's: ``(V, V without the guards, near a
    guard, kappa(Lambda))``, each ``[Q, T]``; ``chunk`` rows at a time."""
    parts = [_trials(prob, pid[sl], mu[sl], prec_d[sl], prec_o[sl], dmu[sl],
                     dpd[sl], dpo[sl], temperature[sl], steps, True)
             for sl in (slice(lo, lo + chunk)
                        for lo in range(0, mu.shape[0], chunk))]
    return tuple(torch.cat(x) for x in zip(*parts))


def run(prob: Problems, mu, prec_d, prec_o, sched: Schedule):
    """The whole loop from ``(mu, prec)`` (one row a problem, in the
    tensors' dtype): ``(records, final)``, the records a dict of
    ``mu [P, I, N, s]``, ``prec_diag``, ``prec_off``, ``cost [P, I]`` and
    ``accepted_step [P, I]`` (0 for a rejected search), as the program
    records them at the top of every iteration, and ``final`` the state
    after the last one."""
    p = mu.shape[0]
    pid = torch.arange(p, device=mu.device)
    steps = sched.steps()
    temp = torch.full((p,), sched.temperature, dtype=mu.dtype,
                      device=mu.device)
    low = torch.ones(p, dtype=torch.bool, device=mu.device)
    conv = torch.zeros_like(low)
    rec = {k: [] for k in ("mu", "prec_diag", "prec_off", "cost",
                           "accepted_step")}
    for i in range(sched.niters):
        if i == sched.niters_lowtemp:
            temp = torch.where(low, torch.full_like(temp,
                                                    sched.high_temperature),
                               temp)
            low = torch.zeros_like(low)
        st = evaluate(prob, pid, mu, prec_d, prec_o, temp, steps,
                      conditions=False)
        ok = st.trials < st.cost[:, None]
        acc = ok.any(1)
        sel = torch.where(acc, ok.to(torch.int64).argmax(1),
                          torch.full_like(acc, len(steps) - 1,
                                          dtype=torch.int64))
        step = torch.as_tensor(steps, dtype=mu.dtype, device=mu.device)[sel]
        for k, v in (("mu", mu), ("prec_diag", prec_d), ("prec_off", prec_o),
                     ("cost", st.cost),
                     ("accepted_step", torch.where(acc, step,
                                                   torch.zeros_like(step)))):
            rec[k].append(v)
        move = acc & ~conv
        sv = step[:, None, None]
        mu = torch.where(move[:, None, None], mu + sv * st.dmu, mu)
        prec_d = torch.where(move[:, None, None, None],
                             _sym(prec_d + sv[..., None] * st.dprec_d), prec_d)
        prec_o = torch.where(move[:, None, None, None],
                             prec_o + sv[..., None] * st.dprec_o, prec_o)
        failed = ~acc
        esc = failed & low
        temp = torch.where(esc, torch.full_like(temp, sched.high_temperature),
                           temp)
        conv = conv | (failed & ~low)
        low = low & ~esc
    records = {k: torch.stack(v, 1) for k, v in rec.items()}
    return records, {"mu": mu, "prec_diag": prec_d, "prec_off": prec_o}
