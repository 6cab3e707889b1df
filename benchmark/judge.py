"""The comparison that decides ``correct``.

The program's outputs for a sample of the problems it solved in the
window (every iteration's recorded iterate, cost and accepted step, and
the final state) are held against the plain reference, step by step from
the program's own iterates: in float32 the line search may take another
step than in float64 where two trial costs lie within rounding of the
current one, so the two trajectories part, and each of the program's
steps is judged where the program took it.  For each problem:

* ``start``: the first record against the initial state handed to the
  program, largest absolute difference (exact: limit 0);
* ``cost``: each recorded cost against the reference's cost of the
  recorded iterate at the iteration's temperature, the difference over
  the sum of the cost's terms' magnitudes (the trial costs of the fused
  kernel, carried from the accepted trial, and the initial K1 / K3 cost);
* ``search``: each line-search decision against the reference's trial
  costs: how far the accepted trial's cost lies above the current cost,
  or an earlier trial's below it (for a rejected search, any trial's
  below it), over the same magnitude.  Where the accepted step moved the
  iterate, the trials lie along the program's own direction, (next -
  current) / step, and each amount is read against the rounding of both
  costs (kappa of the iterate plus kappa of the trial); elsewhere along
  the reference's;
* ``step``: each next iterate (the final state after the last) against
  the reference's step from the recorded one with the program's step
  length, the largest entry's difference over the step's largest entry
  plus 64 ulps of the iterate's (mean and precision blocks apiece).

The temperature and the freeze of each iteration follow from the
program's own decisions, as the loop defines them.  A NaN where the
reference has a number, or the reverse, reads as infinity, except where
a rounding guard's quantity lies near its threshold in the reference
(``dense_gvi.BORDER``): there the program's NaN is accepted and its
number is read against the unguarded reference.

Each number is read against the rounding the configured precision allows
there: ``cost``, and ``search`` along the program's direction, over
kappa(Lambda) eps; ``step``, and ``search`` along the reference's, over
(kappa(Lambda) + kappa(Vddmu) c) eps, c the cancellation in the
gradient's sums (their terms' magnitudes over their size).  The raw
relative numbers follow the iterate's conditioning from seed to seed;
these do not.  Where a limit times that rounding reaches 1, the limit
admits an error as large as the quantity compared; with the limits,
``readings`` counts those iterates (``void_<name>``) and reads each
number over the others alone (``<name>_wc``), so that a run shows how
much of its comparison has force.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import dense_gvi

def _schedule(accepted: np.ndarray, sched: dense_gvi.Schedule):
    """``(temperature [P, I], moving [P, I])``: each iteration's
    temperature and whether its accepted step moves the iterate (not
    frozen), replayed from the decisions ``accepted [P, I] > 0``."""
    p, iters = accepted.shape
    temp = np.full(p, sched.temperature)
    low = np.ones(p, bool)
    conv = np.zeros(p, bool)
    temps, moving = np.zeros((p, iters)), np.zeros((p, iters), bool)
    for i in range(iters):
        if i == sched.niters_lowtemp:
            temp = np.where(low, sched.high_temperature, temp)
            low[:] = False
        acc = accepted[:, i] > 0
        temps[:, i] = temp
        moving[:, i] = acc & ~conv
        esc = ~acc & low
        temp = np.where(esc, sched.high_temperature, temp)
        conv |= ~acc & ~low
        low &= ~esc
    return temps, moving


def _rel(a, b, scale):
    """|a - b| / scale, 0 where both are NaN, inf where one is."""
    na, nb = torch.isnan(a), torch.isnan(b)
    d = (a - b).abs() / scale
    d = torch.where(na & nb, torch.zeros_like(d), d)
    return torch.where(na ^ nb, torch.full_like(d, float("inf")), d)


def _inf_norm(x, dims):
    return x.abs().amax(dim=dims)


def readings(problems: dense_gvi.Problems, out: dict, init_mu, prec_scale,
             sched: dense_gvi.Schedule, dtype, device,
             limits: dict | None = None) -> dict:
    """Each problem's four readings (``[P]`` numpy arrays) for the
    program's outputs ``out`` (``mu [P, I, N, s]``, ``prec_diag``,
    ``prec_off``, ``cost [P, I]``, ``accepted_step [P, I]``,
    ``final_mu``, ``final_prec_diag``, ``final_prec_off``) of problems
    whose initial mean was ``init_mu [P, N, s]`` (numpy, as handed over
    in ``dtype``) and precision ``prec_scale`` I; with ``limits``, also
    each limited number's ``void_<name>`` and ``<name>_wc`` (above)."""
    f64 = torch.float64
    o = {k: torch.as_tensor(v).to(device=device, dtype=f64)
         for k, v in out.items()}
    p, iters, n, s = o["mu"].shape
    eps = torch.finfo(dtype).eps

    handed = torch.as_tensor(np.asarray(init_mu)).to(dtype).to(device, f64)
    eye = torch.eye(s, dtype=f64, device=device) * prec_scale
    start = torch.maximum(
        _inf_norm(o["mu"][:, 0] - handed, (1, 2)),
        torch.maximum(_inf_norm(o["prec_diag"][:, 0] - eye.to(dtype).to(f64),
                                (1, 2, 3)),
                      _inf_norm(o["prec_off"][:, 0], (1, 2, 3))))

    acc_np = o["accepted_step"].cpu().numpy()
    temps, moving = _schedule(acc_np, sched)
    q = p * iters
    pid = torch.arange(p, device=device).repeat_interleave(iters)
    flat = lambda x: x.reshape(q, *x.shape[2:])              # noqa: E731
    steps = sched.steps()
    st = dense_gvi.evaluate(problems, pid, flat(o["mu"]),
                            flat(o["prec_diag"]), flat(o["prec_off"]),
                            torch.as_tensor(temps.reshape(q), dtype=f64,
                                            device=device), steps)
    c_prog = o["cost"].reshape(q)
    finite = ~torch.isnan(c_prog)
    # near a rounding guard's threshold the program may give the cost or
    # NaN: its number is read against the unguarded cost, its NaN as 0
    c_ref = torch.where(st.border & finite, st.cost_raw, st.cost)
    cost = torch.where(st.border & ~finite, torch.zeros_like(c_prog),
                       _rel(c_prog, c_ref, st.scale))

    # line search: the accepted trial (nearest scheduled step), or none;
    # a trial near a guard's threshold may have been NaN to the program
    sv = torch.as_tensor(steps, dtype=f64, device=device)
    a = o["accepted_step"].reshape(q)
    acc = a > 0
    j = (a[:, None] - sv).abs().argmin(1)
    earlier = torch.arange(len(steps), device=device)[None, :] < j[:, None]

    def violation(r, trials, raw, border, share=1.0):
        """How far rows ``r``'s decision lies on the wrong side of the
        trial costs ``trials [R, T]``: the accepted trial's excess over
        the current cost, or an earlier trial's shortfall below it (any
        trial's, for a rejected search); each trial's amount times
        ``share``, the current iterate's part of the two costs'
        rounding."""
        t_ref = torch.where(border, raw, trials)
        below = torch.nan_to_num((c_ref[r, None] - t_ref) * share,
                                 nan=-float("inf"))
        sure = torch.where(border, -float("inf"), below)
        worst_earlier = torch.where(earlier[r], sure, -float("inf")).amax(1)
        jr = j[r, None]
        at_j = -below.gather(1, jr)[:, 0]                # trial j's excess
        at_j = torch.where(border.gather(1, jr)[:, 0] & torch.isinf(at_j),
                           torch.zeros_like(at_j), at_j)
        return torch.where(acc[r], torch.maximum(at_j, worst_earlier),
                           sure.amax(1))

    every = torch.arange(q, device=device)
    viol = violation(every, st.trials, st.trials_raw, st.trials_border)
    # the next record (the final state after the last)
    nxt = {k: torch.cat([o[k][:, 1:], o["final_" + k][:, None]], 1)
           for k in ("mu", "prec_diag", "prec_off")}
    # where the accepted step moved the iterate, the program's own
    # direction is (next - current) / step: its trials are read along it,
    # so that a float32 direction's rounding does not move the decision
    mv = torch.as_tensor(moving.reshape(q), device=device)
    own = torch.nonzero(mv).flatten()
    if own.numel():
        tj = sv[j[own]]
        cur = [flat(o[k])[own] for k in ("mu", "prec_diag", "prec_off")]
        d = [(flat(nxt[k])[own] - c) / tj.reshape(-1, *[1] * (c.ndim - 1))
             for k, c in zip(("mu", "prec_diag", "prec_off"), cur)]
        *trials, cond = dense_gvi.trials_along(
            problems, pid[own], *cur, *d,
            torch.as_tensor(temps.reshape(q), dtype=f64, device=device)[own],
            steps)
        # a trial's cost rounds by its own conditioning, the current one's
        # by the iterate's: the pair's rounding is their sum
        viol[own] = violation(own, *trials,
                              st.cond[own, None] / (st.cond[own, None] + cond))
    viol = torch.where(torch.isnan(c_ref),
                       torch.where(acc, float("inf"), 0.0), viol)
    search = torch.clamp_min(viol, 0.0) / st.scale

    # the step to the next record
    t = torch.where(mv, sv[j], torch.zeros_like(a))
    errs = []
    for k, d in (("mu", st.dmu), ("mu", st.other), ("prec_diag", st.dprec_d),
                 ("prec_off", st.dprec_o)):
        cur = flat(o[k])
        tb = t.reshape(-1, *([1] * (cur.ndim - 1)))
        dstep = torch.where(tb != 0, tb * d, torch.zeros_like(d))
        pred = cur + dstep
        if k == "prec_diag":
            pred = torch.where(tb != 0, 0.5 * (pred + pred.transpose(-1, -2)),
                               pred)
        dims = tuple(range(1, cur.ndim))
        num = _inf_norm(flat(nxt[k]) - pred, dims)
        den = _inf_norm(dstep, dims) + 64 * eps * _inf_norm(cur, dims)
        err = torch.nan_to_num(num, nan=float("inf")) / den
        errs.append(torch.where(num == 0, torch.zeros_like(err), err))
    # where Vddmu is near indefinite the program may take either branch
    errs[0] = torch.where(st.other_border, torch.minimum(errs[0], errs[1]),
                          errs[0])
    del errs[1]
    step = torch.maximum(errs[0], torch.maximum(errs[1], errs[2]))
    # the rounding the configured precision allows: the cost by the
    # iterate's conditioning, the step by that and the direction's
    # (Vddmu's conditioning times the cancellation in its sums)
    cost_scale = st.cond * eps
    step_scale = (st.cond + st.cond_vdd * st.cancel) * eps
    # a decision along the program's direction compares two costs (their
    # rounding, in the current iterate's part); along the reference's,
    # the direction's rounding enters
    search_scale = torch.where(mv, cost_scale, step_scale)

    per = lambda x: x.reshape(p, iters).amax(1)               # noqa: E731
    scaled = {"cost": (cost, cost_scale), "search": (search, search_scale),
              "step": (step, step_scale)}
    res = {"start": start.cpu().numpy(),
           **{k: per(v / sc).cpu().numpy() for k, (v, sc) in scaled.items()},
           **{k + "_rel": per(v).cpu().numpy()
              for k, (v, _) in scaled.items()}}
    for k, (v, sc) in scaled.items():
        if limits and k in limits:
            void = ~(limits[k] * sc < 1)
            res["void_" + k] = void.reshape(p, iters).sum(1).cpu().numpy()
            res[k + "_wc"] = per(torch.where(void, torch.zeros_like(v),
                                             v / sc)).cpu().numpy()
    return res


def verdict(read: dict, limits: dict):
    """``(bad [P], checks)``: the problems with a number above its limit
    (NaN counts as above) and each number that has a limit, the largest
    over the problems, beside it."""
    bad = np.zeros(len(read["start"]), bool)
    checks = {}
    for name, limit in limits.items():
        v = read[name]
        bad |= ~(v <= limit)
        checks[name] = {"value": float(np.max(v)) if len(v) else 0.0,
                        "limit": limit}
    return bad, checks
