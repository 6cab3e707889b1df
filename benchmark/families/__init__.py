"""Configuration families: how a configuration's inputs are drawn from
the seed and handed to the program and to the plain reference.  A
configuration's file names its family (``"family"``); a module here of
that name provides

* ``make_shared(cfg)``: inputs every problem shares (a map), or None;
* ``make_inputs(cfg, rng, requests, per_request)``: the raw arrays of
  ``requests`` requests of ``per_request`` problems each, one row a
  problem, with the initial mean ``init_mu [P, N, s]``;
* ``build_problem(cfg, inputs, i, dtype, device, shared, base=None)``:
  problem ``i``'s graph alone, through the program's public
  constructors, reusing the factors every problem shares from ``base``;
* ``build_program(cfg, inputs, dtype, device, shared)``: the program's
  graph of all those problems: problem 0's given every problem's own
  leaves (``batch_graph``), which equals ``batching.stack_problems`` of
  every problem's graph (``tests/test_bench_reference.py``) without building
  them one by one;
* ``build_reference(cfg, inputs, guard_eps, device, shared)``: the
  reference's problems (``reference/dense_gvi.Problems``);
* ``shapes(cfg)``: the shapes the work counts take (``work.py``).
"""

from __future__ import annotations

from dataclasses import fields, replace

# the fields of the program's factor batches that hold one problem's data
PER_PROBLEM = {
    "nonlinear": ("params", "kernel_params"),
    "linear": ("lam", "psi", "target_mu", "target_prec", "constant"),
}


def batch_graph(graph, count: int, own: dict):
    """One problem's graph over ``count`` problems: every per-problem leaf
    gets a leading problem axis (a view: each problem reads the same
    data), and the leaves in ``own`` ((kind, index, field) -> a tensor or
    a dict of tensors ``[count, ...]``) take each problem's own."""
    def lead(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: lead(v) for k, v in x.items()}
        return x.expand(count, *x.shape)

    batches = {}
    for kind in PER_PROBLEM:
        batches[kind] = tuple(
            replace(fb, **{f.name: own.get((kind, i, f.name),
                                           lead(getattr(fb, f.name)))
                           for f in fields(fb) if f.name in PER_PROBLEM[kind]})
            for i, fb in enumerate(getattr(graph, kind)))
    return replace(graph, **batches)
