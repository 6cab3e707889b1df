"""The GVI loop of an ``optimize`` call replayed as one CUDA graph.

On the card a call's loop is some hundred small device operations an
iteration, each issued from Python; on a small batch the device waits for
the host between them.  Here the part of a call after its engine is built
(``gvi.init``, every ``gvi.iter`` and the covariance refresh of
``gvi.finish``) is captured once per call signature into a
``torch.cuda.CUDAGraph`` and replayed by later calls of that signature:
the same kernels in the same order on the same operands, so the same bits
as the eager loop (``optimize.run_gvi_carry``).  Which calls may take it
is the caller's decision (``optimize._graph_call``); this module keeps the
graphs.

* Signature: the call's parameters (``key``: config, method, the engine's
  routes, the window) and the tree of tensors the region reads (initial
  state, graph, fused operands, loop values), each tensor as its shape,
  dtype, strides, device and address modulo ``ALIGN`` bytes (the kernels
  and PyTorch's vectorized loads branch on alignment), each other leaf by
  value, a function or a dict by its presence alone: the region calls no
  function of the graph and reads no dict (the caller's eligibility).
* A signature's first call runs eager, its second captures and replays,
  later ones replay; ``MAX_GRAPHS`` signatures are kept, the least
  recently used dropped first.  While the last graph dropped for room had
  never been replayed (the traffic holds more signatures than are kept),
  a signature captures on its third call instead, so traffic whose
  shapes seldom repeat stays eager.  Where the capture raises (the
  device's memory, an operation that waits for the device), the
  signature runs eager from then on; where the eager loop runs out of
  the device's memory while graphs are kept, their memory is given back
  and it runs again.
* Static inputs: a graph owns a copy of every tensor of the tree, and a
  call copies its own into them before the replay (none that is already
  that copy).  Each batch's per-state index
  (``kernels.fused_trials.state_index``, whose address the kernels'
  pointer tables hold) is built from the static start before the capture
  (its ``bincount`` waits for the device) and refreshed from the call's
  own start before each replay.
* Outputs: ``finish`` builds the call's from the graph's (the history
  stacked, the final carry cloned), so nothing a caller gets back is
  memory a later replay writes.
* Counters: ``kernels.loop_graph_counts()``, the calls by how their loop
  ran; a replay advances ``kernels.launch_counts()`` by what the captured
  run launched.  Spans: ``gvi.capture`` (the loop's own spans inside
  it, recorded as it is captured) and ``gvi.replay``.
"""

from __future__ import annotations

import copy
import dataclasses
import warnings
from collections import OrderedDict

import torch

from .. import kernels
from ..kernels.fused_trials import state_index
from ..utils.profiling import span

MAX_GRAPHS = 8   # signatures kept (seen, with their graph, or failed)
ALIGN = 64       # bytes: a static copy keeps its tensor's address modulo this

_FAILED = "failed"                     # a signature whose capture raised
# signature -> _Graph, _FAILED, or the calls seen without a graph
_GRAPHS: OrderedDict = OrderedDict()
_STREAMS: dict = {}                    # device -> the stream graphs capture on
# whether the last graph dropped for room had never been replayed: the
# traffic holds more signatures than are kept, and a signature then
# captures on its third call, not its second
_WASTED = {"last": False}


def flatten(tree, fn=None):
    """``(structure, leaves, rebuilt)`` of ``tree``: its hashable structure
    (each tensor as its position in ``leaves``, each tensor object once;
    every other leaf by value; a function or a dict by its presence: the
    region calls no function of the graph and reads no dict), its tensors,
    and the tree with every tensor ``t`` as ``fn(t)`` (``t`` itself where
    ``fn`` is None) and every dict as None."""
    leaves, memo = [], {}

    def go(v):
        if isinstance(v, torch.Tensor):
            if id(v) not in memo:
                memo[id(v)] = (("tensor", len(leaves)),
                               v if fn is None else fn(v))
                leaves.append(v)
            return memo[id(v)]
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            parts = {f.name: go(getattr(v, f.name))
                     for f in dataclasses.fields(v)}
            out = copy.copy(v)
            for name, (_, value) in parts.items():
                object.__setattr__(out, name, value)
            return (type(v), tuple(st for st, _ in parts.values())), out
        if isinstance(v, (tuple, list)):
            parts = [go(e) for e in v]
            values = [value for _, value in parts]
            out = (type(v)(*values) if hasattr(v, "_fields")
                   else type(v)(values))
            return (type(v), tuple(st for st, _ in parts)), out
        if isinstance(v, dict):
            return ("dict",), None
        if callable(v):
            return ("function",), v
        return v, v

    structure, rebuilt = go(tree)
    return structure, leaves, rebuilt


def map_tensors(tree, fn):
    """``tree`` with every tensor ``t`` as ``fn(t)`` (one call per tensor
    object) and every dict as None."""
    return flatten(tree, fn)[2]


def _compact(t: torch.Tensor) -> torch.Tensor:
    """``t`` with each broadcast (stride 0) axis cut to one entry."""
    return t.as_strided([1 if st == 0 else n
                         for n, st in zip(t.shape, t.stride())],
                        t.stride(), t.storage_offset())


def _copyable(t: torch.Tensor) -> bool:
    """Whether no two entries of ``_compact(t)`` share memory."""
    reach = 1
    for st, n in sorted((st, n) for n, st in zip(t.shape, t.stride())
                        if n > 1 and st > 0):
        if st < reach:
            return False
        reach += st * (n - 1)
    return True


def _describe(t: torch.Tensor):
    return (tuple(t.shape), t.dtype, t.stride(), t.device,
            t.data_ptr() % ALIGN)


def signature(key, tree):
    """The signature of a call (module docstring), with the tree's tensors
    in order, or ``(None, leaves)`` where a tensor cannot have a static
    copy (its entries overlap) or lies on another device than the
    first."""
    structure, leaves, _ = flatten(tree)
    device = leaves[0].device if leaves else None
    if not all(t.device == device and _copyable(t) for t in leaves):
        return None, leaves
    return (key, structure, tuple(_describe(t) for t in leaves)), leaves


def _static_like(t: torch.Tensor) -> torch.Tensor:
    """Memory of ``t``'s layout, at the same address modulo ``ALIGN``."""
    size = t.element_size()
    offset = t.data_ptr() % ALIGN // size
    span_ = (1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
             if t.numel() else 0)
    buf = torch.empty(offset + span_, dtype=t.dtype, device=t.device)
    return buf.as_strided(t.shape, t.stride(), offset)


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device)
    return _STREAMS[device]


def _set_launches(counts) -> None:
    for name, n in counts.items():
        kernels.WRAPPERS[name].launches = n


class _Graph:
    """One signature's graph, with its static inputs and outputs."""

    def __init__(self, leaves, tree, region, starts):
        ids = {id(t): i for i, t in enumerate(leaves)}
        self.static = [_static_like(t) for t in leaves]
        self.load(leaves)
        where = [(ids[id(t)], n) for t, n in starts]
        self.indexes = [(pos, n, state_index(self.static[pos], n))
                        for pos, n in where]
        static_tree = map_tensors(tree, lambda t: self.static[ids[id(t)]])
        stream = _capture_stream(leaves[0].device)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            # cuBLAS's workspace for this stream, outside the capture
            torch.cuda.current_blas_handle()
        before = kernels.launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream):
            self.out = region(static_tree)
        after = kernels.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        self.replays = 0

    def load(self, leaves):
        """The call's tensors into the static inputs."""
        for src, dst in zip(leaves, self.static):
            if (src.data_ptr(), src.stride()) != (dst.data_ptr(),
                                                  dst.stride()):
                _compact(dst).copy_(_compact(src))

    def replay(self, leaves):
        """The graph run on the call's tensors: the static outputs."""
        self.load(leaves)
        for pos, n, index in self.indexes:
            if leaves[pos].data_ptr() != self.static[pos].data_ptr():
                index.copy_(state_index(leaves[pos], n))
        self.graph.replay()
        return self.out


def _capture(sig, leaves, tree, region, starts):
    """``sig``'s graph, kept; or None where the capture raised, and the
    signature runs eager from then on.  Either way the launch counters
    read as before it (a replay counts the launches), and a failed
    capture's memory is given back when its traceback goes."""
    before = kernels.launch_counts()
    try:
        graph = _Graph(leaves, tree, region, starts)
    except Exception as err:   # noqa: BLE001 - the eager loop runs instead
        _GRAPHS[sig] = _FAILED
        warnings.warn(f"the GVI loop's CUDA graph capture raised {err!r}; "
                      "calls of this signature run eager", RuntimeWarning)
        return None
    finally:
        _set_launches(before)
    _GRAPHS[sig] = graph
    return graph


def _replay(graph, leaves, finish, kind):
    """``finish`` of the graph's replay on the call's tensors, counted as
    ``kind``; None where that ran out of the device's memory."""
    try:
        out = finish(graph.replay(leaves))
    except torch.OutOfMemoryError:
        return None
    for name, n in graph.launches.items():
        kernels.WRAPPERS[name].launches += n
    kernels.LOOP_GRAPH_COUNTS[kind] += 1
    graph.replays += kind == "replayed"
    return out


def _eager(eager):
    """``eager()``, counted; run again without the kept graphs' memory
    where it runs out of the device's."""
    kernels.LOOP_GRAPH_COUNTS["eager"] += 1
    if not any(isinstance(g, _Graph) for g in _GRAPHS.values()):
        return eager()
    before = kernels.launch_counts()
    try:
        return eager()
    except torch.OutOfMemoryError:
        _set_launches(before)
    for sig, entry in _GRAPHS.items():
        if isinstance(entry, _Graph):
            _GRAPHS[sig] = 1
    return eager()


def _make_room() -> None:
    """Drop the least recently used signatures beyond ``MAX_GRAPHS``."""
    while len(_GRAPHS) > MAX_GRAPHS:
        _, old = _GRAPHS.popitem(last=False)
        if isinstance(old, _Graph):
            _WASTED["last"] = not old.replays


def run(key, tree, eager, region=None, finish=None, starts=()):
    """A call's loop: ``eager()`` where ``key`` is None (the call may not
    take a graph), the signature's capture is not due (module docstring)
    or failed, else ``finish(out)`` of the static outputs ``out`` that
    ``region(static tree)`` gave at capture, replayed on this call's
    tensors.  ``starts``: ``[(start tensor of the tree, n)]``, the factor
    batches' starts on chains of ``n`` states whose per-state index the
    kernels read."""
    sig, leaves = (None, ()) if key is None else signature(key, tree)
    entry = None if sig is None else _GRAPHS.get(sig, 0)
    if isinstance(entry, int):            # one more call without a graph
        entry = _GRAPHS[sig] = entry + 1
    if sig is not None:
        _GRAPHS.move_to_end(sig)
        _make_room()
    out = None
    if isinstance(entry, _Graph):
        with span("gvi.replay"):
            out = _replay(entry, leaves, finish, "replayed")
    elif isinstance(entry, int) and entry >= 2 + _WASTED["last"]:
        with span("gvi.capture"):
            graph = _capture(sig, leaves, tree, region, starts)
            if graph is not None:
                out = _replay(graph, leaves, finish, "captured")
            del graph
    del entry   # a kept graph's memory, for the eager loop
    return _eager(eager) if out is None else out


def clear() -> None:
    """Drop every kept signature and graph (their memory goes back to
    PyTorch's allocator)."""
    _GRAPHS.clear()
    _WASTED["last"] = False
