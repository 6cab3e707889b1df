"""Multi-process execution: one process per (dp, fp) mesh position.

Counterpart of ``gaussianvi_tpu/parallel/multiprocess.py``.  JAX joins the
processes with ``jax.distributed`` and lays one global mesh over their
devices; here every rank is a ``torch.distributed`` process that builds the
same global problem batch, keeps its shard and runs
:func:`.sharding.optimize_sharded`.

Device and backend: the ranks run on the card unless asked for the CPU.
``device="cuda"`` (the default) gives rank ``r`` GPU ``r`` modulo the
host's count, ``"cuda:i"`` puts every rank on one card, ``"cpu"`` is taken
only when asked for.  ``backend=None`` (the default) follows from that
(:func:`resolve_backend`): ``"nccl"`` when every rank has a GPU of its own,
``"gloo"`` otherwise: CPU tensors, or several ranks on one card (NCCL
refuses two ranks on one device), where gloo copies each CUDA tensor
through host memory.  A rank asked for a GPU that finds none raises.

Launch one process per rank,

    python -m gaussianvi_tpu_torch.parallel.multiprocess \\
        --init-method tcp://HOST:PORT --world-size W --rank R --dp D --fp F

or let one command spawn them all on this host:

    python -m gaussianvi_tpu_torch.parallel.multiprocess --spawn 4 --dp 2 --fp 2

Each rank checks its sharded run against ``optimize`` on the same problems
and prints one ``MULTIPROC OK`` line.
"""

from __future__ import annotations

import argparse
import datetime
import multiprocessing
import os
import queue
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


def resolve_backend(backend: str | None, device: str,
                    world_size: int) -> str:
    """The backend for ``world_size`` ranks on ``device``: as given, or
    (None) ``"nccl"`` where every rank gets a GPU of its own (``"cuda"``
    with at least ``world_size`` cards, or a single rank) and ``"gloo"``
    where ranks share a card or run on the CPU."""
    if backend is not None:
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r} (one of "
                             f"{BACKENDS})")
        return backend
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo"
    own_card = world_size == 1 or (
        dev.index is None and world_size <= torch.cuda.device_count())
    return "nccl" if own_card else "gloo"


def initialize_multiprocess(init_method: str, world_size: int, rank: int,
                            backend: str | None = None, device: str = "cuda",
                            timeout_s: float = 300.0) -> torch.device:
    """Join the process group and return this rank's device.

    ``init_method``: a ``torch.distributed`` rendezvous URL
    (``tcp://host:port`` or ``file:///path``).  ``device``: ``"cuda"``
    (rank r takes GPU r modulo the host's count: NCCL's layout),
    ``"cuda:i"`` (e.g. every rank on card 0 under gloo) or, only when asked
    for, ``"cpu"``.  ``backend``: None follows the device
    (:func:`resolve_backend`).  ``timeout_s`` bounds every collective, so a
    lost rank fails the others instead of hanging them."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"rank {rank} was asked for {device!r} but "
                           "finds no CUDA device (no GPU is visible to "
                           "PyTorch); pass device='cpu' to run on the CPU")
    backend = resolve_backend(backend, device, world_size)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError("backend 'nccl' needs a CUDA device per rank")
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def gather_problems(x: torch.Tensor, mesh) -> torch.Tensor:
    """The per-problem results of every dp row, concatenated along the
    leading axis in dp order, on every rank of the group (the
    ``process_allgather`` of the JAX demo).  ``x`` is this rank's dp block;
    the ranks of a row hold the same block, so row ``i``'s is read from its
    first rank."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return x
    src = x.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, src)
    return torch.cat([parts[row * mesh.fp] for row in range(mesh.dp)], dim=0)


# ---------------------------------------------------------------------------
# spawning every rank from one process
# ---------------------------------------------------------------------------

def _rank_main(fn, rank, world_size, init_method, backend, device, timeout_s,
               args, results):
    try:
        torch.set_num_threads(1)
        dev = initialize_multiprocess(init_method, world_size, rank, backend,
                                      device, timeout_s)
        out = fn(rank, world_size, dev, *args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        results.put((rank, True, out))
    except BaseException:       # reported to the parent, then re-raised
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, world_size: int, args=(), backend: str | None = None,
                device: str = "cuda", timeout_s: float = 300.0,
                rendezvous_dir: str | None = None) -> list:
    """Run ``fn(rank, world_size, device, *args)`` in ``world_size`` fresh
    processes joined in one process group; returns the ranks' results in
    rank order.  ``device`` and ``backend`` as
    :func:`initialize_multiprocess` takes them: the card by default, the
    CPU only when asked for.

    ``fn`` is a module-level function and ``args`` and the results pickle
    (numpy arrays, not tensors on a device).  The processes use the
    ``spawn`` start method and rendezvous through a file under
    ``rendezvous_dir`` (a temporary directory by default).  Raises
    ``RuntimeError`` with the rank's traceback where a rank failed, and
    where a rank has not answered after ``timeout_s`` seconds; either way
    every process is stopped before returning."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=rendezvous_dir) as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(
            target=_rank_main,
            args=(fn, rank, world_size, init_method, backend, device,
                  timeout_s, args, results), daemon=True)
            for rank in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        done, failure = {}, None
        try:
            while len(done) < world_size and failure is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    missing = sorted(set(range(world_size)) - set(done))
                    failure = (f"ranks {missing} did not finish within "
                               f"{timeout_s:.0f} s")
                    break
                try:
                    rank, ok, out = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if not p.is_alive() and p.exitcode != 0
                            and r not in done]
                    if dead:
                        failure = (f"ranks {dead} died with exit codes "
                                   f"{[procs[r].exitcode for r in dead]}")
                    continue
                if ok:
                    done[rank] = out
                else:
                    failure = f"rank {rank} failed:\n{out}"
        finally:
            for p in procs:
                p.join(timeout=0 if failure else 30)
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
                    if p.is_alive():
                        p.kill()
                        p.join()
    if failure is not None:
        raise RuntimeError(f"spawn_ranks: {failure}")
    return [done[rank] for rank in range(world_size)]


# ---------------------------------------------------------------------------
# demo: the sharded run against optimize, per rank
# ---------------------------------------------------------------------------

def demo_rank(rank: int, world_size: int, device: torch.device, dp: int,
              fp: int, num_problems: int) -> str:
    """``optimize_sharded`` over a (dp, fp) mesh against ``optimize`` on
    the same problems (the JAX demo's: N=8, dim_x=1, 3 iterations,
    float64): costs to rtol 1e-9, final means to rtol 1e-7 / atol 1e-10.
    Every rank builds the same global batch."""
    from ..batching import stack_problems
    from ..examples.chain_estimation import build_chain_estimation
    from ..inference import GVIConfig, optimize
    from .collective import make_mesh
    from .sharding import optimize_sharded

    mesh = make_mesh(dp, fp)
    problems = [build_chain_estimation(num_states=8, dim_x=1, gh_degree=4,
                                       seed=seed, device=device)[:2]
                for seed in range(num_problems)]
    graph_b, state_b = stack_problems(*map(list, zip(*problems)))
    config = GVIConfig(niters=3, step_size_base=0.9)
    if not mesh.member:
        return f"MULTIPROC IDLE rank={rank} (outside the {dp}x{fp} mesh)"
    state, hist = optimize_sharded(graph_b, state_b, config, mesh)
    costs = gather_problems(hist.cost, mesh)
    mu = gather_problems(state.mu, mesh)
    final, ref = optimize(graph_b, state_b, config)
    torch.testing.assert_close(costs, ref.cost, rtol=1e-9, atol=0)
    torch.testing.assert_close(mu, final.mu, rtol=1e-7, atol=1e-10)
    return (f"MULTIPROC OK rank={rank} mesh={dp}x{fp} "
            f"backend={dist.get_backend()} device={device} "
            f"all_reduces={mesh.all_reduces} "
            f"costs0={costs[0].tolist()}")


def _demo_main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spawn", type=int, default=None, metavar="W",
                    help="spawn W ranks on this host (no --rank needed)")
    ap.add_argument("--init-method", default=None)
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--dp", type=int, required=True)
    ap.add_argument("--fp", type=int, required=True)
    ap.add_argument("--backend", choices=BACKENDS, default=None,
                    help="default: nccl where every rank has its own GPU, "
                         "gloo where ranks share a card or run on the CPU")
    ap.add_argument("--device", default="cuda",
                    help="cuda (GPU = rank, the default), cuda:i (one card) "
                         "or cpu")
    ap.add_argument("--problems", type=int, default=None,
                    help="global batch (default: one problem per dp row)")
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args(argv)
    demo_args = (args.dp, args.fp, args.problems or args.dp)
    if args.spawn is not None:
        for line in spawn_ranks(demo_rank, args.spawn, demo_args,
                                args.backend, args.device, args.timeout):
            print(line)
        return 0
    if None in (args.init_method, args.world_size, args.rank):
        ap.error("give --spawn W, or --init-method, --world-size and --rank")
    dev = initialize_multiprocess(args.init_method, args.world_size,
                                  args.rank, args.backend, args.device,
                                  args.timeout)
    try:
        print(demo_rank(args.rank, args.world_size, dev, *demo_args))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_demo_main())
