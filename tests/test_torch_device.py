"""PyTorch port, the device rule: entry points that build tensors put them
on the card unless the caller asks for the CPU.  ``device=None`` resolves
through ``default_device``: the current CUDA device, and a ``RuntimeError``
naming the missing card on a host without one, never a silent CPU.
Whether there is a card is decided inside each test."""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gaussianvi_tpu_torch import default_device  # noqa: E402
from gaussianvi_tpu_torch.convert import state_from_arrays  # noqa: E402
from gaussianvi_tpu_torch.examples.chain_estimation import (  # noqa: E402
    build_chain_estimation,
)
from gaussianvi_tpu_torch.factors.base import make_nonlinear_batch  # noqa: E402
from gaussianvi_tpu_torch.factors.priors import (  # noqa: E402
    fixed_prior,
    minimum_acc_prior,
)
from gaussianvi_tpu_torch.ops.blocktridiag import BlockTridiag  # noqa: E402
from gaussianvi_tpu_torch.parallel import multiprocess  # noqa: E402

NO_CARD = "no CUDA device"
_STATE = {"mu": np.zeros((3, 2)), "prec_diag": np.tile(np.eye(2), (3, 1, 1)),
          "prec_off": np.zeros((2, 2, 2))}

# name -> (function taking device, a tensor of what it built)
MAKERS = {
    "build_chain_estimation": (
        lambda device: build_chain_estimation(num_states=4, device=device),
        lambda out: out[1].mu),
    "fixed_prior": (
        lambda device: fixed_prior(0, [0.0, 1.0], np.eye(2), device=device),
        lambda out: out.lam),
    "minimum_acc_prior": (
        lambda device: minimum_acc_prior(np.eye(1), 0.1, 4, device=device),
        lambda out: out.start),
    "make_nonlinear_batch": (
        lambda device: make_nonlinear_batch(
            lambda x, p: x.sum(-1), np.arange(3), state_dim=2, gh_degree=3,
            device=device),
        lambda out: out.nodes),
    "BlockTridiag.identity": (
        lambda device: BlockTridiag.identity((), 3, 2, device=device),
        lambda out: out.off),
    "BlockTridiag.zeros": (
        lambda device: BlockTridiag.zeros((), 3, 2, torch.float64,
                                          device=device),
        lambda out: out.diag),
    "state_from_arrays": (
        lambda device: state_from_arrays(_STATE, device=device),
        lambda out: out.precision.diag),
}


def test_default_device_is_the_card_or_raises():
    if torch.cuda.is_available():
        assert default_device() == torch.device(
            "cuda", torch.cuda.current_device())
    else:
        with pytest.raises(RuntimeError, match=NO_CARD):
            default_device()


@pytest.mark.parametrize("name", sorted(MAKERS))
def test_device_none_means_the_card(name):
    """Without ``device`` the tensors go on the card, and
    raises the error that names the missing card where there is none."""
    build, tensor_of = MAKERS[name]
    if torch.cuda.is_available():
        assert tensor_of(build(None)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match=NO_CARD):
            build(None)


@pytest.mark.parametrize("name", sorted(MAKERS))
def test_the_cpu_is_taken_when_asked_for(name):
    build, tensor_of = MAKERS[name]
    for device in ("cpu", torch.device("cpu")):
        assert tensor_of(build(device)).device.type == "cpu"


def test_every_tensor_of_a_cpu_problem_is_on_the_cpu():
    graph, state, _ = build_chain_estimation(num_states=4, device="cpu")
    leaves = [state.mu, state.precision.diag, state.precision.off]
    for fb in graph.nonlinear:
        leaves += [fb.start, fb.nodes, fb.weights, fb.kernel_params,
                   *fb.params.values()]
    for lb in graph.linear:
        leaves += [lb.start, lb.lam, lb.psi, lb.target_mu, lb.target_prec,
                   lb.constant]
    assert all(t.device.type == "cpu" for t in leaves)


def test_multiprocess_defaults_to_the_card():
    """``spawn_ranks``, ``initialize_multiprocess`` and the demo default to
    ``device="cuda"`` with the backend following the device."""
    for fn in (multiprocess.spawn_ranks,
               multiprocess.initialize_multiprocess):
        params = inspect.signature(fn).parameters
        assert params["device"].default == "cuda"
        assert params["backend"].default is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match=NO_CARD):
            multiprocess.initialize_multiprocess("tcp://localhost:1", 1, 0)


@pytest.mark.parametrize("backend,device,world,want", [
    (None, "cpu", 4, "gloo"),
    (None, "cuda:0", 4, "gloo"),       # ranks share one card
    (None, "cuda:0", 1, "nccl"),       # a single rank owns its card
    ("gloo", "cuda", 2, "gloo"),       # as given
    ("nccl", "cuda", 2, "nccl"),
])
def test_backend_follows_the_device(backend, device, world, want):
    assert multiprocess.resolve_backend(backend, device, world) == want


def test_backend_by_card_count():
    """``device="cuda"``: NCCL where every rank has a card of its own,
    gloo where there are more ranks than cards."""
    cards = torch.cuda.device_count()
    assert multiprocess.resolve_backend(None, "cuda", cards + 2) == "gloo"
    if cards >= 2:
        assert multiprocess.resolve_backend(None, "cuda", cards) == "nccl"
    with pytest.raises(ValueError, match="unknown backend"):
        multiprocess.resolve_backend("mpi", "cuda", 2)


def test_the_demo_runs_on_the_card_by_default():
    """The demo without ``--device`` asks every rank for its card: on a
    host without one the rank's error names the missing card."""
    if torch.cuda.is_available():
        pytest.skip("the demo's default run on a card belongs to the "
                    "card's own checks")
    with pytest.raises(RuntimeError, match=NO_CARD):
        multiprocess._demo_main(["--spawn", "1", "--dp", "1", "--fp", "1",
                                 "--timeout", "60"])
