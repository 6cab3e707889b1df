"""Where the port's tensors live unless the caller says otherwise.

The port runs on an NVIDIA GPU.  Every function that builds tensors from
nothing (a problem, a prior, an identity precision) takes ``device=None``
and resolves it here: the current CUDA device, and a ``RuntimeError`` on a
host without one, never a silent CPU.  The CPU is taken only when asked
for (``device="cpu"``), as the CPU tests do.  Functions that take tensors
follow their tensors' device.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The current CUDA device; raises where there is no card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "gaussianvi_tpu_torch finds no CUDA device (no GPU is visible to "
            "PyTorch): its entry points run on the card unless asked for "
            "the CPU with device='cpu'")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means :func:`default_device`."""
    return default_device() if device is None else torch.device(device)
