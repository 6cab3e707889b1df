"""Full-precision float32 contractions on the GPU.

Counterpart of ``gaussianvi_tpu/ops/precision.py``.  There, every
accuracy-bearing contraction pins ``lax.Precision.HIGHEST`` because the
TPU's default single bf16 pass cost the Hessian moment two digits against
a float64 oracle (PERF.md, "Purpose").  On an NVIDIA card the same loss
comes from TF32: PyTorch keeps it off for float32 matmuls by default but
ON for cuDNN convolutions, and either can be switched on by a caller.
:func:`set_precision_policy` pins both off and asks for "highest" float32
matmul precision; :func:`..inference.optimize.optimize` calls it.
"""

from __future__ import annotations

import torch


def set_precision_policy() -> None:
    """Disable TF32 for matmuls and cuDNN, and pin float32 matmul
    precision to "highest" (process-wide PyTorch settings)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
