"""Device resolution for the port.

A CUDA request on a host without a CUDA device raises; nothing here ever
picks the CPU in its place. Resolving a CUDA device also turns TF32 off
for cuDNN convolutions and cuBLAS matmuls: the JAX package runs every
blur at ``Precision.HIGHEST``, and PyTorch's cuDNN default
(``allow_tf32=True``) would silently keep only ~3 decimal digits in the
plain version's ``F.conv2d``.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` ("cpu", "cuda", "cuda:1", a ``torch.device``, or None for
    the CPU) as a ``torch.device``; raises when CUDA is asked for and not
    present."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is "
                "False (no CUDA device or a CPU-only torch build)")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
