"""Device selection for the port."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; for CUDA, raise when no card is present
    (never fall back to the CPU) and turn TF32 off: the one-hot statistic
    matmuls feed argmax-sensitive leave-out scores, which TF32's ~3 decimal
    digits would perturb."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device %r requested but CUDA is not available"
                               % str(device))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError("unsupported device %r" % str(device))
    return device
