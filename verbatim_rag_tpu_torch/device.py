"""Device resolution for the port's entry points.

``device=None`` means ``cuda``. With no GPU, an entry point raises unless the
caller asked for the CPU explicitly (``device="cpu"``, as the tests do): the
port never carries on silently on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; raise if the requested CUDA device is missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU"
            )
        # float32 products stay float32 (as in the JAX package): never TF32.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
