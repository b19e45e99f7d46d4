"""Where the port's entry points run."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``cuda`` unless the caller names a device.  Raises when CUDA is asked for
    and there is no card: the entry points never fall back to the CPU on their
    own; ``device="cpu"`` runs the plain PyTorch versions of the kernels."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU"
        )
    return dev
