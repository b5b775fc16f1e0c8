"""Device choice for the port's entry points.

Every entry point takes an explicit ``device``.  Without one it runs on the
card, and raises when there is none: nothing here falls back to the CPU
quietly.  Tests pass ``device="cpu"``, which routes every kernel wrapper to
its plain PyTorch version.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``, which must
    exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "largesteps_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    return dev
