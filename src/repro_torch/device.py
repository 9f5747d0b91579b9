"""The port's device rule, shared by every entry point: the card unless the
caller names another device, and no silent CPU fallback."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The entry points' device: the caller's, else ``cuda``.  Without a
    GPU an explicit ``device="cpu"`` is required: there is no silent CPU
    fallback."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run the plain (non-kernel) versions on the CPU")
    return device
