"""Which device an entry point of the port runs on."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA card. The
    port's entry points run on the card unless the caller asks for
    another device, so without a card None raises instead of carrying on
    on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run on the CPU"
        )
    return torch.device("cuda")
