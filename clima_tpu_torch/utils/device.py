"""The device an entry point runs on when the caller names none."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the CUDA card.

    The port runs on the card unless the caller asks for the CPU
    (``device="cpu"``); without a card, None raises rather than picking the
    CPU.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass device='cpu' "
            "to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
