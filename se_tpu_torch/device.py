"""Where the port's entry points run."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the card. Raises when CUDA is asked for and absent:
    the port never carries on on the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "se_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
