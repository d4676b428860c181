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


def weight_key(modules) -> tuple:
    """What identifies the parameters and buffers of `modules` as they
    stand: each tensor's device, dtype, storage and version counter (an
    in-place change bumps it). Caches of what is made from weights (kernel
    packs, a bf16 copy) are keyed by it."""
    return tuple((str(t.device), t.dtype, t.data_ptr(), t._version)
                 for mod in modules
                 for t in (*mod.parameters(), *mod.buffers()))
