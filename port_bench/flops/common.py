"""FLOPs counted on a reference by `torch.utils.flop_counter` on the meta
device: 2 per multiply-add of its matrix products and convolutions, at
the cell's shapes, with no data and no device time."""

from __future__ import annotations


def meta_state(sd: dict) -> dict:
    import torch

    return {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in sd.items()}


def counted(fn, *args) -> float:
    """FLOPs of `fn(*args)`."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


def least_seconds(flops: float, nbytes: float, peak_flops: float,
                  peak_bytes: float) -> float:
    """The roofline: the larger of the operations' and the bytes' time."""
    return max(flops / peak_flops, nbytes / peak_bytes)
