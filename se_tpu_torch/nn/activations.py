"""Activations with torch-parity parameterization (se_tpu/nn/activations.py),
and flax's dropout."""

from __future__ import annotations

import torch
from torch import nn

from se_tpu_torch.parallel.mesh import data_size, row_offset


class PReLU(nn.Module):
    """se_tpu's PReLU, `where(x >= 0, x, a * x)`, init 0.25: one slope
    (`channels` None; torch.nn.PReLU()'s weight of shape (1,)) or one a
    channel on the last axis (torch.nn.PReLU(channels): weight (C,))."""

    def __init__(self, channels: int | None = None, init: float = 0.25):
        super().__init__()
        shape = (1,) if channels is None else (channels,)
        self.weight = nn.Parameter(torch.full(shape, float(init)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight * x)


class Dropout(nn.Module):
    """flax's nn.Dropout: in train mode keep ~ Bernoulli(1 - rate), then
    where(keep, x / (1 - rate), 0), drawn from `generator` (a
    torch.Generator on x's device; train mode without one raises); the
    identity in eval mode, where it starts, or at rate 0. Under an active
    mesh, x being this rank's rows of a batch-major global tensor, the
    mask is drawn for the global tensor and this rank's rows kept: the
    masks equal one device's, and the ranks' generators stay in step."""

    def __init__(self, rate: float = 0.1):
        super().__init__()
        self.rate = rate
        self.eval()

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("dropout in train mode draws from a "
                             "torch.Generator: pass `generator`")
        keep_prob = 1.0 - self.rate
        n, ranks = x.shape[0], data_size()
        keep = torch.rand((n * ranks, *x.shape[1:]), generator=generator,
                          device=x.device, dtype=x.dtype) < keep_prob
        if ranks > 1:
            start = row_offset(n)
            keep = keep[start:start + n]
        return torch.where(keep, x / keep_prob, 0.0)
