"""Activations with torch-parity parameterization (se_tpu/nn/activations.py)."""

from __future__ import annotations

import torch
from torch import nn


class PReLU(nn.Module):
    """Scalar-slope PReLU, `where(x >= 0, x, a * x)`, init 0.25. The weight
    has torch.nn.PReLU's shape (1,)."""

    def __init__(self, init: float = 0.25):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), float(init)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight * x)
