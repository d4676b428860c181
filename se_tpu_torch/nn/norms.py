"""LayerNorm and eval-mode BatchNorm over the last (channel) axis
(se_tpu/nn/norms.py), with torch's parameter and buffer names."""

from __future__ import annotations

import torch
from torch import nn


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, eps 1e-5, statistics in fp32:
    (x - mean) / sqrt(var + eps) * weight + bias."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        y = (xf - mean) * torch.reciprocal(torch.sqrt(var + self.eps))
        return (y * self.weight + self.bias).to(x.dtype)


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over the last axis, eps 1e-5: the running
    statistics are read, never updated. Holds torch.nn.BatchNorm*d's
    weight, bias, running_mean and running_var."""

    def __init__(self, ch: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def affine(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(scale, shift) with BN(x) = x * scale + shift."""
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return inv, self.bias - self.running_mean * inv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps)
        return (x - self.running_mean) * inv * self.weight + self.bias
