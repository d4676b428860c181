"""LayerNorm and BatchNorm over the last (channel) axis
(se_tpu/nn/norms.py), with torch's parameter and buffer names."""

from __future__ import annotations

import torch
from torch import nn


class LayerNorm(nn.Module):
    """LayerNorm over the trailing axes of `shape` (an int: the last axis;
    DPCRN's (F, C): the last two), eps 1e-5, statistics in fp32 at least
    (fp64 for an fp64 input): (x - mean) / sqrt(var + eps) * weight +
    bias."""

    def __init__(self, shape: int | tuple[int, ...], eps: float = 1e-5):
        super().__init__()
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        self.eps = eps
        self.axes = tuple(range(-len(shape), 0))
        self.weight = nn.Parameter(torch.ones(shape))
        self.bias = nn.Parameter(torch.zeros(shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(self.axes, keepdim=True)
        var = (xf - mean).square().mean(self.axes, keepdim=True)
        y = (xf - mean) * torch.reciprocal(torch.sqrt(var + self.eps))
        return (y * self.weight + self.bias).to(x.dtype)


class BatchNorm(nn.Module):
    """BatchNorm over the last axis, eps 1e-5, as se_tpu's (flax's
    nn.BatchNorm with momentum 1 - 0.1). In eval mode it reads the running
    statistics. In train mode (`module.train()`) it normalises with the
    batch statistics over every axis but the last, the variance biased,
    and updates running = 0.9 running + 0.1 batch (the biased variance
    too, unlike torch's F.batch_norm). It starts in eval mode. Holds
    torch.nn.BatchNorm*d's weight, bias, running_mean and running_var."""

    momentum = 0.1

    def __init__(self, ch: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))
        self.eval()  # as the port's models, until train() asks for it

    def affine(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(scale, shift) with BN(x) = x * scale + shift."""
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return inv, self.bias - self.running_mean * inv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            inv = torch.rsqrt(self.running_var + self.eps)
            return (x - self.running_mean) * inv * self.weight + self.bias
        var, mean = torch.var_mean(x, dim=tuple(range(x.ndim - 1)),
                                   correction=0)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias
