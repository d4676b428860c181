"""Complex-valued primitives as (real, imag) pairs (se_tpu/nn/complex_ops.py).

A complex op with shared real/imag sub-ops combines them as
out_re = op_r(x_re) - op_i(x_im), out_im = op_i(x_re) + op_r(x_im).
"""

from __future__ import annotations

import torch
from torch import nn

from se_tpu_torch.nn.conv import Linear


class ComplexDense(nn.Module):
    """Complex linear layer with children real_linear / imag_linear, run as
    ONE matmul on channel-concat [re | im] with the block weight
    [[Wr, Wi], [-Wi, Wr]]."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.features = features
        self.real_linear = Linear(cin, features)
        self.imag_linear = Linear(cin, features)

    def forward(self, re: torch.Tensor, im: torch.Tensor):
        kr, ki = self.real_linear.weight.t(), self.imag_linear.weight.t()
        br, bi = self.real_linear.bias, self.imag_linear.bias
        w = torch.cat([torch.cat([kr, ki], dim=-1),
                       torch.cat([-ki, kr], dim=-1)], dim=0)
        out = torch.matmul(torch.cat([re, im], dim=-1), w)
        out = out + torch.cat([br - bi, br + bi])
        return out[..., : self.features], out[..., self.features:]
