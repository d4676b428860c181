"""Convolution and dense primitives in NHWC = (B, T, F, C) layout
(se_tpu/nn/conv.py).

Parameters keep the reference PyTorch layouts, whose spatial axes are
(F, T): Conv2d weights are (O, I, kf, kt), ConvTranspose2d weights
(I, O, kf, kt), unflipped. `hwio()` gives se_tpu's (kt, kf, I, O) view.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _uniform_(t: torch.Tensor, bound: float, generator: torch.Generator):
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


class ConvParams(nn.Module):
    """Weight and bias of one Conv2d (or ConvTranspose2d) with torch's
    names and init, for layers that run the conv inside a kernel."""

    def __init__(self, cin: int, cout: int, kernel: tuple[int, int],
                 transpose: bool = False):
        super().__init__()
        kt, kf = kernel
        self.transpose = transpose
        shape = (cin, cout, kf, kt) if transpose else (cout, cin, kf, kt)
        self.weight = nn.Parameter(torch.zeros(shape))
        self.bias = nn.Parameter(torch.zeros(cout))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """U(+-1/sqrt(fan_in)) with se_tpu's fans: kt*kf*cin for the
        kernel, kt*kf*(cout if transpose else cin) for the bias."""
        w = self.weight
        cin, cout = (w.shape[0], w.shape[1]) if self.transpose else \
            (w.shape[1], w.shape[0])
        k = w.shape[2] * w.shape[3]
        _uniform_(w, 1.0 / math.sqrt(k * cin), generator)
        fan = k * (cout if self.transpose else cin)
        _uniform_(self.bias, 1.0 / math.sqrt(fan), generator)

    def hwio(self) -> torch.Tensor:
        """(kt, kf, I, O) kernel, unflipped for a transposed conv."""
        if self.transpose:
            return self.weight.permute(3, 2, 0, 1)
        return self.weight.permute(3, 2, 1, 0)


class Linear(nn.Module):
    """torch.nn.Linear: weight (O, I), bias (O,)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        _uniform_(self.weight, bound, generator)
        _uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.weight.t()) + self.bias


def interleave_complex_kernel(kr: torch.Tensor, ki: torch.Tensor):
    """Block kernel for one complex conv on channel-concat [re | im] input:
    out[..., :cout] = conv_r(re) - conv_i(im), out[..., cout:] =
    conv_i(re) + conv_r(im). (kh, kw, cin, cout) -> (kh, kw, 2cin, 2cout)."""
    top = torch.cat([kr, ki], dim=-1)
    bot = torch.cat([-ki, kr], dim=-1)
    return torch.cat([top, bot], dim=-2)


def interleave_complex_bias(br: torch.Tensor, bi: torch.Tensor):
    """Bias for the block conv: [b_r - b_i, b_r + b_i]."""
    return torch.cat([br - bi, br + bi])


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, strides=(1, 1),
                padding=((0, 0), (0, 0)), dilation=(1, 1)) -> torch.Tensor:
    """Correlation of x (B, T, F, Cin) with an HWIO kernel (kt, kf, Cin,
    Cout), explicit per-axis padding ((t_lo, t_hi), (f_lo, f_hi))."""
    (t_lo, t_hi), (f_lo, f_hi) = padding
    xn = F.pad(x.permute(0, 3, 1, 2), (f_lo, f_hi, t_lo, t_hi))
    out = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=tuple(strides),
                   dilation=tuple(dilation))
    return out.permute(0, 2, 3, 1)
