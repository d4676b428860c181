"""Complex-valued primitives as (real, imag) pairs (se_tpu/nn/complex_ops.py).

A complex op with shared real/imag sub-ops combines them as
out_re = op_r(x_re) - op_i(x_im), out_im = op_i(x_re) + op_r(x_im).
Complex feature maps carry their channels as [real-half | imag-half].
The complex convs and the dense layer compute in their input's dtype, the
kernel and bias cast to it, as se_tpu's (`w.astype(x.dtype)`).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from se_tpu_torch.nn.conv import (
    ConvParams, Linear, conv2d_nhwc, conv_transpose2d_nhwc,
    interleave_complex_bias, interleave_complex_kernel,
)
from se_tpu_torch.nn.recurrent import LSTM


def split_complex(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    c = x.shape[-1] // 2
    return x[..., :c], x[..., c:]


def merge_complex(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    return torch.cat([re, im], dim=-1)


def complex_cat(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concat keeping the [reals | imags] halves."""
    reals, imags = zip(*(split_complex(x) for x in xs))
    return torch.cat(list(reals) + list(imags), dim=-1)


class _ComplexConvBase(nn.Module):
    """Children real_conv / imag_conv in the reference (O|I, I|O, kf, kt)
    layout; `features` counts the total (re + im) output channels."""

    def __init__(self, cin: int, features: int, kernel: tuple[int, int],
                 transpose: bool):
        super().__init__()
        half = features // 2
        self.real_conv = ConvParams(cin // 2, half, kernel, transpose)
        self.imag_conv = ConvParams(cin // 2, half, kernel, transpose)

    def block(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The interleaved (kt, kf, 2cin, 2cout) kernel and its bias: one
        conv on [re | im] computes both parts."""
        w = interleave_complex_kernel(self.real_conv.hwio(),
                                      self.imag_conv.hwio())
        return w, interleave_complex_bias(self.real_conv.bias,
                                          self.imag_conv.bias)


class ComplexConv2d(_ComplexConvBase):
    """Complex conv over (T, F) with explicit padding ((t_lo, t_hi),
    (f_lo, f_hi))."""

    def __init__(self, cin: int, features: int, kernel: tuple[int, int],
                 stride=(1, 1), padding=((0, 0), (0, 0))):
        super().__init__(cin, features, kernel, transpose=False)
        self.stride, self.padding = tuple(stride), padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.block()
        out = conv2d_nhwc(x, w.to(x.dtype), self.stride, self.padding)
        return out + b.to(out.dtype)


class ComplexConvTranspose2d(_ComplexConvBase):
    """Complex transposed conv, torch.nn.ConvTranspose2d geometry."""

    def __init__(self, cin: int, features: int, kernel: tuple[int, int],
                 stride=(1, 1), padding=(0, 0), output_padding=(0, 0)):
        super().__init__(cin, features, kernel, transpose=True)
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.output_padding = tuple(output_padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.block()
        out = conv_transpose2d_nhwc(x, w.to(x.dtype), self.stride,
                                    self.padding, self.output_padding)
        return out + b.to(out.dtype)


class NaiveComplexLSTM(nn.Module):
    """Shared real/imag single-layer LSTMs combined complex-wise, with
    re and im stacked on the batch (two layer calls, not four); optional
    Linear projections r_trans / i_trans. (B, T, D) pairs in and out."""

    def __init__(self, input_size: int, hidden: int,
                 projection_dim: int | None = None):
        super().__init__()
        h = hidden // 2
        self.real_lstm = LSTM(input_size, h)
        self.imag_lstm = LSTM(input_size, h)
        if projection_dim is not None:
            self.r_trans = Linear(h, projection_dim // 2)
            self.i_trans = Linear(h, projection_dim // 2)
        self.projection_dim = projection_dim

    def forward(self, re: torch.Tensor, im: torch.Tensor):
        b = re.shape[0]
        z = torch.cat([re, im], dim=0)
        zr = self.real_lstm(z)  # (r2r, i2r)
        zi = self.imag_lstm(z)  # (r2i, i2i)
        out_re = zr[:b] - zi[b:]
        out_im = zr[b:] + zi[:b]
        if self.projection_dim is not None:
            out_re, out_im = self.r_trans(out_re), self.i_trans(out_im)
        return out_re, out_im


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
        x = torch.cat([re, im], dim=-1)
        out = torch.matmul(x, w.to(x.dtype))
        out = out + torch.cat([br - bi, br + bi]).to(out.dtype)
        return out[..., : self.features], out[..., self.features:]
