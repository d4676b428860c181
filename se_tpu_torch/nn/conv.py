"""Convolution and dense primitives in NHWC = (B, T, F, C) layout, and the
TCM families' 1-D convs on (B, T, C) (se_tpu/nn/conv.py).

Parameters keep the reference PyTorch layouts: Conv2d weights (O, I, ka,
kb), ConvTranspose2d weights (I, O, ka, kb), unflipped, where (ka, kb) is
(kf, kt) for references that run on (B, C, F, T) (Uformer, DCCRN:
`freq_first=True`) and (kt, kf) for those on (B, C, T, F) (CRN, GCRN,
DPCRN). `hwio()` gives se_tpu's (kt, kf, I, O) view. `Conv2d` and
`ConvTranspose2d` run torch's convolutions (these convs are outside any
Pallas kernel in se_tpu), with torch's geometry: a transposed conv gives
(in - 1) * stride - 2 * pad + kernel + output_padding. `Conv2d`,
`ConvTranspose2d` and `Linear` compute in their input's and weights' one
promoted dtype (`ops._dtype.promoted`), as se_tpu's do in a bf16 decode: a
bf16 input stays bf16, an fp32 one widens bf16 weights.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from se_tpu_torch.ops._dtype import promoted


def _uniform_(t: torch.Tensor, bound: float, generator: torch.Generator):
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


class ConvParams(nn.Module):
    """Weight and bias of one Conv2d (or ConvTranspose2d) with torch's
    names and init, for layers that run the conv inside a kernel."""

    def __init__(self, cin: int, cout: int, kernel: tuple[int, int],
                 transpose: bool = False, freq_first: bool = True):
        super().__init__()
        kt, kf = kernel
        self.transpose, self.freq_first = transpose, freq_first
        spatial = (kf, kt) if freq_first else (kt, kf)
        shape = (cin, cout) if transpose else (cout, cin)
        self.weight = nn.Parameter(torch.zeros(*shape, *spatial))
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
        w = self.weight.transpose(2, 3) if self.freq_first else self.weight
        return w.permute(2, 3, 0, 1) if self.transpose else \
            w.permute(2, 3, 1, 0)


class Conv2d(ConvParams):
    """se_tpu.nn.Conv2d: correlation over (T, F) with explicit padding
    ((t_lo, t_hi), (f_lo, f_hi)); weight (O, I, kt, kf)."""

    def __init__(self, cin: int, cout: int, kernel: tuple[int, int],
                 stride=(1, 1), padding=((0, 0), (0, 0))):
        super().__init__(cin, cout, kernel, transpose=False, freq_first=False)
        self.stride, self.padding = tuple(stride), padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = promoted(x, self.hwio(), self.bias)
        return conv2d_nhwc(x, w, self.stride, self.padding) + b


class ConvTranspose2d(ConvParams):
    """se_tpu.nn.ConvTranspose2d: torch.nn.ConvTranspose2d over (T, F);
    weight (I, O, kt, kf)."""

    def __init__(self, cin: int, cout: int, kernel: tuple[int, int],
                 stride=(1, 1), padding=(0, 0), output_padding=(0, 0)):
        super().__init__(cin, cout, kernel, transpose=True, freq_first=False)
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.output_padding = tuple(output_padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = promoted(x, self.hwio(), self.bias)
        return conv_transpose2d_nhwc(x, w, self.stride, self.padding,
                                     self.output_padding) + b


class GluConv2d(nn.Module):
    """conv1(x) * sigmoid(conv2(x)) (se_tpu.nn.GluConv2d)."""

    def __init__(self, cin: int, cout: int, kernel: tuple[int, int],
                 stride=(1, 1)):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, kernel, stride)
        self.conv2 = Conv2d(cin, cout, kernel, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv1(x) * torch.sigmoid(self.conv2(x))


class GluConvTranspose2d(nn.Module):
    """deconv1(x) * sigmoid(deconv2(x)) (se_tpu.nn.GluConvTranspose2d)."""

    def __init__(self, cin: int, cout: int, kernel: tuple[int, int],
                 stride=(1, 1), output_padding=(0, 0)):
        super().__init__()
        self.conv1 = ConvTranspose2d(cin, cout, kernel, stride,
                                     output_padding=output_padding)
        self.conv2 = ConvTranspose2d(cin, cout, kernel, stride,
                                     output_padding=output_padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv1(x) * torch.sigmoid(self.conv2(x))


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
        x, w, b = promoted(x, self.weight, self.bias)
        return torch.matmul(x, w.t()) + b


class Conv1d(nn.Module):
    """A 1-D conv on (B, T, C) as torch.nn.Conv1d holds it: weight (O, I,
    k), bias (O,) or none. With k = 1 it is se_tpu's bias-free (or biased)
    nn.Dense that the reference writes as a Conv1d(k=1); otherwise, with
    `padding` "causal", se_tpu's CausalConv1d: (k - 1) * dilation frames
    of zeros before T and none after; with "same", flax's nn.Conv
    padding="SAME": (k - 1) * dilation // 2 frames before, the rest after.
    k = 1 runs a matmul on the channel axis, k > 1 F.conv1d (se_tpu
    computes these outside any Pallas kernel)."""

    def __init__(self, cin: int, cout: int, kernel: int = 1,
                 dilation: int = 1, bias: bool = True,
                 padding: str = "causal"):
        super().__init__()
        if padding not in ("causal", "same"):
            raise ValueError(f"unknown padding {padding!r}")
        self.dilation = dilation
        total = (kernel - 1) * dilation
        self.pads = (total, 0) if padding == "causal" else \
            (total // 2, total - total // 2)
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        """torch's init: U(+-1/sqrt(I * k)) for weight and bias."""
        bound = 1.0 / math.sqrt(self.weight.shape[1] * self.weight.shape[2])
        _uniform_(self.weight, bound, generator)
        if self.bias is not None:
            _uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight.shape[2] == 1:
            y = torch.matmul(x, self.weight[:, :, 0].t())
            return y if self.bias is None else y + self.bias
        xn = F.pad(x.transpose(1, 2), self.pads)
        return F.conv1d(xn, self.weight, self.bias,
                        dilation=self.dilation).transpose(1, 2)


class ShareSepConv(nn.Module):
    """One kernel of length k shared by every channel of (B, T, C), k - 1
    frames of zeros before T: a depthwise F.conv1d with the weight
    expanded to (C, 1, k). Weight (1, 1, k) as the reference's; init a
    one at (k - 1) // 2, the identity shifted by k // 2 frames."""

    def __init__(self, kernel: int):
        super().__init__()
        w = torch.zeros(1, 1, kernel)
        w[0, 0, (kernel - 1) // 2] = 1.0
        self.weight = nn.Parameter(w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c, k = x.shape[-1], self.weight.shape[-1]
        xn = F.pad(x.transpose(1, 2), (k - 1, 0))
        return F.conv1d(xn, self.weight.expand(c, 1, k),
                        groups=c).transpose(1, 2)


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


def conv_transpose2d_nhwc(x: torch.Tensor, w: torch.Tensor, strides=(1, 1),
                          padding=(0, 0), output_padding=(0, 0)):
    """torch.nn.ConvTranspose2d's geometry on x (B, T, F, Cin) with an
    unflipped (kt, kf, Cin, Cout) kernel: each axis gives (in - 1) *
    stride - 2 * pad + kernel + output_padding."""
    out = F.conv_transpose2d(x.permute(0, 3, 1, 2), w.permute(2, 3, 0, 1),
                             stride=tuple(strides), padding=tuple(padding),
                             output_padding=tuple(output_padding))
    return out.permute(0, 2, 3, 1)
