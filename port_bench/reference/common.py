"""What the references share: the precision of their products, the STFT
and iSTFT, an LSTM layer, dense layers and norms, written from the
published definitions in plain PyTorch.

Every matrix product and convolution takes its operands through a
`Precision`: `FP32` leaves them as they are (the configuration's float32,
run with TF32 off), `TF32` rounds each operand to TF32's 10-bit mantissa
first (round to nearest, ties away, as `cvt.rna.tf32.f32`) and sums in
fp32, which is what a TF32 tensor-core product computes. The control of
`correct` is the reference at `TF32`, on the card and on the CPU alike.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

EPS32 = float(np.finfo(np.float32).eps)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x (fp32) with its mantissa rounded to 10 bits."""
    bits = x.detach().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class _Round(torch.autograd.Function):
    """An operand rounded to TF32; its gradient passes as it is."""

    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGrad(torch.autograd.Function):
    """A product's output as it is; the gradient it hands back rounded to
    TF32, so that the backward's products take TF32 operands too."""

    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str
    tf32: bool = False

    def _product(self, op, a, b, **kw) -> torch.Tensor:
        if not self.tf32:
            return op(a, b, **kw)
        return _RoundGrad.apply(op(_Round.apply(a), _Round.apply(b), **kw))

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._product(torch.matmul, a, b)

    def conv2d(self, x, w, **kw) -> torch.Tensor:
        return self._product(F.conv2d, x, w, **kw)

    def conv_transpose2d(self, x, w, **kw) -> torch.Tensor:
        return self._product(F.conv_transpose2d, x, w, **kw)


FP32 = Precision("fp32")
TF32 = Precision("tf32", tf32=True)


def hann(win: int, n_fft: int, device) -> torch.Tensor:
    """The periodic Hann window of `win` points, centred in `n_fft`."""
    n = np.arange(win, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win)
    lpad = (n_fft - win) // 2
    w = np.pad(w, (lpad, n_fft - win - lpad))
    return torch.from_numpy(w.astype(np.float32)).to(device)


def stft(x: torch.Tensor, n_fft: int, hop: int, win: int):
    """(B, N) -> (re, im), each (B, 1 + N // hop, n_fft // 2 + 1): the
    centred STFT (reflected ends of n_fft // 2), a real FFT a frame."""
    pad = n_fft // 2
    xp = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = xp.unfold(-1, n_fft, hop) * hann(win, n_fft, x.device)
    spec = torch.fft.rfft(frames, n=n_fft)
    return spec.real.contiguous(), spec.imag.contiguous()


def istft(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop: int,
          win: int, length: int) -> torch.Tensor:
    """The inverse of `stft`: an inverse real FFT a frame, the window,
    overlap-add, divided by the overlap-added squared window where that
    exceeds 1e-11; the centre padding cut, `length` samples (zeros past
    the end)."""
    t = re.shape[-2]
    w = hann(win, n_fft, re.device)
    frames = torch.fft.irfft(torch.complex(re, im), n=n_fft) * w
    total = (t - 1) * hop + n_fft

    def ola(fr):
        cols = fr.reshape(-1, t, n_fft).transpose(1, 2)
        out = F.fold(cols, output_size=(1, total), kernel_size=(1, n_fft),
                     stride=(1, hop))
        return out.reshape(*fr.shape[:-2], total)

    out = ola(frames)
    env = ola((w * w).expand(t, n_fft))
    out = torch.where(env > 1e-11, out / env.clamp(min=1e-11), out)
    out = out[..., n_fft // 2:]
    if out.shape[-1] < length:
        return F.pad(out, (0, length - out.shape[-1]))
    return out[..., :length]


def rms_gain(x: torch.Tensor) -> torch.Tensor:
    """(B, N) -> (B, 1): sqrt(N / energy), the per-utterance gain that
    brings each utterance to unit mean power."""
    energy = x.double().square().sum(-1, keepdim=True)
    return torch.sqrt(x.shape[-1] / energy.clamp(min=1e-12)).float()


def lstm_layer(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
               bias: torch.Tensor, p: Precision) -> torch.Tensor:
    """One LSTM layer, zero initial state: (N, T, In) -> (N, T, H); torch's
    weights (4H, In), (4H, H), the gates in torch's order (i, f, g, o) and
    one bias. Frames are taken by `unbind` and stacked, so that under
    autograd each frame's gradient is its own."""
    xp = p.matmul(x, w_ih.t()) + bias
    n, h_dim = x.shape[0], w_hh.shape[1]
    h = x.new_zeros(n, h_dim)
    c = x.new_zeros(n, h_dim)
    w_t = w_hh.t()
    ys = []
    for xt in xp.unbind(1):
        i, f, g, o = (xt + p.matmul(h, w_t)).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys, dim=1)


def linear(x, sd: dict, name: str, p: Precision) -> torch.Tensor:
    """torch.nn.Linear with `name`.weight (O, I) and `name`.bias."""
    return p.matmul(x, sd[f"{name}.weight"].t()) + sd[f"{name}.bias"]


def layer_norm(x, sd: dict, name: str, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with `name`.weight and `name`.bias."""
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * sd[f"{name}.weight"] \
        + sd[f"{name}.bias"]


def prelu(x, slope) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def attention(q, k, v, p: Precision) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over (N, L, d)."""
    scores = p.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return p.matmul(torch.softmax(scores, dim=-1), v)
