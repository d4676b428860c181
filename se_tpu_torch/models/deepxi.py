"""DeepXi, a deep a-priori SNR estimator with a statistical gain: the port
of se_tpu/models/deepxi.py (ref DeepXi/deepxi/model.py:34-711,
network/tcn.py:116-225, map.py:15-608, inp_tgt.py:68-215, sig.py:43-260).

Shipped configuration (ref DeepXi/config_resnet.py:40-66): ResNetV2 with
40 bottleneck residual blocks, d_model 256, d_f 64, k 3, cyclic dilation
up to 16, causal padding, unit "ReLU->LN->W+b", sigmoid output; the noisy
magnitude in, the mapped a-priori SNR xi out (DBNormalCDF map); decode
`y = |X| * gfunc(xi_hat, xi_hat + 1, "mmse-lsa")` with the noisy phase.

The STFT is tf.signal's convention (hamming, 512/256, pad_end:
PRESET_DEEPXI); `polar_analysis` takes it from `ops.stft_fused.stft_auto`,
the STFT kernel on the card for a (B, n) waveform. ResLSTM's layers run
`nn.recurrent.lstm_layer`: the LSTM kernels on the card. Everything else
is torch ops.

The reference is TensorFlow and ships no weights, so there is no reference
state_dict: the parameter names follow se_tpu's flax tree (`net.ff_conv.
weight`, `net.b0_1_conv.weight`, `net.lstm0.weight_ih_l0`, ...), and
`from_jax_variables` carries se_tpu's variables in. Every dense layer is a
`Conv1d` with k = 1 (the reference's Conv1D), weight (O, I, 1); flax's
LayerNorms are `OnePassLayerNorm`s (eps 1e-6, flax's one-pass variance).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from se_tpu_torch.device import resolve_device
from se_tpu_torch.eval.gains import gfunc
from se_tpu_torch.models import jax_tree as jt
from se_tpu_torch.models.registry import ModelEntry, register
from se_tpu_torch.nn import LSTM, Conv1d, OnePassLayerNorm, lstm_layer
from se_tpu_torch.ops.stft import PRESET_DEEPXI, istft
from se_tpu_torch.ops.stft_fused import stft_auto


# ------------------------------------------------------------------ xi maps

def _db(x):
    return 10.0 * torch.log(torch.clamp(x, min=1e-12)) / math.log(10.0)


def _db_inverse(x_db):
    return torch.pow(10.0, x_db / 10.0)


def _sign(v):
    return torch.sign(v) if isinstance(v, torch.Tensor) else float(np.sign(v))


@dataclasses.dataclass
class XiMap:
    """Invertible scalar map family (ref DeepXi/deepxi/map.py), as
    se_tpu's: `map_type` composes prefixes ("DBNormalCDF" = dB, then the
    Gaussian CDF). The statistics (`mu`, `sigma`, `vmin`, `vmax`, `b`:
    numpy, one value a bin) come from `fit` on a (N, F) sample, in numpy
    as se_tpu's; `map` and `inverse` take tensors on any device."""

    map_type: str
    params: Any = None
    mu: Any = None
    sigma: Any = None
    vmin: Any = None
    vmax: Any = None
    b: Any = None

    @staticmethod
    def _t(v, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(np.asarray(v), dtype=like.dtype,
                               device=like.device)

    def _pre(self, x):
        if "Square" in self.map_type:
            x = torch.square(x)
        if "DB" in self.map_type:
            x = _db(x)
        return x

    def _post(self, x):
        if "DB" in self.map_type:
            x = _db_inverse(x)
        if "Square" in self.map_type:
            x = torch.sqrt(x)
        return x

    @staticmethod
    def _laplace_cdf(x, mu, b):
        v = x - mu
        return 0.5 + 0.5 * _sign(v) * (1.0 - torch.exp(-abs(v) / b))

    @staticmethod
    def _laplace_cdf_inverse(x_bar, mu, b):
        v = x_bar - 0.5
        return mu - b * torch.sign(v) * torch.log(
            torch.clamp(1.0 - 2.0 * torch.abs(v), min=1e-12))

    def fit(self, xi_sample: np.ndarray) -> None:
        """Per-frequency-bin statistics from a (N, F) training sample."""
        x = self._pre(torch.from_numpy(
            np.asarray(xi_sample, np.float32))).numpy()
        if "NormalCDF" in self.map_type or "Standardise" in self.map_type:
            self.mu = x.mean(axis=0)
            self.sigma = x.std(axis=0)
        elif "MinMaxScaling" in self.map_type:
            self.vmin = x.min(axis=0)
            self.vmax = x.max(axis=0)
        elif "TruncatedLaplaceCDF" in self.map_type:
            mu, lower, upper = self.params
            self.b = np.array([
                (x[:, i][(x[:, i] > mu) & (x[:, i] < upper)] - mu).mean()
                for i in range(x.shape[1])])
        elif "LaplaceCDF" in self.map_type:
            mu = self.params
            self.b = np.array([(x[:, i][x[:, i] > mu] - mu).mean()
                               for i in range(x.shape[1])])

    def _truncation(self, like):
        mu, lower, upper = self.params
        b = self._t(self.b, like)
        return mu, lower, upper, b, self._laplace_cdf(lower, mu, b), \
            self._laplace_cdf(upper, mu, b)

    def map(self, x: torch.Tensor) -> torch.Tensor:
        mt = self.map_type
        if "NormalCDF" in mt:
            x = self._pre(x)
            return 0.5 * (1.0 + torch.special.erf(
                (x - self._t(self.mu, x))
                / self._t(self.sigma * np.sqrt(2.0), x)))
        if "TruncatedLaplaceCDF" in mt:
            mu, lower, upper, b, lo, hi = self._truncation(x)
            x = self._pre(x)
            x_bar = (self._laplace_cdf(x, mu, b) - lo) / (hi - lo)
            x_bar = torch.where(x < lower, torch.zeros_like(x), x_bar)
            return torch.where(x > upper, torch.ones_like(x), x_bar)
        if "LaplaceCDF" in mt:
            x = self._pre(x)
            return self._laplace_cdf(x, self.params, self._t(self.b, x))
        if "UniformCDF" in mt:
            a, b = self.params
            return (x - a) / (b - a)
        if "Standardise" in mt:
            return (self._pre(x) - self._t(self.mu, x)) / self._t(self.sigma,
                                                                   x)
        if "MinMaxScaling" in mt:
            x = self._pre(x)
            vmin = self._t(self.vmin, x)
            return torch.clamp((x - vmin) / (self._t(self.vmax, x) - vmin),
                               0.0, 1.0)
        if "Logistic" in mt:
            k, x0 = self.params
            if "DB" in mt:
                x = _db(x)
            return 1.0 / (1.0 + torch.exp(-k * (x - x0)))
        if "Clip" in mt:
            lo, hi = self.params
            x_bar = torch.clamp(x, lo, hi)
            if "Square" in mt:
                x_bar = torch.square(x_bar)
            if "DB" in mt:
                x_bar = _db(x_bar)
            return x_bar
        if "Square" in mt:
            x_bar = torch.square(x)
            return _db(x_bar) if "DB" in mt else x_bar
        if mt == "DB":
            return _db(x)
        if mt == "Linear":
            return x
        raise ValueError(f"invalid map_type {mt!r}")

    def inverse(self, x_bar: torch.Tensor) -> torch.Tensor:
        mt = self.map_type
        if "NormalCDF" in mt:
            # exact 0 / 1 (saturated fp32 sigmoids) clipped so that
            # erfinv stays finite, as se_tpu
            x_bar = torch.clamp(x_bar, 1e-7, 1.0 - 1e-7)
            x = self._t(self.mu, x_bar) + self._t(
                self.sigma * np.sqrt(2.0), x_bar) * torch.special.erfinv(
                    2.0 * x_bar - 1.0)
            return self._post(x)
        if "TruncatedLaplaceCDF" in mt:
            mu, _, _, b, lo, hi = self._truncation(x_bar)
            x = self._laplace_cdf_inverse(x_bar * (hi - lo) + lo, mu, b)
            return _db_inverse(x) if "DB" in mt else x
        if "LaplaceCDF" in mt:
            x = self._laplace_cdf_inverse(x_bar, self.params,
                                          self._t(self.b, x_bar))
            return _db_inverse(x) if "DB" in mt else x
        if "UniformCDF" in mt:
            a, b = self.params
            return x_bar * (b - a) + a
        if "Standardise" in mt:
            return self._post(x_bar * self._t(self.sigma, x_bar)
                              + self._t(self.mu, x_bar))
        if "MinMaxScaling" in mt:
            vmin = self._t(self.vmin, x_bar)
            return self._post(x_bar * (self._t(self.vmax, x_bar) - vmin)
                              + vmin)
        if "Logistic" in mt:
            k, x0 = self.params
            x = x0 - torch.log(torch.clamp(1.0 / x_bar - 1.0,
                                           min=1e-12)) / k
            return _db_inverse(x) if "DB" in mt else x
        if "Clip" in mt:
            x = x_bar
            if "DB" in mt:
                x = _db_inverse(x)
            if "Square" in mt:
                x = torch.sqrt(x)
            return x
        if "Square" in mt:
            x = _db_inverse(x_bar) if "DB" in mt else x_bar
            return torch.sqrt(x)
        if mt == "DB":
            return _db_inverse(x_bar)
        if mt == "Linear":
            return x_bar
        raise ValueError(f"invalid map_type {mt!r}")


# ----------------------------------------------------------------- networks

def _outp_act(out: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "Sigmoid":
        return torch.sigmoid(out)
    if kind == "ReLU":
        return F.relu(out)
    if kind == "Linear":
        return out
    raise ValueError("Invalid outp_act")


def _n_rates(max_d_rate: int) -> int:
    return int(np.log2(max_d_rate)) + 1


class ResNetV2(nn.Module):
    """Causal bottleneck-residual TCN with cyclic dilation (ref
    network/tcn.py:116-225): (B, T, n_feat) -> (B, T, n_outp). The first
    LayerNorm is scale-only, the block units' have neither scale nor
    bias. Each block: three units of LN and ReLU (in `unit_type`'s order)
    then a conv (1, k dilated causal, 1), and the residual."""

    UNIT_TYPES = ("ReLU->LN->W+b", "LN->ReLU->W+b")
    # the block units' LayerNorm affine and conv bias
    UNIT_NORM = dict(scale=False, bias=False)
    UNIT_BIAS = True

    def __init__(self, n_feat: int = 257, n_outp: int = 257,
                 n_blocks: int = 40, d_model: int = 256, d_f: int = 64,
                 k: int = 3, max_d_rate: int = 16,
                 unit_type: str = "ReLU->LN->W+b", outp_act: str = "Sigmoid"):
        super().__init__()
        if unit_type not in self.UNIT_TYPES:
            raise ValueError(f"invalid unit_type {unit_type!r}")
        self.n_blocks, self.unit_type, self.outp_act = (n_blocks, unit_type,
                                                        outp_act)
        self._first(n_feat, d_model)
        rates = _n_rates(max_d_rate)
        for i in range(n_blocks):
            d_rate = 2 ** (i % rates)
            for j, (cin, cout, kk, d) in enumerate(
                    ((d_model, d_f, 1, 1), (d_f, d_f, k, d_rate),
                     (d_f, d_model, 1, 1)), 1):
                self.add_module(f"b{i}_{j}_norm",
                                OnePassLayerNorm(cin, **self.UNIT_NORM))
                self.add_module(f"b{i}_{j}_conv",
                                Conv1d(cin, cout, kk, d, bias=self.UNIT_BIAS))
        self.out_conv = Conv1d(d_model, n_outp)

    def _first(self, n_feat: int, d_model: int) -> None:
        self.ff_conv = Conv1d(n_feat, d_model)
        self.ff_norm = OnePassLayerNorm(d_model, scale=True, bias=False)

    def first(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.ff_norm(self.ff_conv(x)))

    def _unit(self, x: torch.Tensor, name: str) -> torch.Tensor:
        norm = getattr(self, f"{name}_norm")
        x = F.relu(norm(x)) if self.unit_type == "LN->ReLU->W+b" \
            else norm(F.relu(x))
        return getattr(self, f"{name}_conv")(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.first(x)
        for i in range(self.n_blocks):
            y = h
            for j in (1, 2, 3):
                y = self._unit(y, f"b{i}_{j}")
            h = h + y
        return _outp_act(self.out_conv(h), self.outp_act)


class ResNet(ResNetV2):
    """ResNet V1 (ref network/tcn.py:17-114): full LayerNorms (scale and
    bias), bias-free convs but the output's, units LN -> ReLU -> conv."""

    UNIT_NORM = {}
    UNIT_BIAS = False

    def __init__(self, n_feat: int = 257, n_outp: int = 257,
                 n_blocks: int = 40, d_model: int = 256, d_f: int = 64,
                 k: int = 3, max_d_rate: int = 16, outp_act: str = "Sigmoid"):
        super().__init__(n_feat, n_outp, n_blocks, d_model, d_f, k,
                         max_d_rate, "LN->ReLU->W+b", outp_act)

    def _first(self, n_feat: int, d_model: int) -> None:
        self.ff_conv = Conv1d(n_feat, d_model, bias=False)
        self.ff_norm = OnePassLayerNorm(d_model)


class ResNetV3(ResNetV2):
    """ResNetV2 with the amended first layer (ref tcn.py:227-245): conv
    with bias -> ReLU -> a LayerNorm without scale or bias."""

    def _first(self, n_feat: int, d_model: int) -> None:
        self.ff_conv = Conv1d(n_feat, d_model)
        self.ff_norm = OnePassLayerNorm(d_model, scale=False, bias=False)

    def first(self, x: torch.Tensor) -> torch.Tensor:
        return self.ff_norm(F.relu(self.ff_conv(x)))


class MHANet(nn.Module):
    """Causal multi-head attention network (ref network/attention.py:
    15-176); V3 (`learned_pos`) adds a learned positional embedding
    `pos_embedding` (max_len, d_model) (ref attention.py:387-433).

    Zero-padded frames (every feature 0: Keras' Masking(0.0)) take no part
    in attention: V1 adds -1e9 to the masked logits and multiplies the
    softmax by the pairwise sequence mask (ref attention.py:189-246); V2
    (`v2`, tfa.MultiHeadAttention, ref attention.py:278-385) adds -10e9 *
    (1 - mask) and does not re-zero, so a padded query row attends
    uniformly. The attention is an einsum here as in se_tpu (not its
    Pallas attention), the projections bias-free."""

    def __init__(self, n_feat: int = 257, n_outp: int = 257,
                 d_model: int = 256, n_blocks: int = 5, n_heads: int = 8,
                 causal: bool = True, outp_act: str = "Sigmoid",
                 learned_pos: bool = False, max_len: int = 2048,
                 v2: bool = False):
        super().__init__()
        self.n_blocks, self.n_heads, self.causal = n_blocks, n_heads, causal
        self.outp_act, self.v2 = outp_act, v2
        self.ff_conv = Conv1d(n_feat, d_model, bias=False)
        self.ff_norm = OnePassLayerNorm(d_model)
        self.pos_embedding = nn.Parameter(torch.zeros(max_len, d_model)) \
            if learned_pos else None
        for i in range(n_blocks):
            for p in "qkvo":
                self.add_module(f"b{i}_{p}",
                                Conv1d(d_model, d_model, bias=False))
            self.add_module(f"b{i}_ln1", OnePassLayerNorm(d_model))
            self.add_module(f"b{i}_ff1", Conv1d(d_model, 4 * d_model))
            self.add_module(f"b{i}_ff2", Conv1d(4 * d_model, d_model))
            self.add_module(f"b{i}_ln2", OnePassLayerNorm(d_model))
        self.out_conv = Conv1d(d_model, n_outp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        h = F.relu(self.ff_norm(self.ff_conv(x)))
        if self.pos_embedding is not None:
            h = h + self.pos_embedding[:t][None]
        valid = torch.any(x != 0, dim=-1)  # (B, T), Masking(0.0)
        seq_pair = valid[:, None, :] & valid[:, :, None]  # (B, T, T)
        mask = seq_pair[:, None]  # (B, 1, T, T)
        if self.causal:
            mask = mask & torch.ones(t, t, dtype=torch.bool,
                                     device=x.device).tril()[None, None]
        seq_f = seq_pair[:, None].to(x.dtype)
        d_model = h.shape[-1]
        d_k = d_model // self.n_heads

        def split(z):
            return z.reshape(b, t, self.n_heads, d_k).transpose(1, 2)

        for i in range(self.n_blocks):
            q, k, v = (getattr(self, f"b{i}_{p}")(h) for p in "qkv")
            logits = torch.matmul(split(q), split(k).transpose(-1, -2))
            logits = logits / np.sqrt(d_k)
            if self.v2:
                logits = logits - 10e9 * (1.0 - mask.to(logits.dtype))
                att = torch.softmax(logits, dim=-1)
            else:
                logits = torch.where(mask, logits, logits - 1e9)
                att = torch.softmax(logits, dim=-1) * seq_f
            ctx = torch.matmul(att, split(v)).transpose(1, 2)
            ctx = getattr(self, f"b{i}_o")(ctx.reshape(b, t, d_model))
            h = getattr(self, f"b{i}_ln1")(h + ctx)
            ffn = getattr(self, f"b{i}_ff2")(
                F.relu(getattr(self, f"b{i}_ff1")(h)))
            h = getattr(self, f"b{i}_ln2")(h + ffn)
        return _outp_act(self.out_conv(h), self.outp_act)


class ResLSTM(nn.Module):
    """Residual LSTM stack (ref network/rnn.py:13-78): a bias-free dense
    layer, LN and ReLU, then a residual LSTM a block, each with one bias
    as every LSTM of the port (`bias_hh` a zero buffer, as Keras and
    se_tpu); ResBiLSTM (`bidirectional`) adds a second LSTM over the
    reversed sequence, reversed back, and sums the two (merge_mode "sum",
    ref rnn.py:80-101): that LSTM runs as a reverse-direction layer
    (`lstm_layer(..., reverse=True)`: the kernel reads the frames from the
    end), which is se_tpu's flip, LSTM, flip without the two copies."""

    def __init__(self, n_feat: int = 257, n_outp: int = 257,
                 n_blocks: int = 5, d_model: int = 512,
                 outp_act: str = "Sigmoid", bidirectional: bool = False):
        super().__init__()
        self.n_blocks, self.outp_act = n_blocks, outp_act
        self.bidirectional = bidirectional
        self.ff = Conv1d(n_feat, d_model, bias=False)
        self.ff_norm = OnePassLayerNorm(d_model)
        for i in range(n_blocks):
            self.add_module(f"lstm{i}", LSTM(d_model, d_model))
            if bidirectional:
                self.add_module(f"lstm{i}_rev_dir", LSTM(d_model, d_model))
        self.out = Conv1d(d_model, n_outp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.ff_norm(self.ff(x)))
        for i in range(self.n_blocks):
            y = getattr(self, f"lstm{i}")(h)
            if self.bidirectional:
                rev = getattr(self, f"lstm{i}_rev_dir")
                y = y + lstm_layer(h, *rev.layer_weights("l0"), reverse=True)
            h = h + y
        return _outp_act(self.out(h), self.outp_act)


class RDLNet(nn.Module):
    """Residual-dense lattice network (ref DeepXi/deepxi/network/
    rdlnet.py:13-163), as se_tpu's RDLNet (whose docstring lists the
    reference quirks kept: the dangling unit of rdlnet.py:99 omitted, the
    "scale*LN+center->ReLU->W+b" unit's discarded LN). Each block is a
    triangular lattice of dilated conv units: H = (L - 1) // 2 + 1 rows,
    L columns; row h has m_1 / 2^h filters, kernel 2h + 1, dilation 2^h.
    Units join by weighted residuals (the wider tensor projected to the
    narrower by a bias-free dense layer, `_proj`) and channel concats;
    each block's output is concatenated onto its input. `padding`
    "causal" or "same" (flax's padding="SAME").

    `_lattice` walks the lattice once for the widths (in the constructor,
    which makes each unit's modules) and once for the tensors (forward),
    in se_tpu's order."""

    UNIT_TYPES = ("ReLU->LN->W+b", "scale*LN+center->ReLU->W+b")

    def __init__(self, n_feat: int = 257, n_outp: int = 257,
                 n_blocks: int = 3, length: int = 7, m_1: int = 64,
                 padding: str = "causal", unit_type: str = "ReLU->LN->W+b",
                 outp_act: str = "Sigmoid"):
        super().__init__()
        if unit_type not in self.UNIT_TYPES:
            raise ValueError(f"invalid unit_type {unit_type!r}")
        self.n_blocks, self.length, self.m_1 = n_blocks, length, m_1
        self.unit_type, self.outp_act = unit_type, outp_act

        def unit(width, n_filt, k, d_rate, name):
            if unit_type == "ReLU->LN->W+b":
                self.add_module(f"{name}_norm", OnePassLayerNorm(
                    width, scale=False, bias=False))
            self.add_module(f"{name}_conv", Conv1d(width, n_filt, k, d_rate,
                                                   padding=padding))
            return n_filt

        def wres(wx, wy, name):
            if wx != wy:
                self.add_module(f"{name}_proj",
                                Conv1d(max(wx, wy), min(wx, wy), bias=False))
            return min(wx, wy)

        width = n_feat
        for i in range(n_blocks):
            width += self._lattice(width, i, unit, wres, lambda a, b: a + b)
        self.out_conv = Conv1d(width, n_outp)

    def _unit(self, x, n_filt, k, d_rate, name):
        x = F.relu(x)
        if self.unit_type == "ReLU->LN->W+b":
            x = getattr(self, f"{name}_norm")(x)
        return getattr(self, f"{name}_conv")(x)

    def _wres(self, x, y, name):
        if x.shape[-1] > y.shape[-1]:
            x = getattr(self, f"{name}_proj")(x)
        elif x.shape[-1] < y.shape[-1]:
            y = getattr(self, f"{name}_proj")(y)
        return x + y

    def _lattice(self, inp, bi, unit, wres, cat):
        """se_tpu's `_block`: the lattice over `inp` with the unit, weighted
        residual and concat given (on widths or on tensors)."""
        length = self.length
        height = (length - 1) // 2 + 1
        midpoint = (length + 1) // 2
        lat = [[None] * length for _ in range(height)]
        for l in range(midpoint):
            # the last ascending column runs its rows top-down (rdlnet.py:
            # 66-67) so that its h + 1 concat finds that unit built
            rows = range(height) if l != midpoint - 1 else \
                reversed(range(height))
            for h in rows:
                if h > l:
                    continue
                if l == 0:
                    unit_inp = inp
                elif l == h:
                    unit_inp = lat[h - 1][l - 1]
                else:
                    unit_inp = lat[h][l - 1]
                name = f"b{bi}_h{h}_l{l}"
                u = unit(unit_inp, int(self.m_1 / 2 ** h), 2 * (h + 1) - 1,
                         2 ** h, name)
                if l == h:
                    out = u
                elif h == 0 and l == 1:
                    out = wres(u, inp, name)
                elif h + 1 == l:
                    out = wres(u, lat[h - 1][l - 2], name)
                else:
                    out = wres(u, lat[h][l - 2], name)
                if l == 0 or h == height - 1 or (h == 0 and l < midpoint - 1):
                    pass
                elif l == midpoint - 1:
                    out = cat(out, lat[h + 1][l])
                else:
                    out = cat(out, lat[h - 1][l])
                lat[h][l] = out
        for l in range(midpoint, length):
            for h in reversed(range(height)):
                if h >= length - l:
                    continue
                name = f"b{bi}_h{h}_l{l}"
                u = unit(lat[h][l - 1], int(self.m_1 / 2 ** h),
                         2 * (h + 1) - 1, 2 ** h, name)
                out = wres(u, lat[h][l - 2], name)
                if l != length - h - 1:
                    out = cat(out, lat[h + 1][l])
                lat[h][l] = out
        return lat[0][length - 1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.n_blocks):
            h = torch.cat([self._lattice(h, i, self._unit, self._wres,
                                         lambda a, b: torch.cat([a, b], -1)),
                           h], dim=-1)
        return _outp_act(self.out_conv(h), self.outp_act)


# --------------------------------------------------------------- MagXi glue

def polar_analysis(x: torch.Tensor):
    """Waveform -> (STMS, STPS), the magnitude and phase under tf.signal's
    convention (ref deepxi/sig.py:43-55)."""
    re, im = stft_auto(x, PRESET_DEEPXI)
    return torch.sqrt(re * re + im * im), torch.atan2(im, re)


def polar_synthesis(stms: torch.Tensor, stps: torch.Tensor, length=None):
    """(STMS, STPS) -> waveform (ref deepxi/sig.py:57-69)."""
    return istft(stms * torch.cos(stps), stms * torch.sin(stps),
                 PRESET_DEEPXI, length=length)


def instantaneous_xi(s_stms, d_stms):
    """|S|^2 / max(|D|^2, 1e-12) (ref sig.py:110-121)."""
    return torch.square(s_stms) / torch.clamp(torch.square(d_stms),
                                              min=1e-12)


@torch.no_grad()
def compute_xi_stats(clean_wavs: Sequence[np.ndarray],
                     noise_wavs: Sequence[np.ndarray], xi_map: XiMap,
                     device=None) -> XiMap:
    """Fit `xi_map` to the instantaneous xi of each (clean, noise) pair
    (ref model.py:84-96, inp_tgt.py:155-166), float waveforms at 16 kHz,
    each pair cut to its shorter length. The STFTs run on `device` (None
    means the card); the fit is numpy."""
    dev = resolve_device(device)
    frames = []
    for s, d in zip(clean_wavs, noise_wavs):
        n = min(len(s), len(d))
        s_stms, _ = polar_analysis(torch.as_tensor(
            np.asarray(s[:n], np.float32))[None].to(dev))
        d_stms, _ = polar_analysis(torch.as_tensor(
            np.asarray(d[:n], np.float32))[None].to(dev))
        frames.append(instantaneous_xi(s_stms, d_stms)[0].cpu().numpy())
    xi_map.fit(np.vstack(frames))
    return xi_map


NETWORKS = {
    "ResNet": ResNet,
    "ResNetV2": ResNetV2,
    "ResNetV3": ResNetV3,
    "MHANet": MHANet,
    "MHANetV2": lambda **kw: MHANet(v2=True, **kw),
    "MHANetV3": lambda **kw: MHANet(learned_pos=True, **kw),
    "ResLSTM": ResLSTM,
    "ResBiLSTM": lambda **kw: ResLSTM(bidirectional=True, **kw),
    "RDLNet": RDLNet,
}


class DeepXi(nn.Module):
    """The network of `network` (a NETWORKS name) as the submodule `net`:
    (B, T, n_feat) STMS -> (B, T, n_feat) mapped xi. `network_kwargs`
    carries the reference's network flags (d_model, n_blocks, d_f, k,
    max_d_rate, unit_type, outp_act, ...: ref args_resnet.py:103-122) as
    (name, value) pairs. Weights are drawn from `generator` (seed 0 when
    None) with torch's init (MHANetV3's positions N(0, 0.02) as flax's);
    `device=None` means the card. `enhance` is the waveform pipeline."""

    def __init__(self, network: str = "ResNetV2", n_feat: int = 257,
                 network_kwargs: tuple = (), *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if network not in NETWORKS:
            raise ValueError(f"unknown network {network!r}")
        self.network = network
        self.net = NETWORKS[network](n_feat=n_feat, n_outp=n_feat,
                                     **dict(network_kwargs))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, (Conv1d, LSTM)):
                    mod.reset_parameters(generator)
            pos = getattr(self.net, "pos_embedding", None)
            if pos is not None:
                pos.normal_(0.0, 0.02, generator=generator)
        self.to(resolve_device(device)).eval()

    def forward(self, x_stms: torch.Tensor) -> torch.Tensor:
        return self.net(x_stms)


@torch.no_grad()
def enhance(model: DeepXi, wav, xi_map: XiMap, gain: str = "mmse-lsa",
            length: int | None = None) -> torch.Tensor:
    """(B, n) noisy waveform (numpy or tensor) -> the enhanced waveform, a
    tensor on the model's device, where the whole pipeline runs (ref
    deepxi/model.py:232-340, inp_tgt.py:194-210): STMS and STPS, the
    network's mapped xi, xi_hat = the map's inverse, the gain
    `gfunc(xi_hat, xi_hat + 1, gain)` on the noisy magnitude, the noisy
    phase, the inverse STFT. No RMS gain (se_tpu's enhance has none)."""
    dev = next(model.parameters()).device
    wav = torch.as_tensor(wav, dtype=torch.float32).to(dev)
    x_stms, x_stps = polar_analysis(wav)
    xi_hat = xi_map.inverse(model(x_stms))
    y_stms = x_stms * gfunc(xi_hat, xi_hat + 1.0, gain)
    return polar_synthesis(y_stms, x_stps, length=length)


def from_jax_variables(variables: dict) -> dict:
    """se_tpu's DeepXi {"params": {"net": ...}} tree (numpy) -> this port's
    state_dict, by the layer kinds the tree holds: a `kernel` is a dense
    layer or a 1-D conv, `_wx` / `_wh` / `_b` an LSTM, a `scale` and / or
    `bias` alone a LayerNorm, a bare array the positional embedding."""
    sd: dict = {}
    for name, node in variables["params"]["net"].items():
        prefix = f"net.{name}"
        if not isinstance(node, dict):
            sd[prefix] = jt.tensor(node)
        elif "kernel" in node:
            jt.put_conv1d(sd, prefix, node)
        elif any(key.endswith("_wx") for key in node):
            jt.put_lstm(sd, prefix, node)
        else:
            jt.put_flax_layernorm(sd, prefix, node)
    return sd


register(
    ModelEntry(
        name="deepxi",
        make=DeepXi,
        stft=PRESET_DEEPXI,
        io_kind="hybrid",
        from_jax_variables=from_jax_variables,
        variants=("resnet", "reslstm"),
    )
)
