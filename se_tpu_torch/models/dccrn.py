"""DCCRN, deep complex conv-recurrent net with phase-aware masking: the port
of se_tpu/models/dccrn.py.

(B, T, F = 257, 2) noisy (re, im) -> (B, T, F, 2) enhanced. The DC bin is
stripped at the input and its mask re-padded with zeros; a complex conv
encoder (stride 2 over F, causal time pad), a complex LSTM stack (re and im
stacked on the batch, `use_clstm`) or a real 2-layer LSTM + Linear, and a
complex transposed-conv decoder with concat skips and the reference's
asymmetric time crop: `[:, 1:]`, or `[:, :-1]` for DCCRN_SNR
(`snr_variant`). Masking mode E (tanh magnitude, phase rotation), C
(complex multiply) or R (per-part multiply). Every LSTM layer runs
`nn.recurrent.lstm_layer`: the CUDA kernel on the card.

Module names follow the reference state_dict that
`se_tpu.models.dccrn.from_reference_state_dict` reads (`encoder.{i}.{0,1,2}`,
`decoder.{i}.{0,1,2}`, `enhance.{k}.{real_lstm,imag_lstm,r_trans,i_trans}`;
the non-clstm branch `enhance` and `tranform`), with conv weights in the
reference's (O, I, kf, kt) layout. Layout (B, T, F, C), complex channels
as [real-half | imag-half].
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from se_tpu_torch.device import resolve_device
from se_tpu_torch.models import jax_tree as jt
from se_tpu_torch.models.registry import ModelEntry, register
from se_tpu_torch.nn import (
    LSTM, BatchNorm, ComplexConv2d, ComplexConvTranspose2d, ConvParams,
    Linear, NaiveComplexLSTM, PReLU,
)
from se_tpu_torch.nn.complex_ops import (
    complex_cat, merge_complex, split_complex,
)
from se_tpu_torch.ops.stft import PRESET_512_128


class DCCRN(nn.Module):
    """Weights are drawn from `generator` (seed 0 when None) with torch's
    init; BN and PReLU start at torch's defaults. `device=None` means the
    card."""

    def __init__(self, rnn_layers: int = 2, rnn_units: int = 256,
                 fft_len: int = 512, masking_mode: str = "E",
                 use_clstm: bool = True, kernel_size: int = 5,
                 kernel_num: Sequence[int] = (32, 64, 128, 256, 256, 256),
                 snr_variant: bool = False, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if masking_mode not in ("E", "C", "R"):
            raise ValueError(f"unknown masking mode {masking_mode!r}")
        self.masking_mode, self.use_clstm = masking_mode, use_clstm
        self.snr_variant = snr_variant
        kn = (2,) + tuple(kernel_num)
        n = len(kn) - 1
        kernel = (2, kernel_size)
        self.encoder = nn.ModuleList(nn.Sequential(
            ComplexConv2d(kn[i], kn[i + 1], kernel, stride=(1, 2),
                          padding=((1, 0), (2, 2))),
            BatchNorm(kn[i + 1]), PReLU()) for i in range(n))

        dims = fft_len // 2 >> n  # frequency bins at the bottleneck
        channels = kn[-1]
        half = channels // 2
        if use_clstm:
            layers = []
            for k in range(rnn_layers):
                in_dim = half * dims if k == 0 else rnn_units // 2
                proj = half * dims * 2 if k == rnn_layers - 1 else None
                layers.append(NaiveComplexLSTM(in_dim, rnn_units, proj))
            self.enhance = nn.ModuleList(layers)
        else:
            self.enhance = LSTM(channels * dims, rnn_units, num_layers=2)
            self.tranform = Linear(rnn_units, channels * dims)

        decoder = []
        for i in range(n):
            idx = n - i
            stage = [ComplexConvTranspose2d(
                2 * kn[idx], kn[idx - 1], kernel, stride=(1, 2),
                padding=(0, 2), output_padding=(0, 1))]
            if idx != 1:
                stage += [BatchNorm(kn[idx - 1]), PReLU()]
            decoder.append(nn.Sequential(*stage))
        self.decoder = nn.ModuleList(decoder)

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for mod in self.modules():
            if isinstance(mod, (ConvParams, LSTM, Linear)):
                mod.reset_parameters(generator)
        self.to(resolve_device(device)).eval()  # eval until train()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_re, in_im = x[..., 0], x[..., 1]
        spec_mag = torch.sqrt(in_re ** 2 + in_im ** 2)
        spec_phase = torch.atan2(in_im, in_re)
        out = x[:, :, 1:]  # DC bin stripped; channels [re | im]

        skips = []
        for stage in self.encoder:
            out = stage(out)
            skips.append(out)

        b, t, dims, channels = out.shape
        half = channels // 2
        if self.use_clstm:
            # real/imag halves flattened as torch's (C/2 outer, D inner)
            re, im = (p.transpose(2, 3).reshape(b, t, half * dims)
                      for p in split_complex(out))
            for layer in self.enhance:
                re, im = layer(re, im)
            re, im = (p.reshape(b, t, half, dims).transpose(2, 3)
                      for p in (re, im))
            out = merge_complex(re, im)
        else:
            h = out.transpose(2, 3).reshape(b, t, channels * dims)
            h = self.tranform(self.enhance(h))
            out = h.reshape(b, t, channels, dims).transpose(2, 3)

        for i, stage in enumerate(self.decoder):
            out = complex_cat([out, skips[-1 - i]])
            out = stage[0](out)
            out = out[:, :-1] if self.snr_variant else out[:, 1:]
            for mod in stage[1:]:
                out = mod(out)

        mask_re = F.pad(out[..., 0], (1, 0))
        mask_im = F.pad(out[..., 1], (1, 0))
        if self.masking_mode == "E":
            mask_mag = torch.sqrt(mask_re ** 2 + mask_im ** 2)
            real_phase = mask_re / (mask_mag + 1e-8)
            imag_phase = mask_im / (mask_mag + 1e-8)
            mask_phase = torch.atan2(imag_phase, real_phase)
            est_mag = torch.tanh(mask_mag) * spec_mag
            est_phase = spec_phase + mask_phase
            real = est_mag * torch.cos(est_phase)
            imag = est_mag * torch.sin(est_phase)
        elif self.masking_mode == "C":
            real = in_re * mask_re - in_im * mask_im
            imag = in_re * mask_im + in_im * mask_re
        else:
            real = in_re * mask_re
            imag = in_im * mask_im
        return torch.stack([real, imag], dim=-1)


def _put_complex_conv(sd: dict, prefix: str, tree: dict,
                      transpose: bool = False) -> None:
    for part in ("real_conv", "imag_conv"):
        jt.put_conv(sd, f"{prefix}.{part}", tree[part], transpose,
                    freq_first=True)


def from_jax_variables(variables: dict) -> dict:
    """se_tpu's DCCRN {"params", "batch_stats"} tree -> this port's
    state_dict, for either `use_clstm`."""
    prm, stats = variables["params"], variables["batch_stats"]
    sd: dict = {}
    i = 0
    while f"en{i}" in prm:
        _put_complex_conv(sd, f"encoder.{i}.0", prm[f"en{i}"])
        jt.put_batchnorm(sd, f"encoder.{i}.1", prm[f"en_bn{i}"],
                         stats[f"en_bn{i}"])
        jt.put_prelu(sd, f"encoder.{i}.2", prm[f"en_act{i}"])
        _put_complex_conv(sd, f"decoder.{i}.0", prm[f"de{i}"], transpose=True)
        if f"de_bn{i}" in prm:
            jt.put_batchnorm(sd, f"decoder.{i}.1", prm[f"de_bn{i}"],
                             stats[f"de_bn{i}"])
            jt.put_prelu(sd, f"decoder.{i}.2", prm[f"de_act{i}"])
        i += 1
    k = 0
    while f"clstm{k}" in prm:
        blk = prm[f"clstm{k}"]
        for name in ("real_lstm", "imag_lstm"):
            jt.put_lstm(sd, f"enhance.{k}.{name}", blk[name])
        for name in ("r_trans", "i_trans"):
            if name in blk:
                jt.put_dense(sd, f"enhance.{k}.{name}", blk[name])
        k += 1
    if "enhance" in prm:
        jt.put_lstm(sd, "enhance", prm["enhance"])
        jt.put_dense(sd, "tranform", prm["tranform"])
    return sd


register(
    ModelEntry(
        name="dccrn",
        make=DCCRN,
        stft=PRESET_512_128,
        io_kind="complex_map",
        from_jax_variables=from_jax_variables,
        variants=("snr",),
        bf16=True,
    )
)
