"""DPCRN, the dual-path CRN with a complex ratio mask: the port of
se_tpu/models/dpcrn.py.

(B, T, F = 161, 2) noisy (re, im) -> 5 causal strided convs (2 -> 32 ->
32 -> 32 -> 64 -> 128 channels, F 161 -> 4) with BN and PReLU -> one DPRNN
block applied twice with shared weights -> 5 transposed convs on concat
skips with Chomp_T and the i = 3 frequency pad -> a 2-channel mask applied
to the input by complex multiply. DPRNN: an intra-frequency bidirectional
2-layer LSTM(64) on the (B*T, F, C) fold and an inter-time 2-layer
LSTM(128) on the (B*F, T, C) fold, each with a Linear, a LayerNorm over
(F, C) and a residual. Every LSTM layer runs `nn.recurrent.lstm_layer`:
the CUDA kernel on the card. With a carry (a (first pass, second pass) pair
of inter-LSTM states on the bottleneck fold B * F, `zero_carry`) and
`split` the forward continues a stream with left-context replay:
`eval.streaming.CausalStreamer`.

Module names follow the reference state_dict (`en.en_module.{i}.{1,2,3}`,
`dprnn.{intra_rnn,intra_fc,inter_rnn,inter_fc,ln1,ln2}`,
`de.de_module.{i}.{0,2,3}` and `.{0,3,4}` at i = 3), with conv weights
(O, I, kt, kf).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from se_tpu_torch.device import resolve_device
from se_tpu_torch.models import jax_tree as jt
from se_tpu_torch.models.registry import ModelEntry, register
from se_tpu_torch.nn import (
    LSTM, BatchNorm, Conv2d, ConvParams, ConvTranspose2d, LayerNorm, Linear,
    PReLU,
)
from se_tpu_torch.nn.recurrent import lstm_split
from se_tpu_torch.ops.stft import PRESET_320

_EN_CH = (32, 32, 32, 64, 128)
_DE_CH = (64, 32, 32, 32, 2)


def _bn_index(i: int) -> int:
    """Index of decoder level i's BN in the reference's Sequential: after
    the deconv and the chomp, and at i = 3 also the frequency pad (those
    hold no parameters and have no module here); the PReLU follows it."""
    return 3 if i == 3 else 2


class DPRNN(nn.Module):
    """Intra-frequency BiLSTM + inter-time LSTM with LayerNorm residuals on
    (B, T, F, C)."""

    def __init__(self, channels: int = 128, bottleneck_f: int = 4):
        super().__init__()
        c = channels
        self.intra_rnn = LSTM(c, c // 2, num_layers=2, bidirectional=True)
        self.intra_fc = Linear(c, c)
        self.ln1 = LayerNorm((bottleneck_f, c))
        self.inter_rnn = LSTM(c, c, num_layers=2)
        self.inter_fc = Linear(c, c)
        self.ln2 = LayerNorm((bottleneck_f, c))
        self.bottleneck_f = bottleneck_f

    def forward(self, x: torch.Tensor, carry=None, split=None):
        """`carry`: the 2-layer inter-LSTM's state (batch B * F) for exact
        streaming; the intra BiLSTM recurs over frequency and needs none.
        Returns (out, new_carry) when a carry is given."""
        b, t, f, c = x.shape
        h = self.intra_fc(self.intra_rnn(x.reshape(b * t, f, c)))
        intra = self.ln1(h.reshape(b, t, f, c)) + x
        h = intra.transpose(1, 2).reshape(b * f, t, c)
        if carry is None:
            h = self.inter_rnn(h)
        else:
            h, carry = lstm_split(self.inter_rnn, h, carry,
                                  t if split is None else split)
        h = self.inter_fc(h).reshape(b, f, t, c).transpose(1, 2)
        out = self.ln2(h) + intra
        return out if carry is None else (out, carry)


class DPCRN(nn.Module):
    """Weights are drawn from `generator` (seed 0 when None) with torch's
    init; `device=None` means the card."""

    # 5 causal encoder convs (kt = 2) + 5 causal decoder deconvs (Chomp_T)
    replay_frames = 10

    def __init__(self, *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        ins = (2,) + _EN_CH[:-1]
        self.en = nn.ModuleDict({"en_module": nn.ModuleList(
            nn.ModuleDict({"1": Conv2d(cin, ch, (2, 3), stride=(1, 2),
                                       padding=((1, 0), (0, 0))),
                           "2": BatchNorm(ch), "3": PReLU()})
            for cin, ch in zip(ins, _EN_CH))})
        self.dprnn = DPRNN()
        de_in = (128,) + _DE_CH[:-1]
        levels = []
        for i, (cin, ch) in enumerate(zip(de_in, _DE_CH)):
            level = {"0": ConvTranspose2d(2 * cin, ch, (2, 3), stride=(1, 2))}
            if i < 4:
                level[str(_bn_index(i))] = BatchNorm(ch)
                level[str(_bn_index(i) + 1)] = PReLU()
            levels.append(nn.ModuleDict(level))
        self.de = nn.ModuleDict({"de_module": nn.ModuleList(levels)})
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for mod in self.modules():
            if isinstance(mod, (ConvParams, LSTM, Linear)):
                mod.reset_parameters(generator)
        self.to(resolve_device(device)).eval()  # eval until train()

    def forward(self, x: torch.Tensor, carry=None, split=None):
        """`carry`: a (first pass, second pass) pair of inter-LSTM states
        (the block runs twice with shared weights, each pass with its own
        state) for exact streaming; returns (out, new_carry) when given."""
        inpt = x
        skips = []
        for blk in self.en.en_module:
            x = blk["3"](blk["2"](blk["1"](x)))
            skips.append(x)
        if carry is None:
            x = self.dprnn(self.dprnn(x))  # shared weights, applied twice
        else:
            x, nc1 = self.dprnn(x, carry[0], split)
            x, nc2 = self.dprnn(x, carry[1], split)
            carry = (nc1, nc2)
        for i, blk in enumerate(self.de.de_module):
            x = torch.cat([x, skips[-(i + 1)]], dim=-1)
            x = blk["0"](x)[:, :-1]  # Chomp_T(1)
            if i == 3:  # one frequency bin on the left (79 -> 80)
                x = F.pad(x, (0, 0, 1, 0))
            if i < 4:
                k = _bn_index(i)
                x = blk[str(k + 1)](blk[str(k)](x))
        mask_r, mask_i = x[..., 0], x[..., 1]
        in_r, in_i = inpt[..., 0], inpt[..., 1]
        est = torch.stack([in_r * mask_r - in_i * mask_i,
                           in_r * mask_i + in_i * mask_r], dim=-1)
        return est if carry is None else (est, carry)

    def zero_carry(self, batch: int, device=None):
        """Two zero 2-layer inter-LSTM states (one a pass) on the
        bottleneck fold B * F, on `device` (None means the card)."""
        d = self.dprnn
        return tuple(LSTM.zero_carry(batch * d.bottleneck_f,
                                     d.inter_rnn.hidden_size, 2, device)
                     for _ in range(2))


def from_jax_variables(variables: dict) -> dict:
    """se_tpu's DPCRN {"params", "batch_stats"} tree -> this port's
    state_dict."""
    prm, stats = variables["params"], variables["batch_stats"]
    sd: dict = {}
    for i in range(5):
        jt.put_conv(sd, f"en.en_module.{i}.1", prm[f"en{i}"])
        jt.put_batchnorm(sd, f"en.en_module.{i}.2", prm[f"en_bn{i}"],
                         stats[f"en_bn{i}"])
        jt.put_prelu(sd, f"en.en_module.{i}.3", prm[f"en_act{i}"])
        jt.put_conv(sd, f"de.de_module.{i}.0", prm[f"de{i}"], transpose=True)
        if i < 4:
            k = _bn_index(i)
            jt.put_batchnorm(sd, f"de.de_module.{i}.{k}", prm[f"de_bn{i}"],
                             stats[f"de_bn{i}"])
            jt.put_prelu(sd, f"de.de_module.{i}.{k + 1}", prm[f"de_act{i}"])
    d = prm["dprnn"]
    jt.put_lstm(sd, "dprnn.intra_rnn", d["intra_rnn"])
    jt.put_dense(sd, "dprnn.intra_fc", d["intra_fc"])
    jt.put_lstm(sd, "dprnn.inter_rnn", d["inter_rnn"])
    jt.put_dense(sd, "dprnn.inter_fc", d["inter_fc"])
    jt.put_layernorm(sd, "dprnn.ln1", d["ln1"])
    jt.put_layernorm(sd, "dprnn.ln2", d["ln2"])
    return sd


register(
    ModelEntry(
        name="dpcrn",
        make=DPCRN,
        stft=PRESET_320,
        io_kind="complex_mask",
        from_jax_variables=from_jax_variables,
        bf16=True,
    )
)
