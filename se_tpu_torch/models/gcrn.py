"""GCRN, the gated conv-recurrent complex spectral mapping net: the port of
se_tpu/models/gcrn.py.

(B, T, F = 161, 2) noisy (re, im) -> 5 GLU convs (2 -> 16 -> ... -> 256
channels, kernel (1, 3), stride 2 over F: 161 -> 4) with BN and ELU -> the
grouped GLSTM (2 groups x 2 stages of single-layer LSTMs, an interleaving
shuffle after stage 1, LayerNorms) -> two GLU deconv decoders, one for the
real and one for the imaginary part, each ending in Linear(161 -> 161) over
frequency. Every LSTM layer runs `nn.recurrent.lstm_layer`: the CUDA kernel
on the card. With a carry (the GLSTM's four single-layer LSTM carries,
`zero_carry`) and `split` the forward continues a stream:
`eval.streaming.CausalStreamer` (every conv has time kernel 1, so a chunk
replays nothing).

Module names follow the reference state_dict (`conv{1..5}.conv{1,2}`,
`bn{1..5}`, `glstm.{ln1,ln2,lstm_list1.{i},lstm_list2.{i}}`,
`conv{5..1}_t_{1,2}.conv{1,2}`, `bn{5..1}_t_{1,2}`, `fc{1,2}`), with conv
weights (O, I, kt, kf).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from se_tpu_torch.device import resolve_device
from se_tpu_torch.models import jax_tree as jt
from se_tpu_torch.models.registry import ModelEntry, register
from se_tpu_torch.nn import (
    LSTM, BatchNorm, ConvParams, GluConv2d, GluConvTranspose2d, LayerNorm,
    Linear,
)
from se_tpu_torch.nn.recurrent import lstm_split
from se_tpu_torch.ops.stft import PRESET_320

_EN_CH = (16, 32, 64, 128, 256)
_DE_CH = (128, 64, 32, 16, 1)


class GLSTM(nn.Module):
    """Grouped LSTM on (B, T, F, C), its per-step features in torch's (C
    outer, F inner) order."""

    def __init__(self, hidden: int = 1024, groups: int = 2):
        super().__init__()
        self.hidden, self.groups = hidden, groups
        h = hidden // groups
        self.lstm_list1 = nn.ModuleList(LSTM(h, h) for _ in range(groups))
        self.lstm_list2 = nn.ModuleList(LSTM(h, h) for _ in range(groups))
        self.ln1 = LayerNorm(hidden)
        self.ln2 = LayerNorm(hidden)

    def forward(self, x: torch.Tensor, carry=None, split=None):
        """`carry`: [stage 1 x groups, stage 2 x groups] single-layer LSTM
        carries for exact streaming; `split` checkpoints them after that
        many frames. Returns (out, new_carry) when a carry is given."""
        b, t, f, c = x.shape
        out = x.transpose(2, 3).reshape(b, t, c * f)
        new_carry = []

        def run(lstms, h, stage):
            zs = h.chunk(self.groups, dim=-1)
            if carry is None:
                return [lstm(z) for lstm, z in zip(lstms, zs)]
            ys = []
            for g, (lstm, z) in enumerate(zip(lstms, zs)):
                y, nc = lstm_split(lstm, z, carry[stage * self.groups + g],
                                   t if split is None else split)
                ys.append(y)
                new_carry.append(nc)
            return ys

        ys = run(self.lstm_list1, out, 0)
        # torch's stack(dim=-1) then flatten: the groups' outputs interleave
        out = self.ln1(torch.stack(ys, dim=-1).reshape(b, t, self.hidden))
        out = self.ln2(torch.cat(run(self.lstm_list2, out, 1), dim=-1))
        out = out.reshape(b, t, c, f).transpose(2, 3)
        return out if carry is None else (out, new_carry)


class GCRN(nn.Module):
    """Weights are drawn from `generator` (seed 0 when None) with torch's
    init; `device=None` means the card."""

    # every conv has time kernel 1: streaming needs no conv replay at all
    replay_frames = 0

    def __init__(self, *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        ins = (2,) + _EN_CH[:-1]
        for i, (cin, ch) in enumerate(zip(ins, _EN_CH)):
            setattr(self, f"conv{i + 1}",
                    GluConv2d(cin, ch, (1, 3), stride=(1, 2)))
            setattr(self, f"bn{i + 1}", BatchNorm(ch))
        self.glstm = GLSTM()
        de_in = (256,) + _DE_CH[:-1]
        for tag in ("1", "2"):
            for i, (cin, ch) in enumerate(zip(de_in, _DE_CH)):
                opad = (0, 1) if i == 3 else (0, 0)
                setattr(self, f"conv{5 - i}_t_{tag}", GluConvTranspose2d(
                    2 * cin, ch, (1, 3), stride=(1, 2), output_padding=opad))
                setattr(self, f"bn{5 - i}_t_{tag}", BatchNorm(ch))
            setattr(self, f"fc{tag}", Linear(161, 161))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for mod in self.modules():
            if isinstance(mod, (ConvParams, LSTM, Linear)):
                mod.reset_parameters(generator)
        self.to(resolve_device(device)).eval()  # eval until train()

    def _decoder(self, out: torch.Tensor, skips, tag: str) -> torch.Tensor:
        d = out
        for i in range(5):
            d = getattr(self, f"conv{5 - i}_t_{tag}")(d)
            d = getattr(self, f"bn{5 - i}_t_{tag}")(d)
            if i < 4:
                d = torch.cat([d, skips[3 - i]], dim=-1)
            d = F.elu(d)
        return getattr(self, f"fc{tag}")(d[..., 0])  # Linear over frequency

    def forward(self, x: torch.Tensor, carry=None, split=None):
        """`carry`: the GLSTM's four single-layer LSTM carries for exact
        streaming decode; returns (out, new_carry) when given."""
        skips = []
        for i in range(1, 6):
            x = F.elu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
            skips.append(x)
        if carry is None:
            out = self.glstm(x)
        else:
            out, carry = self.glstm(x, carry, split)
        out = torch.cat([out, skips[4]], dim=-1)
        est = torch.stack([self._decoder(out, skips, "1"),
                           self._decoder(out, skips, "2")], dim=-1)
        return est if carry is None else (est, carry)

    def zero_carry(self, batch: int, device=None):
        """One zero single-layer LSTM carry (a list of one (h, c)) per
        group and stage, [stage 1 g0, stage 1 g1, stage 2 g0, stage 2 g1],
        on `device` (None means the card)."""
        g = self.glstm
        return [LSTM.zero_carry(batch, g.hidden // g.groups, 1, device)
                for _ in range(2 * g.groups)]


def from_jax_variables(variables: dict) -> dict:
    """se_tpu's GCRN {"params", "batch_stats"} tree -> this port's
    state_dict."""
    prm, stats = variables["params"], variables["batch_stats"]
    sd: dict = {}

    def glu(prefix, tree, transpose=False):
        for part in ("conv1", "conv2"):
            jt.put_conv(sd, f"{prefix}.{part}", tree[part], transpose)

    for i in range(5):
        glu(f"conv{i + 1}", prm[f"conv{i}"])
        jt.put_batchnorm(sd, f"bn{i + 1}", prm[f"bn{i}"], stats[f"bn{i}"])
    g = prm["glstm"]
    jt.put_layernorm(sd, "glstm.ln1", g["ln1"])
    jt.put_layernorm(sd, "glstm.ln2", g["ln2"])
    for i in range(2):
        jt.put_lstm(sd, f"glstm.lstm_list1.{i}", g[f"lstm1_{i}"])
        jt.put_lstm(sd, f"glstm.lstm_list2.{i}", g[f"lstm2_{i}"])
    for tag in ("1", "2"):
        for i in range(5):
            glu(f"conv{5 - i}_t_{tag}", prm[f"convt{i}_{tag}"], transpose=True)
            jt.put_batchnorm(sd, f"bn{5 - i}_t_{tag}", prm[f"bnt{i}_{tag}"],
                             stats[f"bnt{i}_{tag}"])
        jt.put_dense(sd, f"fc{tag}", prm[f"fc_{tag}"])
    return sd


register(
    ModelEntry(
        name="gcrn",
        make=GCRN,
        stft=PRESET_320,
        io_kind="complex_map",
        from_jax_variables=from_jax_variables,
        bf16=True,
    )
)
