"""CRN, the conv-recurrent magnitude-mapping net: the port of
se_tpu/models/crn.py.

(B, T, F = 161) noisy magnitude -> 5 causal strided convs (1 -> 16 -> ...
-> 256 channels, F 161 -> 4, time pad (1, 0)) with BN and ELU -> a 2-layer
LSTM(1024) on the bottleneck flattened as torch's (C = 256 outer, F = 4
inner) -> 5 transposed convs on concat skips, each cropped by one trailing
frame (Chomp_T), the fourth padded by one bin on the left (79 -> 80), BN,
ELU, softplus on the last: the estimated magnitude. The LSTM layers run
`nn.recurrent.lstm_layer`: the CUDA kernel on the card. With a carry (the
2-layer LSTM's, `zero_carry`) and `split` the forward continues a stream
with left-context replay: `eval.streaming.CausalStreamer`.

Module names follow the reference state_dict
(`en.en_module.{i}.{1,2}`, `de.de_module.{i}.{0,2}` and `.3` for the BN of
i = 3, `lstm`), with conv weights (O, I, kt, kf).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from se_tpu_torch.device import resolve_device
from se_tpu_torch.models import jax_tree as jt
from se_tpu_torch.models.registry import ModelEntry, register
from se_tpu_torch.nn import (
    LSTM, BatchNorm, Conv2d, ConvParams, ConvTranspose2d,
)
from se_tpu_torch.nn.recurrent import lstm_split
from se_tpu_torch.ops.stft import PRESET_320

_EN_CH = (16, 32, 64, 128, 256)
_DE_CH = (128, 64, 32, 16, 1)


def _bn_index(i: int) -> int:
    """Index of decoder level i's BN in the reference's Sequential: after
    the deconv and the chomp, and at i = 3 also the frequency pad (those
    hold no parameters and have no module here)."""
    return 3 if i == 3 else 2


class CRN(nn.Module):
    """Weights are drawn from `generator` (seed 0 when None) with torch's
    init; `device=None` means the card."""

    # frames of exact left-context replay for streaming: 5 causal encoder
    # convs (kt = 2) + 5 causal decoder deconvs (kt = 2 with Chomp_T)
    replay_frames = 10

    def __init__(self, *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        ins = (1,) + _EN_CH[:-1]
        self.en = nn.ModuleDict({"en_module": nn.ModuleList(
            nn.ModuleDict({"1": Conv2d(cin, ch, (2, 3), stride=(1, 2),
                                       padding=((1, 0), (0, 0))),
                           "2": BatchNorm(ch)})
            for cin, ch in zip(ins, _EN_CH))})
        self.lstm = LSTM(1024, 1024, num_layers=2)
        de_in = (256,) + _DE_CH[:-1]
        self.de = nn.ModuleDict({"de_module": nn.ModuleList(
            nn.ModuleDict({"0": ConvTranspose2d(2 * cin, ch, (2, 3),
                                                stride=(1, 2)),
                           str(_bn_index(i)): BatchNorm(ch)})
            for i, (cin, ch) in enumerate(zip(de_in, _DE_CH)))})
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for mod in self.modules():
            if isinstance(mod, (ConvParams, LSTM)):
                mod.reset_parameters(generator)
        self.to(resolve_device(device)).eval()  # eval until train()

    def forward(self, mag: torch.Tensor, carry=None, split=None):
        """`carry`: the 2-layer LSTM's state for exact streaming decode;
        `split` checkpoints it after that many frames (left-context
        replay). Returns (out, new_carry) when a carry is given."""
        x = mag[..., None]  # (B, T, F, 1)
        b, t = x.shape[:2]
        skips = []
        for blk in self.en.en_module:
            x = F.elu(blk["2"](blk["1"](x)))
            skips.append(x)

        h = x.transpose(2, 3).reshape(b, t, 1024)  # (C outer, F inner)
        if carry is None:
            h = self.lstm(h)
        else:
            h, carry = lstm_split(self.lstm, h, carry,
                                  t if split is None else split)
        x = h.reshape(b, t, 256, 4).transpose(2, 3)

        for i, blk in enumerate(self.de.de_module):
            x = torch.cat([x, skips[-(i + 1)]], dim=-1)
            x = blk["0"](x)[:, :-1]  # Chomp_T(1)
            if i == 3:  # one frequency bin on the left (79 -> 80)
                x = F.pad(x, (0, 0, 1, 0))
            x = blk[str(_bn_index(i))](x)
            x = F.elu(x) if i < 4 else F.softplus(x)
        return x[..., 0] if carry is None else (x[..., 0], carry)

    def zero_carry(self, batch: int, device=None):
        """Zero (h, c) of the 2-layer LSTM on `device` (None means the
        card)."""
        return LSTM.zero_carry(batch, 1024, 2, device)


def from_jax_variables(variables: dict) -> dict:
    """se_tpu's CRN {"params", "batch_stats"} tree -> this port's
    state_dict."""
    prm, stats = variables["params"], variables["batch_stats"]
    sd: dict = {}
    jt.put_lstm(sd, "lstm", prm["lstm"])
    for i in range(len(_EN_CH)):
        jt.put_conv(sd, f"en.en_module.{i}.1", prm[f"en{i}"])
        jt.put_batchnorm(sd, f"en.en_module.{i}.2", prm[f"en_bn{i}"],
                         stats[f"en_bn{i}"])
        jt.put_conv(sd, f"de.de_module.{i}.0", prm[f"de{i}"], transpose=True)
        jt.put_batchnorm(sd, f"de.de_module.{i}.{_bn_index(i)}",
                         prm[f"de_bn{i}"], stats[f"de_bn{i}"])
    return sd


register(
    ModelEntry(
        name="crn",
        make=CRN,
        stft=PRESET_320,
        io_kind="mag_mask",
        from_jax_variables=from_jax_variables,
        bf16=True,
    )
)
