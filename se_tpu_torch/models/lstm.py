"""LSTMNet, the LSTM magnitude-mapping baseline: the port of
se_tpu/models/lstm.py.

(B, T, F = 161) noisy magnitude -> feature BatchNorm over the bins ->
LSTM(161 -> 1024) -> 2-layer LSTM(1024) -> Linear(161) + softplus: the
estimated magnitude (the decode reuses the noisy phase). The three LSTM
layers run `nn.recurrent.lstm_layer`: the CUDA kernel on the card.

Module names follow the reference state_dict (`bn`, `lstm1`, `lstm2`,
`fc.0`), so `se_tpu.models.lstm.from_reference_state_dict(
model.state_dict())` loads the same weights into JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from se_tpu_torch.device import resolve_device
from se_tpu_torch.models import jax_tree as jt
from se_tpu_torch.models.registry import ModelEntry, register
from se_tpu_torch.nn import LSTM, BatchNorm, Linear
from se_tpu_torch.nn.recurrent import lstm_split
from se_tpu_torch.ops.stft import PRESET_320


class LSTMNet(nn.Module):
    """Weights are drawn from `generator` (seed 0 when None) with torch's
    init; `device=None` means the card."""

    # frames of left context a streamed chunk replays: none, the LSTMs'
    # carry is the whole memory
    replay_frames = 0

    def __init__(self, bins: int = 161, hidden: int = 1024, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.bn = BatchNorm(bins)
        self.lstm1 = LSTM(bins, hidden)
        self.lstm2 = LSTM(hidden, hidden, num_layers=2)
        self.fc = nn.Sequential(Linear(hidden, bins))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for mod in self.modules():
            if isinstance(mod, (LSTM, Linear)):
                mod.reset_parameters(generator)
        self.to(resolve_device(device)).eval()  # eval until train()

    def forward(self, mag: torch.Tensor, carry=None, split=None):
        """`carry`: three per-layer (h, c) for exact streaming decode;
        `split` checkpoints the carried state after that many frames
        (`nn.recurrent.lstm_split`). Returns (out, new_carry) when a carry
        is given."""
        x = self.bn(mag)
        if carry is None:
            return F.softplus(self.fc(self.lstm2(self.lstm1(x))))
        split = x.shape[1] if split is None else split
        x, c1 = lstm_split(self.lstm1, x, carry[:1], split)
        x, c2 = lstm_split(self.lstm2, x, carry[1:], split)
        return F.softplus(self.fc(x)), c1 + c2

    def zero_carry(self, batch: int, device=None):
        """Zero (h, c) of the three layers on `device` (None means the
        card)."""
        return LSTM.zero_carry(batch, self.lstm1.hidden_size, 3, device)


def from_jax_variables(variables: dict) -> dict:
    """se_tpu's LSTMNet {"params", "batch_stats"} tree -> this port's
    state_dict."""
    prm = variables["params"]
    sd: dict = {}
    jt.put_batchnorm(sd, "bn", prm["bn"], variables["batch_stats"]["bn"])
    jt.put_lstm(sd, "lstm1", prm["lstm1"])
    jt.put_lstm(sd, "lstm2", prm["lstm2"])
    jt.put_dense(sd, "fc.0", prm["fc"])
    return sd


register(
    ModelEntry(
        name="lstm",
        make=LSTMNet,
        stft=PRESET_320,
        io_kind="mag_mask",
        from_jax_variables=from_jax_variables,
        bf16=True,
    )
)
