"""FullSubNet, full-band and sub-band fusion with a cIRM output: the port of
se_tpu/models/fullsubnet.py.

A full-band 2-layer LSTM(512) over the 257-bin magnitude, a per-bin unfold
into 31-wide sub-band units (reflect pad and shifted slices), concat with
the full-band output, a sub-band 2-layer LSTM(384) on the (B*F, T, 32)
fold, and a 2-channel cIRM. Look-ahead of 2 frames by pad and slice. All
four LSTM layers run `nn.recurrent.lstm_layer`: the CUDA kernel on the
card, its plain twin on the CPU. In train mode (`model.train()`) at a
global batch above 1 (under an active mesh: this rank's rows of it, each
grouped by its global index) the sub-band input goes through `drop_band`,
the training-time frequency
subsampling, as se_tpu's `train=True` (se_tpu/models/fullsubnet.py:116-117):
the mask then covers F // 2 bins of a regrouped batch, and the trainer
regroups its features and labels the same way.

Module names follow the reference state_dict (`fb_model.sequence_model.*`,
`fb_model.fc_output_layer.*`, the same under `sb_model`), so
`se_tpu.models.fullsubnet.from_reference_state_dict(model.state_dict())`
loads the same weights into JAX, and `from_jax_variables` goes the other
way. Layout (B, T, F).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from se_tpu_torch.device import resolve_device
from se_tpu_torch.models import jax_tree as jt
from se_tpu_torch.models.registry import ModelEntry, register
from se_tpu_torch.nn import LSTM, Linear
from se_tpu_torch.ops.stft import PRESET_512_256
from se_tpu_torch.parallel.mesh import data_size, row_offset

EPS = float(np.finfo(np.float32).eps)


class SequenceModel(nn.Module):
    """LSTM stack -> Linear -> optional activation."""

    def __init__(self, input_size: int, output_size: int, hidden: int,
                 num_layers: int = 2, activation: str | None = None):
        super().__init__()
        self.sequence_model = LSTM(input_size, hidden, num_layers)
        self.fc_output_layer = Linear(hidden, output_size)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.fc_output_layer(self.sequence_model(x))
        if self.activation == "ReLU":
            return torch.relu(x)
        if self.activation == "Tanh":
            return torch.tanh(x)
        return x


def offline_laplace_norm(x: torch.Tensor) -> torch.Tensor:
    """x / (mean over all non-batch dims + 1e-5)."""
    mu = x.mean(dim=tuple(range(1, x.ndim)), keepdim=True)
    return x / (mu + 1e-5)


def cumulative_laplace_norm(x: torch.Tensor) -> torch.Tensor:
    """(B, T, F): divide by the causal running mean over (t, f)."""
    t_len, f = x.shape[1], x.shape[-1]
    cum = torch.cumsum(x.sum(dim=-1), dim=-1)  # (B, T)
    cnt = torch.arange(1, t_len + 1, dtype=x.dtype, device=x.device) * f
    return x / ((cum / cnt)[..., None] + EPS)


def unfold_subband(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, T, F) -> (B, T, F, 2n+1) sub-band units: reflect pad (the edge
    not repeated) and 2n+1 shifted slices."""
    if n < 1:
        return x[..., None]
    f = x.shape[-1]
    xp = F.pad(x, (n, n), mode="reflect")
    return torch.stack([xp[..., i:i + f] for i in range(2 * n + 1)], dim=-1)


def drop_band(x: torch.Tensor, num_groups: int = 2,
              offset: int = 0) -> torch.Tensor:
    """Training-only frequency subsampling: (B, T, F, C) -> (B', T,
    F // num_groups, C), group g taking the samples whose global index
    (`offset` + row: `offset` a shard's first global row) is g mod G, and
    freqs g::G. The rows come group by group, as `group_rows` orders
    them."""
    if num_groups <= 1:
        return x
    f = x.shape[2] - x.shape[2] % num_groups
    x = x[:, :, :f]
    return torch.cat([x[(g - offset) % num_groups::num_groups, :,
                        g::num_groups]
                      for g in range(num_groups)], dim=0)


def group_rows(x: torch.Tensor, num_groups: int,
               offset: int = 0) -> torch.Tensor:
    """`x`'s rows in drop_band's order: group by group (the frame counts
    that go with drop_band's output)."""
    return torch.cat([x[(g - offset) % num_groups::num_groups]
                      for g in range(num_groups)])


class FullSubNet(nn.Module):
    """(B, T, F) noisy magnitude -> (B, T, F, 2) cIRM. Weights are drawn
    from `generator` (seed 0 when None) with torch's LSTM and Linear init;
    `device=None` means the card."""

    num_groups_in_drop_band = 2

    def __init__(self, num_freqs: int = 257, look_ahead: int = 2,
                 fb_num_neighbors: int = 0, sb_num_neighbors: int = 15,
                 fb_hidden: int = 512, sb_hidden: int = 384, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.num_freqs, self.look_ahead = num_freqs, look_ahead
        self.fb_num_neighbors = fb_num_neighbors
        self.sb_num_neighbors = sb_num_neighbors
        self.fb_model = SequenceModel(num_freqs, num_freqs, fb_hidden,
                                      activation="ReLU")
        sb_in = 2 * sb_num_neighbors + 1 + 2 * fb_num_neighbors + 1
        self.sb_model = SequenceModel(sb_in, 2, sb_hidden)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for mod in self.modules():
            if isinstance(mod, (LSTM, Linear)):
                mod.reset_parameters(generator)
        self.to(resolve_device(device)).eval()  # eval until train()

    def forward(self, noisy_mag: torch.Tensor) -> torch.Tensor:
        b, _, f = noisy_mag.shape
        mag = F.pad(noisy_mag, (0, 0, 0, self.look_ahead))
        t_len = mag.shape[1]
        fb_out = self.fb_model(offline_laplace_norm(mag))
        sb_in = offline_laplace_norm(torch.cat(
            [unfold_subband(mag, self.sb_num_neighbors),
             unfold_subband(fb_out, self.fb_num_neighbors)], dim=-1))
        if self.training and b * data_size() > 1:  # the global batch's
            sb_in = drop_band(sb_in, self.num_groups_in_drop_band,
                              row_offset(b))
            b, f = sb_in.shape[0], sb_in.shape[2]
        folded = sb_in.transpose(1, 2).reshape(b * f, t_len, sb_in.shape[-1])
        del sb_in, fb_out  # the fold is the large tensor from here on
        mask = self.sb_model(folded).reshape(b, f, t_len, 2).transpose(1, 2)
        return mask[:, self.look_ahead:]


def from_jax_variables(variables: dict) -> dict:
    """se_tpu's FullSubNet {"params"} tree (numpy or jax arrays) -> this
    port's state_dict. se_tpu keeps one combined LSTM bias: it becomes
    `bias_ih`, and `bias_hh` is zero."""
    prm = variables["params"]
    sd: dict = {}
    for name in ("fb_model", "sb_model"):
        jt.put_lstm(sd, f"{name}.sequence_model", prm[name]["lstm"])
        jt.put_dense(sd, f"{name}.fc_output_layer", prm[name]["fc"])
    return sd


register(
    ModelEntry(
        name="fullsubnet",
        make=FullSubNet,
        stft=PRESET_512_256,
        io_kind="cirm",
        from_jax_variables=from_jax_variables,
        bf16=True,
    )
)
