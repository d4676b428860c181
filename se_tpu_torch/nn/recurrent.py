"""LSTM layers with torch's parameters: the port of se_tpu/nn/recurrent.py.

`lstm_layer` runs one direction of one layer through
`ops.lstm.lstm_layer_kernel`: the CUDA kernel on the card for every batch
size and with or without a carry, the plain twin on the CPU. `LSTM` is the
multi-layer, optionally bidirectional stack with torch.nn.LSTM's names and
shapes (`weight_ih_l{k}` (4H, In), `weight_hh_l{k}` (4H, H), `bias_ih_l{k}`,
`bias_hh_l{k}`, `_reverse` for the backward direction), so a reference
state_dict loads as it is and `se_tpu.utils.torch_compat.lstm` maps it to
se_tpu's tree. Like se_tpu's LSTM (one bias `l{k}_b`), it trains one
combined bias: `bias_ih` is the parameter and `bias_hh` a buffer, zero
unless a reference state_dict brings one, so an optimiser step moves the
sum `bias_ih + bias_hh` as far as se_tpu's step moves `l{k}_b`.
`lstm_split` runs a carried LSTM and checkpoints its state mid-sequence
(the streaming decode's left-context replay).

In a bf16 copy (`eval.enhance.bf16_model`) the weights, the buffers and
so the combined bias are bf16 (`bias_hh` zero: the sum is `bias_ih`, as
se_tpu's one `l{k}_b`); x may be fp32 or bf16, and y and the carry stay
fp32 (the kernels' bf16 variants, `ops/lstm.py`).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from se_tpu_torch.device import resolve_device
from se_tpu_torch.ops.lstm import lstm_layer_kernel


def lstm_layer(x: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor,
               b: torch.Tensor, reverse: bool = False, carry=None,
               return_carry: bool = False):
    """(B, T, In) -> (B, T, H); wx (In, 4H), wh (H, 4H), b (4H,) the
    combined bias. `carry=(h, c)` seeds the recurrence; `return_carry`
    returns `(out, (h, c))` as well."""
    h0, c0 = (None, None) if carry is None else carry
    ys, out_carry = lstm_layer_kernel(x.contiguous(), wx, wh, b, reverse,
                                      h0, c0)
    return (ys, out_carry) if return_carry else ys


class LSTM(nn.Module):
    """torch.nn.LSTM(batch_first=True) without dropout: input (B, T, In),
    output (B, T, H * directions), zero initial state unless `carry` is
    given. Differentiable through the output (the carry returned with
    `carry` carries no gradient on the card: `lstm_layer_kernel`)."""

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 1, bidirectional: bool = False):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.num_layers, self.bidirectional = num_layers, bidirectional
        h = hidden_size
        for layer in range(num_layers):
            in_dim = input_size if layer == 0 else h * self.directions
            for sfx in self._suffixes(layer):
                self.register_parameter(f"weight_ih_{sfx}",
                                        nn.Parameter(torch.zeros(4 * h, in_dim)))
                self.register_parameter(f"weight_hh_{sfx}",
                                        nn.Parameter(torch.zeros(4 * h, h)))
                self.register_parameter(f"bias_ih_{sfx}",
                                        nn.Parameter(torch.zeros(4 * h)))
                self.register_buffer(f"bias_hh_{sfx}", torch.zeros(4 * h))

    @property
    def directions(self) -> int:
        return 2 if self.bidirectional else 1

    def _suffixes(self, layer: int):
        return [f"l{layer}"] + ([f"l{layer}_reverse"] if self.bidirectional
                                else [])

    def reset_parameters(self, generator: torch.Generator) -> None:
        """torch's init: every parameter U(+-1/sqrt(H)); `bias_hh` stays
        zero (one bias, as se_tpu's)."""
        bound = 1.0 / math.sqrt(self.hidden_size)
        with torch.no_grad():
            for p in self.parameters():
                p.uniform_(-bound, bound, generator=generator)

    def layer_weights(self, sfx: str):
        """se_tpu's (wx (In, 4H), wh (H, 4H), b (4H,)) of one direction."""
        return (getattr(self, f"weight_ih_{sfx}").t().contiguous(),
                getattr(self, f"weight_hh_{sfx}").t().contiguous(),
                getattr(self, f"bias_ih_{sfx}") + getattr(self, f"bias_hh_{sfx}"))

    def forward(self, x: torch.Tensor, carry=None):
        """`carry`: a list of per-layer (h, c), uni-directional only; when
        given, returns (out, new_carry)."""
        if carry is not None and self.bidirectional:
            raise ValueError("carry is only supported uni-directionally")
        new_carry = []
        for layer in range(self.num_layers):
            outs = []
            for sfx in self._suffixes(layer):
                wx, wh, b = self.layer_weights(sfx)
                if carry is not None:
                    out, lc = lstm_layer(x, wx, wh, b, carry=carry[layer],
                                         return_carry=True)
                    new_carry.append(lc)
                else:
                    out = lstm_layer(x, wx, wh, b,
                                     reverse=sfx.endswith("_reverse"))
                outs.append(out)
            x = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
        return (x, new_carry) if carry is not None else x

    @staticmethod
    def zero_carry(batch: int, features: int, num_layers: int, device=None):
        """Zero (h, c) per layer on `device` (None means the card)."""
        dev = resolve_device(device)
        return [(torch.zeros(batch, features, device=dev),
                 torch.zeros(batch, features, device=dev))
                for _ in range(num_layers)]


def lstm_split(lstm: LSTM, h: torch.Tensor, carry, split: int):
    """Run `lstm` over h (B, T, D) from `carry`, checkpointing the state
    after `split` frames while still emitting every frame: -> (out,
    carry after `split` frames). `split <= 0` returns the input carry,
    `split >= T` the state after the last frame.

    Streaming decode with left-context replay (`eval.streaming`): a
    chunk's window replays R history frames whose outputs are recomputed
    from the checkpointed state; the state carried forward is the one at
    (window end - R), after the first `split` frames."""
    t = h.shape[1]
    if split >= t:
        return lstm(h, carry=carry)
    if split <= 0:
        out, _ = lstm(h, carry=carry)
        return out, carry
    o1, c_mid = lstm(h[:, :split], carry=carry)
    o2, _ = lstm(h[:, split:], carry=c_mid)
    return torch.cat([o1, o2], dim=1), c_mid
