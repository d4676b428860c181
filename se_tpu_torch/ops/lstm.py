"""One single-direction LSTM layer over a whole sequence: the port of
se_tpu/ops/pallas_lstm.py (`pallas_lstm_layer`, kernel `_lstm_kernel`,
plain math `_scan_forward`).

x (Bf, T, In) -> y (Bf, T, H) with torch's gate order (i, f, g, o):
wx (In, 4H), wh (H, 4H), b (4H,) the combined bias, h and c in fp32. On a
CUDA tensor `lstm_layer_kernel` launches csrc/lstm.cu (one step kernel a
frame, enqueued by one C call; the input projection inside the kernel),
for any Bf, either direction and any initial carry; on a CPU tensor it
runs `_reference`, the plain twin: the projection as one matmul, then a
step loop.
"""

from __future__ import annotations

import torch

from se_tpu_torch.ops import _build


def _reference(x, wx, wh, b, reverse: bool = False, h0=None, c0=None):
    bf, t_len, _ = x.shape
    h_dim = wh.shape[0]
    xp = torch.matmul(x, wx) + b  # (Bf, T, 4H)
    h = x.new_zeros(bf, h_dim) if h0 is None else h0
    c = x.new_zeros(bf, h_dim) if c0 is None else c0
    ys = x.new_empty(bf, t_len, h_dim)
    for t in (range(t_len - 1, -1, -1) if reverse else range(t_len)):
        i, f, g, o = (xp[:, t] + torch.matmul(h, wh)).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys[:, t] = h
    return ys, (h, c)


def lstm_layer_kernel(x: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor,
                      b: torch.Tensor, reverse: bool = False, h0=None,
                      c0=None):
    """-> (ys (Bf, T, H), (h_T, c_T)), h_T/c_T after the last frame walked
    (frame 0 when `reverse`). h0/c0 (Bf, H) default to zeros."""
    if x.device.type == "cpu":
        return _reference(x, wx, wh, b, reverse, h0, c0)
    bf, t_len, in_dim = x.shape
    h_dim = wh.shape[0]
    if bf == 0:
        raise ValueError("lstm kernel: empty batch")
    _build.check(x, (bf, t_len, in_dim), "x")
    _build.check(wx, (in_dim, 4 * h_dim), "wx")
    _build.check(wh, (h_dim, 4 * h_dim), "wh")
    _build.check(b, (4 * h_dim,), "b")
    hbuf = x.new_zeros(2, bf, h_dim)
    if h0 is not None:
        _build.check(h0, (bf, h_dim), "h0")
        hbuf[0].copy_(h0)
    if c0 is not None:
        _build.check(c0, (bf, h_dim), "c0")
        c = c0.clone()
    else:
        c = x.new_zeros(bf, h_dim)
    ys = x.new_empty(bf, t_len, h_dim)
    _build.launch("se_lstm_layer", x, wx, wh, b, hbuf, c, ys, bf, t_len,
                  in_dim, h_dim, bool(reverse))
    _build.LAUNCHES["lstm"] += 1
    return ys, (hbuf[t_len % 2], c)
