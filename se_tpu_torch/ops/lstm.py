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

Two step kernels, chosen per layer call by `step_variant`: the tensor-core
step (3xTF32 `mma.sync`, weights from `pack_weights`) when its grid gives
every SM a block, the split-K step otherwise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from se_tpu_torch.ops import _build

# the tensor-core step's block: ROW_TILE rows x UNIT_TILE units, K in stages
# of K_TILE (csrc/lstm.cu TM, TU, TK); the split-K step's rows a block and
# warps (RS, WS)
ROW_TILE, UNIT_TILE, K_TILE = 64, 16, 32
SPLIT_ROWS, SPLIT_WARPS = 8, 8
# packed columns run in groups of 8 units x the 4 gates (the mma's n8 tile)
GROUP = 8
# shared memory a block may opt into on sm_90 (the only target built)
SMEM_OPTIN = 232448


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def step_variant(bf: int, in_dim: int, h_dim: int, sms: int) -> str:
    """The step a layer call takes: "tensor_core" when that step's grid
    gives each of `sms` SMs at least one block, or when the split-K step's
    rows would not fit in shared memory; "split" otherwise."""
    tc_blocks = -(-bf // ROW_TILE) * -(-h_dim // UNIT_TILE)
    split_smem = (SPLIT_ROWS * (in_dim + h_dim)
                  + SPLIT_WARPS * SPLIT_ROWS * 32) * 4
    if tc_blocks < sms and split_smem <= SMEM_OPTIN:
        return "split"
    return "tensor_core"


def pack_weights(wx: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """[Wx; Wh] (K = In + H, 4H) -> (4Hp, Kp), K-major, for the tensor-core
    step: packed column (u // 8) * 32 + g * 8 + u % 8 is gate g of unit u,
    so each 32 columns hold the i, f, g, o columns of 8 units. Hp = H and
    Kp = K rounded up to UNIT_TILE and K_TILE, the padding zero."""
    in_dim, h_dim = wx.shape[0], wh.shape[0]
    k = in_dim + h_dim
    hp, kp = _ceil_to(h_dim, UNIT_TILE), _ceil_to(k, K_TILE)
    w = F.pad(torch.cat([wx, wh]).view(k, 4, h_dim), (0, hp - h_dim))
    w = w.view(k, 4, hp // GROUP, GROUP).permute(2, 1, 3, 0)
    return F.pad(w.reshape(4 * hp, k), (0, kp - k)).contiguous()


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
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    wp = None
    if step_variant(bf, in_dim, h_dim, sms) == "tensor_core":
        wp = pack_weights(wx, wh)
    _build.launch("se_lstm_layer", x, wx, wh, wp, b, hbuf, c, ys, bf, t_len,
                  in_dim, h_dim, _ceil_to(h_dim, UNIT_TILE),
                  _ceil_to(in_dim + h_dim, K_TILE), bool(reverse))
    _build.LAUNCHES["lstm"] += 1
    return ys, (hbuf[t_len % 2], c)
