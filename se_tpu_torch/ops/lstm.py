"""One single-direction LSTM layer over a whole sequence: the port of
se_tpu/ops/pallas_lstm.py (`pallas_lstm_layer`, kernel `_lstm_kernel`,
plain math `_scan_forward`).

x (Bf, T, In) -> y (Bf, T, H) with torch's gate order (i, f, g, o):
wx (In, 4H), wh (H, 4H), b (4H,) the combined bias, h and c in fp32. On a
CUDA tensor `lstm_layer_kernel` launches csrc/lstm.cu for any Bf, either
direction and any initial carry; on a CPU tensor it runs `_reference`, the
plain twin: `_project_reference` (the projection as one matmul) then
`_recur_reference` (a step loop).

Two designs, chosen per layer call by `step_variant`:
- "tensor_core", the large fold and short sequences: `lstm_step`, one C
  call that enqueues a tensor-core step kernel a frame (3xTF32 `mma.sync`,
  the projection inside each step, weights from `pack_weights`; bf16
  weights: `lstm_step_bf16`, below);
- "persistent", the small fold: `lstm_project` (a tensor-core GEMM for all
  frames, twin `_project_reference`), then `lstm_recur` (the whole time
  loop in one cooperative launch, each block's slice of Wh resident in
  shared memory, grid from `persistent_plan`; twin `_recur_reference`).
Each of the three wrappers counts its own launches in `_build.LAUNCHES`
(`lstm`, `lstm_project`, `lstm_recur`).

bf16 weights (se_tpu's bf16 decode: `_enhance_jit` casts the parameters,
not the activations) launch the bf16 variants of all three
(`se_lstm_layer_bf16`, `se_lstm_project_bf16`, `se_lstm_recur_bf16`,
counted as `lstm_bf16`, `lstm_project_bf16`, `lstm_recur_bf16`) by the
LSTM's own dtype rule (`_build.lstm_dtype`): x fp32 or bf16, XP, h, c and
y fp32. They keep se_tpu's rounding points (se_tpu/nn/recurrent.py:36-37,
:150; pallas_lstm.py:44-46): x . Wx the exact fp32 product (XP fp32), h
rounded to bf16 where the recurrent product takes it, the carries fp32.
The twins do the same in plain torch: a torch matmul of two bf16 tensors
would return bf16, not se_tpu's fp32 (`preferred_element_type`). All three
run on bf16 tensor cores. The bf16 step (`lstm_step_bf16`): its weights
from `pack_weights_bf16` (Wx's rows padded to Kx, then Wh's to Kh, so a
K stage is wholly x or wholly h), an fp32 x split in three bf16 pieces in
its fragments (three exact products), a bf16 x padded once to a multiple
of 8 elements where it is not (`aligned_x`), and h from a bf16 shadow
that each frame writes for the next (`shadow`: one product); its warp
layout and launch mode come from `bf16_step_design`. The small fold's
projection (`lstm_proj_bf16`): the same x and `pack_input`'s weights in
bf16 through tc_common.cuh's bf16 ring; its recurrence
(`lstm_recur_bf16`): `pack_recurrent`'s slice in bf16 shared memory, h
from the same shadow, its plan (units and warps a block) from
`recur_bf16_designs`. The bound and what each design does about it:
csrc/lstm.cu's header, "bf16".

Under autograd each wrapper's launch is a Function (`_autograd.
kernel_call`): the kernel forward, and the VJP of a plain twin recomputed
in the backward, as se_tpu's custom VJP (`pallas_lstm.py:169-195`). The
layer's twin is `_chunked_reference`, a copy of se_tpu's
`_scan_forward_chunked` (`pallas_lstm.py:115-150`) that also takes
`reverse` and the carry: the projection a chunk of BWD_CHUNK frames inside
`torch.utils.checkpoint`, so the backward never holds the (Bf, T, 4H)
gates (12.8 GB at FullSubNet's sub band at B = 32), only each chunk's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from se_tpu_torch.ops import _autograd, _build
from se_tpu_torch.parallel.mesh import map_leading

# the tensor-core step's block: ROW_TILE rows x UNIT_TILE units, K in stages
# of K_TILE (csrc/lstm.cu TM, TU, TK); the projection's column tile
ROW_TILE, UNIT_TILE, K_TILE = 64, 16, 32
COL_TILE = 4 * UNIT_TILE
# packed columns run in groups of 8 units x the 4 gates (the mma's n8 tile)
GROUP = 8
# the persistent recurrence (csrc/lstm.cu PU, PR, PWARPS, P_BLOCKS_SM,
# RED_LD): GROUP units a block, rows in chunks of PERSIST_ROWS, K over
# PERSIST_WARPS warps, at most PERSIST_BLOCKS_SM blocks an SM
PERSIST_ROWS, PERSIST_WARPS, PERSIST_BLOCKS_SM = 16, 8, 2
RED_LD = 4 * GROUP + 4
# its bf16 variant (csrc/lstm.cu lstm_recur_bf16<tile, warps>): (units a
# block, warps over K) of each design built, at most 16 / warps blocks an
# SM (the register cap); the ones `recur_bf16_designs` offers by H
BF16_DESIGNS = ((16, 8), (16, 4), (8, 4))
# shared memory a block may opt into on sm_90 (the only target built), and
# an SM's for its resident blocks, each of which also holds 1 KB reserved
SMEM_OPTIN, SMEM_SM, SMEM_RESERVED = 232448, 233472, 1024
# sequences shorter than this take the tensor-core step even in a small
# fold: their few frames do not repay the persistent design's fixed cost
# (two launches, packing Wx and Wh, the occupancy query); measured by
# lstm_dispatch_sweep.py
SHORT_T = 16
# the bf16 step's x rows: a whole number of 16-byte copies of either dtype
X_ALIGN = 8
# frames a chunk of the layer's backward twin (se_tpu's chunk)
BWD_CHUNK = 32


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


class Plan(NamedTuple):
    """The persistent recurrence's grid: `units` unit tiles of `tile` units
    x `row_groups` row groups; block b owns unit tile b % units and the row
    chunks b // units + row_groups j; `chunks` a block at most, `smem`
    bytes a block, `blocks_sm` resident blocks an SM assumed, K over
    `warps` warps."""
    units: int
    row_groups: int
    chunks: int
    smem: int
    blocks_sm: int
    tile: int = GROUP
    warps: int = PERSIST_WARPS

    @property
    def blocks(self) -> int:
        return self.units * self.row_groups


def persistent_smem(h_dim: int, chunks: int,
                    dtype: torch.dtype = torch.float32, tile: int = GROUP,
                    warps: int = PERSIST_WARPS) -> int:
    """The recurrence's shared memory a block. fp32 (csrc/lstm.cu
    `persistent_smem`): the Wh slice and the staged rows (Hk + 4 floats a
    row), the warps' partial sums and the block's c. bf16
    (`recur_bf16_smem`, `tile` units and `warps` warps a block): the bf16
    Wh slice (4 tile rows) and staged shadow rows, Kh = H rounded up to
    K_TILE bf16 each, the partial sums (rows of 5 tile floats) and c."""
    if dtype == torch.bfloat16:
        kh = _ceil_to(h_dim, K_TILE)
        return (2 * (4 * tile + PERSIST_ROWS) * kh
                + 4 * warps * PERSIST_ROWS * 5 * tile
                + 4 * chunks * PERSIST_ROWS * tile)
    ld = _ceil_to(h_dim, GROUP) + 4
    return 4 * ((4 * GROUP + PERSIST_ROWS) * ld
                + PERSIST_WARPS * PERSIST_ROWS * RED_LD
                + chunks * PERSIST_ROWS * GROUP)


def recur_bf16_designs(h_dim: int) -> tuple[tuple[int, int, int], ...]:
    """The bf16 recurrence's designs at H = `h_dim`, each (units a block,
    warps, most blocks an SM), the preferred first (lstm_bf16_sweep.py
    recur): from H = 256, 16 units and 8 warps (half the blocks at the
    grid barrier of 8 units'; 3-9% ahead of the other designs at
    H = 1024, within the spread of two calls at H = 512 and B = 4), and
    16 units and 4 warps, whose smaller partial sums let two blocks share
    an SM at H = 512 (half the row chunks a block at GCRN's B = 256); below
    H = 256, 8 units and 4 warps (a few k16 steps a warp)."""
    if h_dim >= 256:
        return (16, 8, 2), (16, 4, 4)
    return ((8, 4, 4),)


def persistent_plan(bf: int, h_dim: int, sms: int,
                    dtype: torch.dtype = torch.float32,
                    design: tuple[int, int, int] | None = None) -> Plan | None:
    """The largest grid of resident blocks for the small fold's recurrence
    in the variant of `dtype` (the weights'), or None when even one block
    an SM cannot hold every unit tile's Wh slice at once (the barrier
    needs every block resident). bf16: of the designs `recur_bf16_designs`
    offers, the plan with the fewest row chunks a block (the first on a
    tie); `design` (units a block, warps, most blocks an SM) forces one."""
    if dtype != torch.bfloat16:
        return _plan(bf, h_dim, sms, dtype,
                     (GROUP, PERSIST_WARPS, PERSIST_BLOCKS_SM))
    plans = [p for p in (_plan(bf, h_dim, sms, dtype, d) for d in
                         ((design,) if design else recur_bf16_designs(h_dim)))
             if p is not None]
    return min(plans, key=lambda p: p.chunks, default=None)


def _plan(bf: int, h_dim: int, sms: int, dtype: torch.dtype,
          design: tuple[int, int, int]) -> Plan | None:
    tile, warps, most = design
    units = -(-h_dim // tile)
    chunks_total = -(-bf // PERSIST_ROWS)
    for blocks_sm in range(most, 0, -1):
        groups = min(chunks_total, blocks_sm * sms // units)
        if groups == 0:
            return None
        chunks = -(-chunks_total // groups)
        smem = persistent_smem(h_dim, chunks, dtype, tile, warps)
        if (smem <= SMEM_OPTIN
                and blocks_sm * (smem + SMEM_RESERVED) <= SMEM_SM):
            return Plan(units, groups, chunks, smem, blocks_sm, tile, warps)
    return None


def step_variant(bf: int, t_len: int, h_dim: int, sms: int,
                 dtype: torch.dtype = torch.float32) -> str:
    """The design a layer call takes: "persistent" when the tensor-core
    step's grid would leave some of the `sms` SMs without a block, the
    sequence has at least SHORT_T frames and the recurrence's Wh slices (in
    the variant of `dtype`) fit the resident blocks; "tensor_core"
    otherwise."""
    tc_blocks = -(-bf // ROW_TILE) * -(-h_dim // UNIT_TILE)
    if (tc_blocks < sms and t_len >= SHORT_T
            and persistent_plan(bf, h_dim, sms, dtype) is not None):
        return "persistent"
    return "tensor_core"


def recur_fit(h_dim: int, chunks: int, device=None,
              dtype: torch.dtype = torch.float32, tile: int = GROUP,
              warps: int = PERSIST_WARPS) -> tuple[int, int]:
    """What csrc/lstm.cu computes for a recurrence of `chunks` row chunks a
    block at H = `h_dim`, for the variant of `dtype` (the weights'; bf16:
    lstm_recur_bf16<tile, warps>): its shared memory a block, and the
    blocks an SM the occupancy API allows at that size (the C entry
    refuses a grid larger than this times the SM count). The card's check
    that `persistent_smem` and the plan's blocks an SM agree with the
    kernel's."""
    import ctypes

    lib = _build.library()
    smem, per_sm = ctypes.c_long(0), ctypes.c_int(0)
    dev = torch.device("cuda") if device is None else torch.device(device)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    _build._check(lib, "se_set_device", lib.se_set_device(idx))
    entry = _build.variant("se_lstm_recur_fit", dtype)
    fn = getattr(lib, entry)
    out = [ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int)]
    if dtype == torch.bfloat16:
        args = (h_dim, _ceil_to(h_dim, K_TILE), chunks, tile, warps)
    else:
        args = (h_dim, _ceil_to(h_dim, GROUP), chunks)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * len(args) + out
    _build._check(lib, entry, fn(*args, ctypes.byref(smem),
                                 ctypes.byref(per_sm)))
    return smem.value, per_sm.value


def _interleave(w: torch.Tensor, h_dim: int, hp: int, kp: int):
    """w (K, 4H) -> (4hp, kp), K-major: packed column (u // 8) * 32 +
    g * 8 + u % 8 is gate g of unit u, the padding zero."""
    k = w.shape[0]
    w = F.pad(w.view(k, 4, h_dim), (0, hp - h_dim))
    w = w.view(k, 4, hp // GROUP, GROUP).permute(2, 1, 3, 0)
    return F.pad(w.reshape(4 * hp, k), (0, kp - k)).contiguous()


@_build.packs
def pack_weights(wx: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """[Wx; Wh] (K = In + H, 4H) -> (4Hp, Kp), K-major, for the tensor-core
    step: each 32 packed columns hold the i, f, g, o columns of 8 units.
    Hp = H and Kp = K rounded up to UNIT_TILE and K_TILE."""
    in_dim, h_dim = wx.shape[0], wh.shape[0]
    return _interleave(torch.cat([wx, wh]), h_dim, _ceil_to(h_dim, UNIT_TILE),
                       _ceil_to(in_dim + h_dim, K_TILE))


@_build.packs
def pack_weights_bf16(wx: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """[Wx; Wh] -> (4Hp, Kx + Kh), K-major and interleaved as
    `pack_weights`, for the bf16 step: Wx's rows zero-padded to Kx = In
    rounded up to K_TILE, then Wh's to Kh = H rounded up to K_TILE, so each
    K stage of the kernel is wholly x or wholly h."""
    in_dim, h_dim = wx.shape[0], wh.shape[0]
    hp = _ceil_to(h_dim, UNIT_TILE)
    return torch.cat([_interleave(wx, h_dim, hp, _ceil_to(in_dim, K_TILE)),
                      _interleave(wh, h_dim, hp, _ceil_to(h_dim, K_TILE))],
                     dim=1)


@_build.packs
def pack_recurrent(wh: torch.Tensor) -> torch.Tensor:
    """Wh (H, 4H) -> (4Hk, Hk) in Wh's dtype, K-major and interleaved as
    `pack_weights`, for the persistent recurrence: Hk = H rounded up to 8
    (an fp32 unit tile and an mma's K; the bf16 kernel zero-fills its
    16-unit tiles and its K to Kh as it copies)."""
    h_dim = wh.shape[0]
    hk = _ceil_to(h_dim, GROUP)
    return _interleave(wh, h_dim, hk, hk)


@_build.packs
def pack_input(wx: torch.Tensor) -> torch.Tensor:
    """Wx (In, 4H) -> (Np, Kp) = Wx^T zero-padded, torch's column order, for
    the projection: Np = 4H and Kp = In rounded up to COL_TILE and
    K_TILE."""
    in_dim, n = wx.shape
    return F.pad(wx.t(), (0, _ceil_to(in_dim, K_TILE) - in_dim,
                          0, _ceil_to(n, COL_TILE) - n)).contiguous()


def _project_reference(x, wx, b):
    """XP = x . wx + b (Bf, T, 4H); with bf16 weights the operands widened
    to fp32 and XP fp32, as se_tpu's fp32-accumulated projection."""
    if wx.dtype == torch.bfloat16:
        x, wx, b = x.float(), wx.float(), b.float()
    return torch.matmul(x, wx) + b


def _recur_reference(xp, wh, reverse: bool = False, h0=None, c0=None,
                     h_in=None):
    """The time loop over XP. With a bf16 wh, h rounded to bf16 where the
    product takes it (se_tpu's `h.astype(wh.dtype)`), the product summed
    in fp32; h, c and y stay fp32. `h_in` (Bf, T, H), another run's y:
    each frame's product takes h_in at the frame walked before (h0 at the
    first) in place of the twin's own h, which holds a bf16 run to that
    run frame by frame (no h rounds to another bf16 value on the two
    sides: ops/_dtype.py LSTM_FLOOR)."""
    bf, t_len, _ = xp.shape
    h_dim = wh.shape[0]
    rounded = wh.dtype == torch.bfloat16
    whf = wh.float() if rounded else wh
    h = xp.new_zeros(bf, h_dim) if h0 is None else h0
    c = xp.new_zeros(bf, h_dim) if c0 is None else c0
    # frames taken by unbind and y put together by stack: under autograd
    # each frame's gradient is its own (Bf, 4H), where indexing xp[:, t]
    # and writing ys[:, t] would make a (Bf, T, 4H) one a frame
    xs, ys = xp.unbind(1), [None] * t_len
    prev = None
    for t in (range(t_len - 1, -1, -1) if reverse else range(t_len)):
        if h_in is not None and prev is not None:
            h = h_in[:, prev].float()
        prev = t
        hr = h.to(torch.bfloat16).float() if rounded else h
        i, f, g, o = (xs[t] + torch.matmul(hr, whf)).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys[t] = h
    ys = torch.stack(ys, 1) if t_len else xp.new_empty(bf, 0, h_dim)
    return ys, (h, c)


def _reference(x, wx, wh, b, reverse: bool = False, h0=None, c0=None,
               h_in=None):
    return _recur_reference(_project_reference(x, wx, b), wh, reverse, h0,
                            c0, h_in)


def _chunk_reference(x, wx, wh, b, h, c, reverse: bool):
    ys, (h, c) = _recur_reference(_project_reference(x, wx, b), wh, reverse,
                                  h, c)
    return ys, h, c


def _chunked_reference(x, wx, wh, b, reverse: bool = False, h0=None,
                       c0=None, chunk: int = BWD_CHUNK):
    """`_reference` with bounded memory under autograd: the frames in
    chunks of `chunk`, each chunk's projection and steps checkpointed, so
    the graph keeps the chunks' boundary carries (h, c) and recomputes a
    chunk's (Bf, chunk, 4H) gates in the backward."""
    from torch.utils.checkpoint import checkpoint

    bf, t_len, _ = x.shape
    h_dim = wh.shape[0]
    carry = torch.promote_types(x.dtype, torch.float32)  # fp32 at bf16 x
    h = x.new_zeros(bf, h_dim, dtype=carry) if h0 is None else h0
    c = x.new_zeros(bf, h_dim, dtype=carry) if c0 is None else c0
    starts = list(range(0, t_len, chunk))
    ys = {}
    for s in reversed(starts) if reverse else starts:
        ys[s], h, c = checkpoint(_chunk_reference, x[:, s:s + chunk], wx,
                                 wh, b, h, c, reverse, use_reentrant=False)
    return torch.cat([ys[s] for s in starts], dim=1), (h, c)


def _state(ref: torch.Tensor, bf: int, h_dim: int, h0, c0):
    """The C entries' fp32 carry buffers on ref's device: hbuf (2, Bf, H)
    with h0 in its first half, c (Bf, H) holding c0 (zeros by default)."""
    hbuf = torch.zeros(2, bf, h_dim, device=ref.device)
    if h0 is not None:
        _build.check(h0, (bf, h_dim), "h0")
        hbuf[0].copy_(h0)
    if c0 is not None:
        _build.check(c0, (bf, h_dim), "c0")
        c = c0.clone()
    else:
        c = torch.zeros(bf, h_dim, device=ref.device)
    return hbuf, c


def aligned_x(x: torch.Tensor) -> torch.Tensor:
    """x (Bf, T, In) as the bf16 step and projection copy it, 16 bytes at
    a time: rows of a multiple of X_ALIGN elements from a 16-byte aligned
    start. Where x is not so (LSTMNet's In = 161), a copy zero-padded to
    In rounded up to X_ALIGN (the packs' rows past In are zero too)."""
    in_dim = x.shape[2]
    if in_dim % X_ALIGN == 0 and x.data_ptr() % 16 == 0:
        return x
    return F.pad(x, (0, _ceil_to(in_dim, X_ALIGN) - in_dim))


def shadow(h0, bf: int, h_dim: int, device) -> torch.Tensor:
    """The bf16 step's and recurrence's shadow of h: (2, Bf, Kh) bf16, Kh
    = H rounded up to K_TILE, zero but for h0 rounded to bf16 (to nearest
    even, as se_tpu's `h.astype(bf16)`) in the first half's first H
    columns. Each frame writes h_t, rounded, to the other half: the h its
    successor's product takes."""
    hs = torch.zeros(2, bf, _ceil_to(h_dim, K_TILE), dtype=torch.bfloat16,
                     device=device)
    if h0 is not None:
        hs[0, :, :h_dim].copy_(h0)
    return hs


def _x_arg(x: torch.Tensor, dtype: torch.dtype) -> tuple:
    """x as a C entry takes it: the bf16 entries also take x's dtype."""
    return (x,) if dtype == torch.float32 else (x, x.dtype == torch.bfloat16)


def lstm_project(x: torch.Tensor, wx: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """x (Bf, T, In) -> XP = x . wx + b (Bf, T, 4H), fp32: csrc/lstm.cu
    `lstm_proj_tc` on a CUDA tensor (`lstm_proj_bf16` for bf16 weights)."""
    if x.device.type == "cpu":
        return _project_reference(x, wx, b)
    return _autograd.kernel_call(_project_launch, _project_reference, x,
                                 wx, b)


def _project_launch(x, wx, b):
    bf, t_len, in_dim = x.shape
    n = wx.shape[1]
    dtype = _build.lstm_dtype(x, (wx, b))
    _build.check(x, (bf, t_len, in_dim), "x", x.dtype)
    _build.check(wx, (in_dim, n), "wx", dtype)
    _build.check(b, (n,), "b", dtype)
    xp = torch.empty(bf, t_len, n, device=x.device)
    if dtype == torch.bfloat16:
        x = aligned_x(x)
    _build.launch(_build.variant("se_lstm_project", dtype),
                  *_x_arg(x, dtype), pack_input(wx), b, xp, bf * t_len,
                  x.shape[2], n, _ceil_to(in_dim, K_TILE))
    _build.LAUNCHES[_build.variant("lstm_project", dtype)] += 1
    return xp


def lstm_recur(xp: torch.Tensor, wh: torch.Tensor, reverse: bool = False,
               h0=None, c0=None):
    """The recurrence over XP (Bf, T, 4H) -> (ys (Bf, T, H), (h_T, c_T)):
    csrc/lstm.cu `lstm_recur_persistent` on a CUDA tensor, one cooperative
    launch (`lstm_recur_bf16` for a bf16 wh; XP and the carries fp32);
    raises when the Wh slices do not fit the resident blocks."""
    if xp.device.type == "cpu":
        return _recur_reference(xp, wh, reverse, h0, c0)
    return _autograd.kernel_call(
        lambda xp, wh, h0, c0: _recur_launch(xp, wh, reverse, h0, c0),
        lambda xp, wh, h0, c0: _recur_reference(xp, wh, reverse, h0, c0),
        xp, wh, h0, c0, no_grad_outputs=(1, 2))


def _recur_launch(xp, wh, reverse: bool, h0, c0, design=None):
    """The recurrence on its kernel; `design` forces the bf16 plan's
    (`persistent_plan`'s)."""
    bf, t_len, _ = xp.shape
    h_dim = wh.shape[0]
    if bf == 0:
        raise ValueError("lstm kernel: empty batch")
    dtype = _build.lstm_dtype(None, (wh,), (("xp", xp), ("h0", h0),
                                            ("c0", c0)))
    _build.check(xp, (bf, t_len, 4 * h_dim), "xp")
    _build.check(wh, (h_dim, 4 * h_dim), "wh", dtype)
    sms = torch.cuda.get_device_properties(xp.device).multi_processor_count
    plan = persistent_plan(bf, h_dim, sms, dtype, design)
    if plan is None:
        raise ValueError(f"lstm_recur: H = {h_dim}'s Wh slices do not fit "
                         f"the resident blocks of {sms} SMs")
    hbuf, c = _state(xp, bf, h_dim, h0, c0)
    ys = xp.new_empty(bf, t_len, h_dim)
    hk = _ceil_to(h_dim, GROUP)
    if dtype == torch.bfloat16:
        _build.launch("se_lstm_recur_bf16", xp, pack_recurrent(wh), hbuf,
                      shadow(h0, bf, h_dim, xp.device), c, ys, bf, t_len,
                      h_dim, hk, _ceil_to(h_dim, K_TILE), plan.row_groups,
                      plan.tile, plan.warps, bool(reverse))
    else:
        _build.launch("se_lstm_recur", xp, pack_recurrent(wh), hbuf, c, ys,
                      bf, t_len, h_dim, hk, plan.row_groups, bool(reverse))
    _build.LAUNCHES[_build.variant("lstm_recur", dtype)] += 1
    return ys, (hbuf[t_len % 2], c)


def _check_layer(x, wx, wh, b, h0=None, c0=None) -> torch.dtype:
    """Raise on what the layer's entries do not take; return the variant's
    dtype (`_build.lstm_dtype`)."""
    bf, t_len, in_dim = x.shape
    h_dim = wh.shape[0]
    if bf == 0:
        raise ValueError("lstm kernel: empty batch")
    dtype = _build.lstm_dtype(x, (wx, wh, b), (("h0", h0), ("c0", c0)))
    _build.check(x, (bf, t_len, in_dim), "x", x.dtype)
    _build.check(wx, (in_dim, 4 * h_dim), "wx", dtype)
    _build.check(wh, (h_dim, 4 * h_dim), "wh", dtype)
    _build.check(b, (4 * h_dim,), "b", dtype)
    return dtype


def lstm_step(x: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor,
              b: torch.Tensor, reverse: bool = False, h0=None, c0=None):
    """The layer on the tensor-core step: csrc/lstm.cu `lstm_step_tc` a
    frame, enqueued by one C call, on a CUDA tensor (its bf16 variant for
    bf16 weights)."""
    if x.device.type == "cpu":
        return _reference(x, wx, wh, b, reverse, h0, c0)
    return _layer_call(_step_launch, x, wx, wh, b, reverse, h0, c0)


def _layer_call(launch, x, wx, wh, b, reverse: bool, h0, c0):
    """`launch(x, wx, wh, b, reverse, h0, c0)` under autograd with the
    chunked twin's VJP; (h_T, c_T) carry no gradient."""
    return _autograd.kernel_call(
        lambda x, wx, wh, b, h0, c0: launch(x, wx, wh, b, reverse, h0, c0),
        lambda x, wx, wh, b, h0, c0: _chunked_reference(x, wx, wh, b,
                                                        reverse, h0, c0),
        x, wx, wh, b, h0, c0, no_grad_outputs=(1, 2))


def bf16_step_design(in_dim: int, h_dim: int) -> tuple[int, bool]:
    """The bf16 step's design for a layer: (m16 tiles a warp, frames
    launched as programmatic dependents). Where the x part is at least as
    long as the h part (Kx >= Kh: FullSubNet's second sub-band layer,
    LSTMNet's and CRN's 1024 -> 1024, DPCRN's intra LSTM), one m16 tile a
    warp (each fp32 x fragment split once, not by two warps) and
    programmatic launches (a frame's blocks run their x stages while the
    frame before finishes); else two m16 tiles a warp (fewer ldmatrix
    bytes for the h stages) and plain launches (early blocks would only
    slow the frame before's h stages). lstm_bf16_sweep.py times all four."""
    heavy_x = _ceil_to(in_dim, K_TILE) >= _ceil_to(h_dim, K_TILE)
    return (1, True) if heavy_x else (2, False)


def _step_launch(x, wx, wh, b, reverse: bool, h0, c0, design=None):
    """One layer on the step kernel; `design` forces the bf16 step's
    (bf16_step_design's pair)."""
    dtype = _check_layer(x, wx, wh, b, h0, c0)
    bf, t_len, in_dim = x.shape
    h_dim = wh.shape[0]
    hbuf, c = _state(x, bf, h_dim, h0, c0)
    ys = torch.empty(bf, t_len, h_dim, device=x.device)
    if dtype == torch.bfloat16:
        x = aligned_x(x)
        mt, programmatic = design or bf16_step_design(in_dim, h_dim)
        _build.launch("se_lstm_layer_bf16", x, x.dtype == torch.bfloat16,
                      pack_weights_bf16(wx, wh), b, hbuf,
                      shadow(h0, bf, h_dim, x.device), c, ys, bf, t_len,
                      x.shape[2], h_dim, _ceil_to(h_dim, UNIT_TILE),
                      _ceil_to(in_dim, K_TILE), _ceil_to(h_dim, K_TILE), mt,
                      programmatic, bool(reverse))
    else:
        _build.launch("se_lstm_layer", x, pack_weights(wx, wh), b, hbuf, c,
                      ys, bf, t_len, in_dim, h_dim,
                      _ceil_to(h_dim, UNIT_TILE),
                      _ceil_to(in_dim + h_dim, K_TILE), bool(reverse))
    _build.LAUNCHES[_build.variant("lstm", dtype)] += 1
    return ys, (hbuf[t_len % 2], c)


def lstm_layer_kernel(x: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor,
                      b: torch.Tensor, reverse: bool = False, h0=None,
                      c0=None):
    """-> (ys (Bf, T, H), (h_T, c_T)), h_T/c_T after the last frame walked
    (frame 0 when `reverse`). h0/c0 (Bf, H) default to zeros. On a CUDA
    tensor, the design `step_variant` names for the shape, in the variant
    of the weights' dtype (bf16 weights: x fp32 or bf16; ys and the carry
    fp32 either way). Under autograd
    gradients reach x, the weights and h0/c0 through ys alone: the
    returned (h_T, c_T) carry no gradient. Under an active mesh with a
    "model" axis Bf splits over the model group (`parallel.map_leading`:
    x and the carries mapped, the weights replicated)."""
    return map_leading(lambda x, h0, c0, wx, wh, b: _layer(
        x, wx, wh, b, reverse, h0, c0), (x, h0, c0), (wx, wh, b))


def _layer(x, wx, wh, b, reverse: bool, h0, c0):
    if x.device.type == "cpu":
        return _reference(x, wx, wh, b, reverse, h0, c0)
    return _layer_call(_layer_launch, x, wx, wh, b, reverse, h0, c0)


def _layer_launch(x, wx, wh, b, reverse: bool, h0, c0):
    dtype = _check_layer(x, wx, wh, b, h0, c0)
    bf, t_len, _ = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    if step_variant(bf, t_len, wh.shape[0], sms, dtype) == "persistent":
        return _recur_launch(_project_launch(x, wx, b), wh, reverse, h0, c0)
    return _step_launch(x, wx, wh, b, reverse, h0, c0)
