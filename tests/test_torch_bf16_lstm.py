"""The bf16 LSTM kernels' plain twins against se_tpu on the CPU: the layer
(`lstm_layer_kernel`, the twin of `lstm_step_bf16` and of the small
fold's two kernels), the projection (`lstm_project`, `lstm_proj_bf16`) and
the recurrence (`lstm_recur`, `lstm_recur_bf16`) with bf16 weights and
an fp32 or a bf16 x, against se_tpu's Pallas layer `_pallas_lstm_tm` in
interpret mode (as tests/test_pallas_lstm.py runs it) and against its
scan path (`se_tpu.nn.recurrent.lstm_layer`: `reverse` and carries).

The small fold's two bf16 kernels' arithmetic, emulated in torch:
`lstm_recur_bf16` (`recur_bf16_emulated`: the shadow's bf16 rows, one
m16n8k16 product a k16 step, each warp's contiguous share of the k16
steps summed in fp32, the warps' partial sums added onto XP in warp
order) for each design the plan may pick, and `lstm_proj_bf16` (the bf16
ring's sums, tests/test_torch_bf16_kernels.py `three_pieces` for an fp32
x and `k16_stages` for a bf16 one, over `aligned_x`'s x and
`pack_input`'s bf16 weights), each against se_tpu within fp32's 1e-5 *
max(1, max|ref|) (the recurrence stepped along se_tpu's own y); the
packs and the plans by dtype.

se_tpu's rounding points: the projection x . Wx in fp32 (XP fp32), h
rounded to bf16 where the recurrent product takes it, the carries and
the scan's y fp32; the Pallas kernel writes y in x's dtype, so at a bf16
x the port's fp32 y is rounded to bf16 before the comparison. Weights
U(+-1/sqrt(H)) as torch's init, rounded to bf16 on each side (both to
nearest even: the same values).

Tolerance. Each side rounds its own fp32 h to bf16 every frame, and the
two sum in other orders, so now and then an h element rounds to
neighbouring bf16 values on the two sides (a flip: a handful in these
runs) and the sequences part from there by a fraction of a bf16 ulp.
Two checks, then (ops/_dtype.py LSTM_FLOOR):
- stepped: the twin run frame by frame along se_tpu's own y (`h_in`: each
  product takes se_tpu's h, rounded as both round it), which cannot flip,
  within fp32's 1e-5 * max(1, max|ref|) (a bf16 y, the Pallas kernel's at
  a bf16 x: `bf16_close`, 2^-7 |ref| + 1e-6 max|ref|);
- free-running: `bf16_close` with one bf16 ulp of the largest output as
  its floor, 2^-7 (|ref| + max|ref|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from se_tpu.nn.recurrent import _lstm_recurrence
from se_tpu.nn.recurrent import lstm_layer as j_lstm_layer
from se_tpu.ops.pallas_lstm import _pallas_lstm_tm
from se_tpu_torch.ops import lstm
from se_tpu_torch.ops._dtype import LSTM_FLOOR
from test_torch_bf16_kernels import k16_stages, three_pieces
from torch_kernel_inputs import bf16_close, rand

BF16 = torch.bfloat16
# (Bf, T, In, H): ragged folds, H not a multiple of the unit tiles, T up to
# 70 frames
SHAPES = [(5, 23, 24, 16), (11, 70, 40, 32), (3, 17, 33, 48)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, bf, t, in_dim, h, x_bf16):
    """(numpy x, wx, wh, b fp32; their jax and torch arrays): x in fp32 or
    bf16, the weights in bf16."""
    rng = np.random.default_rng(seed)
    x = rand(rng, bf, t, in_dim)
    w = [(rng.uniform(-1, 1, s) * h ** -0.5).astype(np.float32)
         for s in ((in_dim, 4 * h), (h, 4 * h), (4 * h,))]
    jx = jnp.asarray(x, jnp.bfloat16 if x_bf16 else jnp.float32)
    tx = torch.from_numpy(x).to(BF16 if x_bf16 else torch.float32)
    jw = [jnp.asarray(a, jnp.bfloat16) for a in w]
    tw = [torch.from_numpy(a).to(BF16) for a in w]
    for a, b in zip(jw, tw):  # both sides round alike
        assert np.array_equal(np.asarray(a, np.float32), b.float().numpy())
    return (jx, *jw), (tx, *tw)


def _carry(seed, bf, h):
    rng = np.random.default_rng(seed + 1)
    h0, c0 = rand(rng, bf, h, scale=0.5), rand(rng, bf, h, scale=0.5)
    return (jnp.asarray(h0), jnp.asarray(c0)), (torch.from_numpy(h0),
                                                torch.from_numpy(c0))


def _fp32_level(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        err = float(np.abs(g.float().numpy() - w).max())
        assert err <= 1e-5 * max(1.0, float(np.abs(w).max())), err


def _free_running(got, want):
    bf16_close(got, [np.array(a, np.float32) for a in want],
               floor=LSTM_FLOOR)


def _h_in(ys):
    """A reference run's y as the twin's `h_in`."""
    return torch.from_numpy(np.array(ys, np.float32))


@pytest.mark.parametrize("x_bf16", [False, True])
@pytest.mark.parametrize("bf,t,in_dim,h", SHAPES)
def test_layer_twin_matches_pallas_interpret(x_bf16, bf, t, in_dim, h):
    (jx, jwx, jwh, jb), (tx, twx, twh, tb) = _inputs(bf + t, bf, t, in_dim,
                                                     h, x_bf16)
    want = jnp.swapaxes(_pallas_lstm_tm(jnp.swapaxes(jx, 0, 1), jwx, jwh, jb,
                                        batch_tile=bf, interpret=True), 0, 1)
    ys, (hn, cn) = lstm.lstm_layer_kernel(tx, twx, twh, tb)
    assert ys.dtype == hn.dtype == cn.dtype == torch.float32
    assert want.dtype == jx.dtype
    _free_running([ys.to(BF16) if x_bf16 else ys], [want])
    # stepped along the kernel's y: a bf16 y is its h rounded as the
    # product takes it
    stepped, _ = lstm._reference(tx, twx, twh, tb, h_in=_h_in(want))
    if x_bf16:
        bf16_close([stepped.to(BF16)], [np.asarray(want, np.float32)])
    else:
        _fp32_level([stepped], [want])


@pytest.mark.parametrize("x_bf16", [False, True])
@pytest.mark.parametrize("reverse,carry", [(False, False), (True, False),
                                           (False, True)])
@pytest.mark.parametrize("bf,t,in_dim,h", SHAPES)
def test_layer_twin_matches_se_tpu_scan(x_bf16, reverse, carry, bf, t,
                                        in_dim, h):
    (jx, jwx, jwh, jb), (tx, twx, twh, tb) = _inputs(bf * t, bf, t, in_dim,
                                                     h, x_bf16)
    jc, tc = _carry(bf * t, bf, h) if carry else (None, (None, None))
    want, (wh_, wc_) = j_lstm_layer(jx, jwx, jwh, jb, reverse=reverse,
                                    carry=jc, return_carry=True)
    ys, (hn, cn) = lstm.lstm_layer_kernel(tx, twx, twh, tb, reverse, *tc)
    assert want.dtype == jnp.float32  # the scan's y
    _free_running([ys, hn, cn], [want, wh_, wc_])
    stepped = lstm._reference(tx, twx, twh, tb, reverse, *tc,
                              h_in=_h_in(want))
    _fp32_level([stepped[0], *stepped[1]], [want, wh_, wc_])


@pytest.mark.parametrize("x_bf16", [False, True])
@pytest.mark.parametrize("bf,t,in_dim,h", SHAPES)
def test_project_twin_matches_se_tpu(x_bf16, bf, t, in_dim, h):
    """XP = x . Wx + b in fp32 (se_tpu/nn/recurrent.py:150): a torch
    matmul of two bf16 tensors would round XP to bf16."""
    (jx, jwx, _, jb), (tx, twx, _, tb) = _inputs(7 * bf, bf, t, in_dim, h,
                                                 x_bf16)
    want = jnp.matmul(jx, jwx, preferred_element_type=jnp.float32) + jb
    got = lstm.lstm_project(tx, twx, tb)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    bf16_close([got], [np.array(want)])
    _fp32_level([got], [want])


@pytest.mark.parametrize("reverse,carry", [(False, False), (True, False),
                                           (False, True)])
@pytest.mark.parametrize("bf,t,in_dim,h", SHAPES)
def test_recur_twin_matches_se_tpu(reverse, carry, bf, t, in_dim, h):
    """The time loop over an fp32 XP with a bf16 Wh: se_tpu's
    `_lstm_recurrence` (h.astype(wh.dtype) @ wh, fp32 accumulation and
    carries) on the time-major XP, flipped for `reverse` as its
    `lstm_layer` does."""
    rng = np.random.default_rng(3 * bf + t)
    xp = rand(rng, bf, t, 4 * h)
    wh = (rng.uniform(-1, 1, (h, 4 * h)) * h ** -0.5).astype(np.float32)
    jc, tc = _carry(bf, bf, h) if carry else (None, (None, None))
    xs = jnp.swapaxes(jnp.asarray(xp), 0, 1)
    ys, (wh_, wc_) = _lstm_recurrence(xs[::-1] if reverse else xs,
                                      jnp.asarray(wh, jnp.bfloat16),
                                      carry=jc)
    want = jnp.swapaxes(ys[::-1] if reverse else ys, 0, 1)
    got, (hn, cn) = lstm.lstm_recur(torch.from_numpy(xp),
                                    torch.from_numpy(wh).to(BF16), reverse,
                                    *tc)
    assert got.dtype == hn.dtype == cn.dtype == torch.float32
    _free_running([got, hn, cn], [want, wh_, wc_])
    stepped = lstm._recur_reference(torch.from_numpy(xp),
                                    torch.from_numpy(wh).to(BF16), reverse,
                                    *tc, h_in=_h_in(want))
    _fp32_level([stepped[0], *stepped[1]], [want, wh_, wc_])


def test_recurrent_product_takes_h_in_bf16():
    """The twin's rounding point is se_tpu's: stepped along se_tpu's y,
    the bf16 twin is fp32-close to it, and the same recurrence over fp32 h
    is not (it parts by far more than fp32 round-off)."""
    (jx, jwx, jwh, jb), (tx, twx, twh, tb) = _inputs(9, 6, 40, 24, 32, False)
    want = np.asarray(j_lstm_layer(jx, jwx, jwh, jb))
    h_in = _h_in(want)
    got, _ = lstm._reference(tx, twx, twh, tb, h_in=h_in)
    unrounded, _ = lstm._reference(tx, twx.float(), twh.float(), tb.float(),
                                   h_in=h_in)
    err = float(np.abs(got.numpy() - want).max())
    err_unrounded = float(np.abs(unrounded.numpy() - want).max())
    assert err <= 1e-5 < 0.1 * err_unrounded, (err, err_unrounded)


# ------------------------------------------ the small fold's bf16 kernels

def recur_bf16_emulated(xp, wh, tile: int, warps: int, reverse=False,
                        h0=None, c0=None, h_in=None):
    """lstm_recur_bf16's arithmetic for a design of `tile` units and `warps`
    warps a block: per frame the shadow's rows (h rounded to bf16, zero
    past H to Kh = H rounded up to 32) against `pack_recurrent`'s bf16
    slice (zero past its 4 Hk rows and Hk columns, as the kernel's copy
    fills it), one m16n8k16 product a k16 step (16 exact products and the
    fp32 sum so far, rounded once: fp64 then fp32), warp w summing its
    contiguous share of the Kh / 16 steps; each gate then XP's input plus
    the warps' partial sums in warp order, fp32; the cell in fp32. `h_in`
    as `_recur_reference`'s."""
    bf, t_len, _ = xp.shape
    h_dim = wh.shape[0]
    kh = -(-h_dim // 32) * 32
    packed = lstm.pack_recurrent(wh)
    units = -(-h_dim // tile) * tile
    w = F.pad(packed.float(), (0, kh - packed.shape[1],
                               0, 4 * units - packed.shape[0])).double()
    steps = kh // 16
    shares = [range(i * steps // warps, (i + 1) * steps // warps)
              for i in range(warps)]
    h = xp.new_zeros(bf, h_dim) if h0 is None else h0
    c = xp.new_zeros(bf, h_dim) if c0 is None else c0
    ys = torch.empty(bf, t_len, h_dim)
    prev = None
    for t in range(t_len - 1, -1, -1) if reverse else range(t_len):
        if h_in is not None and prev is not None:
            h = h_in[:, prev]
        prev = t
        hs = F.pad(h.to(torch.bfloat16).float(), (0, kh - h_dim)).double()
        gates = [xp[:, t, g * h_dim:(g + 1) * h_dim] for g in range(4)]
        for share in shares:
            acc = torch.zeros(bf, 4 * units)
            for st in share:
                k = slice(16 * st, 16 * st + 16)
                acc = (acc.double() + hs[:, k] @ w[:, k].t()).float()
            # packed column (u // 8) 32 + 8 g + u % 8: gate g of unit u
            acc = acc.view(bf, units // 8, 4, 8)
            gates = [gates[g] + acc[:, :, g].reshape(bf, units)[:, :h_dim]
                     for g in range(4)]
        i, f, g, o = gates
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys[:, t] = h
    return ys, h, c


@pytest.mark.parametrize("tile,warps", lstm.BF16_DESIGNS)
@pytest.mark.parametrize("reverse,carry", [(False, False), (True, True)])
@pytest.mark.parametrize("bf,t,h", [(5, 7, 12), (19, 6, 100), (3, 5, 44)])
def test_recur_bf16_order_matches_se_tpu(tile, warps, reverse, carry, bf, t,
                                         h):
    """lstm_recur_bf16's sums, stepped along se_tpu's `_lstm_recurrence`
    (bf16 Wh, h.astype(bf16) @ wh, fp32 accumulation) on the same h, within
    1e-5 * max(1, max|ref|) for y and the carries; the same design free-
    running against the twin within LSTM_FLOOR. H = 12 and 100: K padded
    to 32 and 128, the units to whole tiles; Bf = 19: two row chunks."""
    rng = np.random.default_rng(bf * h + t)
    xp = rand(rng, bf, t, 4 * h)
    wh = (rng.uniform(-1, 1, (h, 4 * h)) * h ** -0.5).astype(np.float32)
    jc, tc = _carry(bf, bf, h) if carry else (None, (None, None))
    xs = jnp.swapaxes(jnp.asarray(xp), 0, 1)
    ys, (wh_, wc_) = _lstm_recurrence(xs[::-1] if reverse else xs,
                                      jnp.asarray(wh, jnp.bfloat16),
                                      carry=jc)
    want = jnp.swapaxes(ys[::-1] if reverse else ys, 0, 1)
    twh = torch.from_numpy(wh).to(BF16)
    got = recur_bf16_emulated(torch.from_numpy(xp), twh, tile, warps,
                              reverse, *tc, h_in=_h_in(want))
    _fp32_level(got, [want, wh_, wc_])
    free = recur_bf16_emulated(torch.from_numpy(xp), twh, tile, warps,
                               reverse, *tc)
    ref, (hn, cn) = lstm._recur_reference(torch.from_numpy(xp), twh,
                                          reverse, *tc)
    bf16_close(list(free), [ref, hn, cn], floor=LSTM_FLOOR)


def proj_bf16_emulated(x, wx, b):
    """lstm_proj_bf16's arithmetic: x as `aligned_x` pads it and the copy
    zero-fills it to Kp = In rounded up to 32, against `pack_input`'s bf16
    weights (Np, Kp); the bf16 ring's sums, a fresh fp32 sum a stage of 32
    (an fp32 x in three bf16 pieces, lo first: `three_pieces`; a bf16 x in
    one: `k16_stages`); XP = the sums plus the bf16 bias, fp32."""
    bf, t_len, in_dim = x.shape
    wp = lstm.pack_input(wx)
    xa = lstm.aligned_x(x).float().reshape(bf * t_len, -1)
    a = F.pad(xa, (0, wp.shape[1] - xa.shape[1]))
    sums = (k16_stages if x.dtype == BF16 else three_pieces)(a, wp.t())
    n = wx.shape[1]
    return (sums[:, :n] + b.float()).view(bf, t_len, n)


@pytest.mark.parametrize("x_bf16", [False, True])
@pytest.mark.parametrize("bf,t,in_dim,h", [(4, 9, 161, 12), (3, 7, 100, 100),
                                           (5, 6, 33, 44), (2, 5, 512, 16)])
def test_proj_bf16_order_matches_se_tpu(x_bf16, bf, t, in_dim, h):
    """lstm_proj_bf16's sums against se_tpu's fp32-accumulated x . wx + b
    (se_tpu/nn/recurrent.py:150, preferred_element_type=fp32) within 1e-5
    * max(1, max|ref|): In = 161 and 33 padded to 168 and 40, then to the
    stage's 192 and 64; K = 512 sixteen stages."""
    (jx, jwx, _, jb), (tx, twx, _, tb) = _inputs(11 * bf + in_dim, bf, t,
                                                 in_dim, h, x_bf16)
    want = jnp.matmul(jx, jwx, preferred_element_type=jnp.float32) + jb
    got = proj_bf16_emulated(tx, twx, tb)
    _fp32_level([got], [want])


@pytest.mark.parametrize("h", [12, 20, 44, 100])
def test_pack_recurrent_bf16_is_an_exact_permutation(h):
    """pack_recurrent of a bf16 Wh: bf16 (4Hk, Hk), Hk = H rounded up to 8,
    packed row (u // 8) 32 + 8 g + u % 8 holding gate g of unit u's column
    bit for bit, zeros past H (the kernel zero-fills its 16-unit tiles
    and K past Hk to Kh as it copies)."""
    rng = np.random.default_rng(h)
    wh = torch.from_numpy(rand(rng, h, 4 * h)).to(BF16)
    got = lstm.pack_recurrent(wh)
    hk = -(-h // 8) * 8
    assert got.dtype == BF16 and got.shape == (4 * hk, hk)
    assert got.is_contiguous()
    want = torch.zeros(4 * hk, hk, dtype=BF16)
    for g in range(4):
        for u in range(h):
            want[(u // 8) * 32 + 8 * g + u % 8, :h] = wh[:, g * h + u]
    assert torch.equal(got, want)


F32 = torch.float32
# Every small-fold layer call of chip_smoke.py's LSTM_CALLS at B = 4, 32
# and 256 on a 132-SM H100, by dtype: (call, B, H, Bf, dtype, (units, row
# groups, chunks a block, shared bytes, blocks an SM, units a block,
# warps)). The bytes by hand:
# - fp32: 4 ((32 + 16) (Hk + 4) + 8 x 16 x 36 + chunks x 16 x 8), Hk = H
#   rounded up to 8: H = 512, one chunk 4 (24,768 + 4,608 + 128) =
#   118,016; H = 1024 4 (49,344 + 4,608 + 128) = 216,320; H = 128
#   4 (6,336 + 4,608 + 128) = 44,288.
# - bf16: 2 (4 tile + 16) Kh + 4 warps x 16 x 5 tile + 4 chunks x 16 tile,
#   Kh = H rounded up to 32: H = 1024, 16 units, 8 warps, one chunk
#   163,840 + 40,960 + 1,024 = 205,824; H = 512 81,920 + 40,960 + 1,024 =
#   123,904, with 4 warps and two chunks 81,920 + 20,480 + 2,048 = 104,448
#   (two blocks an SM: 2 x 105,472 <= 233,472); H = 128, 8 units, 4
#   warps 12,288 + 10,240 + 512 = 23,040 (+ 512 a chunk).
# The sub band and DPCRN's intra LSTM take the tensor-core step at every
# B, as LSTMNet and CRN at B = 256.
SMALL_FOLD_PLANS = [
    ("FullSubNet full band", 4, 512, 4, F32, (64, 1, 1, 118016, 1, 8, 8)),
    ("FullSubNet full band", 4, 512, 4, BF16,
     (32, 1, 1, 123904, 1, 16, 8)),
    ("FullSubNet full band", 32, 512, 32, F32, (64, 2, 1, 118016, 1, 8, 8)),
    ("FullSubNet full band", 32, 512, 32, BF16,
     (32, 2, 1, 123904, 1, 16, 8)),
    ("FullSubNet full band", 256, 512, 256, F32,
     (64, 2, 8, 121600, 1, 8, 8)),
    ("FullSubNet full band", 256, 512, 256, BF16,
     (32, 8, 2, 104448, 2, 16, 4)),
    ("DCCRN clstm", 4, 128, 8, F32, (16, 1, 1, 44288, 2, 8, 8)),
    ("DCCRN clstm", 4, 128, 8, BF16, (16, 1, 1, 23040, 4, 8, 4)),
    ("DCCRN clstm", 32, 128, 64, F32, (16, 4, 1, 44288, 2, 8, 8)),
    ("DCCRN clstm", 32, 128, 64, BF16, (16, 4, 1, 23040, 4, 8, 4)),
    ("DCCRN clstm", 256, 128, 512, F32, (16, 16, 2, 44800, 2, 8, 8)),
    ("DCCRN clstm", 256, 128, 512, BF16, (16, 32, 1, 23040, 4, 8, 4)),
    ("LSTMNet / CRN", 4, 1024, 4, F32, (128, 1, 1, 216320, 1, 8, 8)),
    ("LSTMNet / CRN", 4, 1024, 4, BF16, (64, 1, 1, 205824, 1, 16, 8)),
    ("LSTMNet / CRN", 32, 1024, 32, F32, (128, 1, 2, 216832, 1, 8, 8)),
    ("LSTMNet / CRN", 32, 1024, 32, BF16, (64, 2, 1, 205824, 1, 16, 8)),
    ("GCRN glstm", 4, 512, 4, F32, (64, 1, 1, 118016, 1, 8, 8)),
    ("GCRN glstm", 4, 512, 4, BF16, (32, 1, 1, 123904, 1, 16, 8)),
    ("GCRN glstm", 32, 512, 32, F32, (64, 2, 1, 118016, 1, 8, 8)),
    ("GCRN glstm", 32, 512, 32, BF16, (32, 2, 1, 123904, 1, 16, 8)),
    ("GCRN glstm", 256, 512, 256, F32, (64, 2, 8, 121600, 1, 8, 8)),
    ("GCRN glstm", 256, 512, 256, BF16, (32, 8, 2, 104448, 2, 16, 4)),
    ("DPCRN inter", 4, 128, 16, F32, (16, 1, 1, 44288, 2, 8, 8)),
    ("DPCRN inter", 4, 128, 16, BF16, (16, 1, 1, 23040, 4, 8, 4)),
    ("DPCRN inter", 32, 128, 128, F32, (16, 8, 1, 44288, 2, 8, 8)),
    ("DPCRN inter", 32, 128, 128, BF16, (16, 8, 1, 23040, 4, 8, 4)),
    ("DPCRN inter", 256, 128, 1024, F32, (16, 16, 4, 45824, 2, 8, 8)),
    ("DPCRN inter", 256, 128, 1024, BF16, (16, 33, 2, 23552, 4, 8, 4)),
    ("DeepXi ResLSTM", 4, 512, 4, F32, (64, 1, 1, 118016, 1, 8, 8)),
    ("DeepXi ResLSTM", 4, 512, 4, BF16, (32, 1, 1, 123904, 1, 16, 8)),
    ("DeepXi ResLSTM", 32, 512, 32, F32, (64, 2, 1, 118016, 1, 8, 8)),
    ("DeepXi ResLSTM", 32, 512, 32, BF16, (32, 2, 1, 123904, 1, 16, 8)),
    ("DeepXi ResLSTM", 256, 512, 256, F32, (64, 2, 8, 121600, 1, 8, 8)),
    ("DeepXi ResLSTM", 256, 512, 256, BF16,
     (32, 8, 2, 104448, 2, 16, 4)),
]


@pytest.mark.parametrize(
    "call,batch,h,bf,dtype,want", SMALL_FOLD_PLANS,
    ids=[f"{c} B{b} {'bf16' if d == BF16 else 'fp32'}"
         for c, b, _, _, d, _ in SMALL_FOLD_PLANS])
def test_persistent_plan_by_dtype_of_each_small_fold_call(call, batch, h, bf,
                                                          dtype, want):
    """persistent_plan and persistent_smem by dtype against the bytes worked
    by hand above; the plan's blocks fit the opt-in and SM shared memory
    and one wave of resident blocks, each (row, unit) owned once."""
    assert lstm.step_variant(bf, 401, h, 132, dtype) == "persistent"
    plan = lstm.persistent_plan(bf, h, 132, dtype)
    assert tuple(plan) == want
    assert plan.smem == lstm.persistent_smem(h, plan.chunks, dtype,
                                             plan.tile, plan.warps)
    assert plan.smem <= lstm.SMEM_OPTIN
    assert plan.blocks_sm * (plan.smem + lstm.SMEM_RESERVED) <= lstm.SMEM_SM
    assert plan.blocks <= plan.blocks_sm * 132
    owner = np.zeros((bf, h), np.int64)
    for block in range(plan.blocks):
        tile, group = block % plan.units, block // plan.units
        for q in range(group, -(-bf // 16), plan.row_groups):
            owner[16 * q:16 * q + 16,
                  plan.tile * tile:plan.tile * tile + plan.tile] += 1
    assert (owner == 1).all()


def test_bf16_plan_takes_the_design_with_the_fewest_chunks():
    """At H = 512 and Bf = 256 (GCRN's B = 256) 16 units and 8 warps would
    give each of 128 blocks four row chunks; 16 units and 4 warps fit two
    blocks an SM, 256 blocks of two chunks: the plan takes those. At one
    chunk a block either way the first design stands (LSTMNet's B = 32)."""
    first = lstm.persistent_plan(256, 512, 132, BF16, (16, 8, 2))
    assert (first.chunks, first.blocks) == (4, 128)
    plan = lstm.persistent_plan(256, 512, 132, BF16)
    assert (plan.tile, plan.warps, plan.chunks, plan.blocks) == (16, 4, 2,
                                                                 256)
    plan = lstm.persistent_plan(32, 1024, 132, BF16)
    assert (plan.tile, plan.warps, plan.chunks) == (16, 8, 1)
    assert lstm.persistent_plan(4, 4096, 132, BF16) is None
