"""The bf16 LSTM kernels' plain twins against se_tpu on the CPU: the layer
(`lstm_layer_kernel`, the twin of `lstm_step_tc` and of the small fold's
two kernels), the projection (`lstm_project`, `lstm_proj_tc`) and the
recurrence (`lstm_recur`, `lstm_recur_persistent`) with bf16 weights and
an fp32 or a bf16 x, against se_tpu's Pallas layer `_pallas_lstm_tm` in
interpret mode (as tests/test_pallas_lstm.py runs it) and against its
scan path (`se_tpu.nn.recurrent.lstm_layer`: `reverse` and carries).

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

from se_tpu.nn.recurrent import _lstm_recurrence
from se_tpu.nn.recurrent import lstm_layer as j_lstm_layer
from se_tpu.ops.pallas_lstm import _pallas_lstm_tm
from se_tpu_torch.ops import lstm
from se_tpu_torch.ops._dtype import LSTM_FLOOR
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
