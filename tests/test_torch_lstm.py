"""se_tpu_torch's LSTM layer and module against se_tpu's on the CPU.

The port's `lstm_layer` (its plain twin on a CPU tensor) against
`se_tpu.nn.recurrent.lstm_layer` (the lax.scan path) and against the
Pallas kernel `se_tpu.ops.pallas_lstm.pallas_lstm_layer` run with
`interpret=True`, forward and reverse, with a ragged batch and with a
carry. The two halves of the plain twin, `_project_reference` and
`_recur_reference` (the twins of the small fold's two kernels), composed,
against `_scan_forward`, the Pallas kernel and the scan path. The
multi-layer bidirectional `LSTM` module against se_tpu's `LSTM` and against
torch.nn.LSTM on the same weights. Tolerance 1e-5 absolute on
outputs in (-1, 1): fp32 on both sides, sums in another order.
"""

import jax
import numpy as np
import pytest
import torch

from se_tpu.nn.recurrent import LSTM as JLSTM
from se_tpu.nn.recurrent import lstm_layer as j_lstm_layer
from se_tpu.ops.pallas_lstm import _scan_forward, pallas_lstm_layer
from se_tpu.utils.torch_compat import lstm as torch_lstm_to_jax
from se_tpu_torch.nn import LSTM, lstm_layer
from se_tpu_torch.ops import _build
from se_tpu_torch.ops import lstm as ops_lstm
from se_tpu_torch.ops.lstm import lstm_layer_kernel
from torch_kernel_inputs import close, lstm_inputs, to_torch

ATOL = 1e-5


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("bf,t,in_dim,h", [(5, 12, 7, 8), (16, 9, 3, 4)])
def test_lstm_layer_matches_jax_scan_and_pallas(rng, reverse, bf, t, in_dim,
                                                h):
    """bf = 5 is ragged for the Pallas kernel's batch tile of 8."""
    x, wx, wh, b = lstm_inputs(rng, bf, t, in_dim, h)
    got = lstm_layer(*to_torch((x, wx, wh, b)), reverse=reverse)
    assert got.shape == (bf, t, h)
    close([got], [j_lstm_layer(x, wx, wh, b, reverse=reverse)], ATOL)
    close([got], [pallas_lstm_layer(x, wx, wh, b, reverse=reverse,
                                    interpret=True)], ATOL)


def test_lstm_layer_carry_matches_jax(rng):
    """A carry seeds the recurrence and two chained chunks equal one run."""
    x, wx, wh, b = lstm_inputs(rng, 3, 10, 6, 5)
    h0 = (rng.standard_normal((3, 5)) * 0.5).astype(np.float32)
    c0 = (rng.standard_normal((3, 5)) * 0.5).astype(np.float32)
    tx, twx, twh, tb, th0, tc0 = to_torch((x, wx, wh, b, h0, c0))
    got, (h, c) = lstm_layer(tx, twx, twh, tb, carry=(th0, tc0),
                             return_carry=True)
    want, (jh, jc) = j_lstm_layer(x, wx, wh, b, carry=(h0, c0),
                                  return_carry=True)
    close([got, h, c], [want, jh, jc], ATOL)
    first, mid = lstm_layer(tx[:, :4], twx, twh, tb, carry=(th0, tc0),
                            return_carry=True)
    second = lstm_layer(tx[:, 4:], twx, twh, tb, carry=mid)
    close([torch.cat([first, second], 1)], [got], ATOL)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("bf,t,in_dim,h", [(5, 12, 7, 8), (17, 6, 3, 20),
                                           (2, 9, 12, 44)])
def test_project_then_recur_matches_jax(rng, reverse, bf, t, in_dim, h):
    """The split twin: projection for all frames, then the recurrence."""
    x, wx, wh, b = lstm_inputs(rng, bf, t, in_dim, h)
    tx, twx, twh, tb = to_torch((x, wx, wh, b))
    xp = ops_lstm._project_reference(tx, twx, tb)
    assert xp.shape == (bf, t, 4 * h)
    got, (hn, cn) = ops_lstm._recur_reference(xp, twh, reverse)
    close([got], [pallas_lstm_layer(x, wx, wh, b, reverse=reverse,
                                    interpret=True)], ATOL)
    want, (jh, jc) = j_lstm_layer(x, wx, wh, b, reverse=reverse,
                                  return_carry=True)
    close([got, hn, cn], [want, jh, jc], ATOL)
    if not reverse:
        close([got], [_scan_forward(x, wx, wh, b)], ATOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_project_then_recur_carry_matches_jax(rng, reverse):
    x, wx, wh, b = lstm_inputs(rng, 4, 10, 6, 12)
    h0 = (rng.standard_normal((4, 12)) * 0.5).astype(np.float32)
    c0 = (rng.standard_normal((4, 12)) * 0.5).astype(np.float32)
    tx, twx, twh, tb, th0, tc0 = to_torch((x, wx, wh, b, h0, c0))
    got, (h, c) = ops_lstm._recur_reference(
        ops_lstm._project_reference(tx, twx, tb), twh, reverse, th0, tc0)
    want, (jh, jc) = j_lstm_layer(x, wx, wh, b, reverse=reverse,
                                  carry=(h0, c0), return_carry=True)
    close([got, h, c], [want, jh, jc], ATOL)


def test_reverse_carry_is_state_at_frame_zero(rng):
    x, wx, wh, b = to_torch(lstm_inputs(rng, 2, 6, 3, 4))
    ys, (h, _) = lstm_layer_kernel(x, wx, wh, b, reverse=True)
    close([h], [ys[:, 0]], 0)


def _module_weights(rng, in_dim, h, layers, bidirectional):
    model = LSTM(in_dim, h, layers, bidirectional)
    model.reset_parameters(torch.Generator().manual_seed(
        int(rng.integers(1 << 30))))
    return model.eval()


def _prefixed(model):
    """The module's state_dict as a reference checkpoint under prefix m."""
    return {f"m.{k}": v.numpy() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("bidirectional", [False, True])
def test_lstm_module_matches_jax_and_torch(rng, bidirectional):
    in_dim, h, layers = 6, 5, 2
    model = _module_weights(rng, in_dim, h, layers, bidirectional)
    x = (rng.standard_normal((4, 11, in_dim))).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        ref = torch.nn.LSTM(in_dim, h, layers, batch_first=True,
                            bidirectional=bidirectional)
        ref.load_state_dict(model.state_dict())
        want_torch = ref(torch.from_numpy(x))[0]
    params = torch_lstm_to_jax(_prefixed(model), "m", layers, bidirectional)
    j = JLSTM(h, num_layers=layers, bidirectional=bidirectional)
    want_jax = jax.jit(j.apply)({"params": params}, x)
    assert got.shape == (4, 11, h * (2 if bidirectional else 1))
    close([got], [want_torch], ATOL)
    close([got], [want_jax], ATOL)


def test_lstm_module_carry_matches_jax(rng):
    in_dim, h, layers = 4, 6, 2
    model = _module_weights(rng, in_dim, h, layers, False)
    x = (rng.standard_normal((2, 8, in_dim))).astype(np.float32)
    j = JLSTM(h, num_layers=layers)
    params = torch_lstm_to_jax(_prefixed(model), "m", layers)
    carry = LSTM.zero_carry(2, h, layers, device="cpu")
    with torch.no_grad():
        got, new = model(torch.from_numpy(x), carry=carry)
    want, jnew = j.apply({"params": params}, x,
                         carry=JLSTM.zero_carry(2, h, layers))
    close([got], [want], ATOL)
    for (h1, c1), (h2, c2) in zip(new, jnew):
        close([h1, c1], [h2, c2], ATOL)


def test_lstm_module_refuses_bidirectional_carry():
    model = LSTM(3, 4, 1, bidirectional=True)
    with pytest.raises(ValueError, match="uni-directionally"):
        model(torch.zeros(1, 2, 3), carry=LSTM.zero_carry(1, 4, 1,
                                                          device="cpu"))


def test_state_dict_names_are_torch_lstm_names():
    ours = LSTM(5, 3, 2, bidirectional=True).state_dict()
    ref = torch.nn.LSTM(5, 3, 2, batch_first=True,
                        bidirectional=True).state_dict()
    assert {k: v.shape for k, v in ours.items()} == \
        {k: v.shape for k, v in ref.items()}


def test_cpu_lstm_launches_nothing(rng):
    before = dict(_build.LAUNCHES)
    lstm_layer(*to_torch(lstm_inputs(rng, 2, 3, 2, 2)))
    assert dict(_build.LAUNCHES) == before
