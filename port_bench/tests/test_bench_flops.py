"""(c) The operation counts: the closed forms against FlopCounterMode on
the reference, and FullSubNet's sub band against PERF.md's row 6a."""

import pytest
import torch

from port_bench import harness
from port_bench.flops import common, fullsubnet as fsn, uformer as ufm
from port_bench.reference import common as rc, uformer as ref_u

FSN = harness.data_file("configs", "fullsubnet-fp32")
UFM = harness.data_file("configs", "uformer-fp32")


def test_bench_fullsubnet_sub_band_b4():
    """946 GFLOP at B = 4 x 4 s: row 6a's bound, 5.733 ms at 165 TFLOP/s."""
    layers = fsn.lstm_layers(FSN, 4, 64000)
    sub_band = sum(fsn.layer_flops(*c) for c in layers[2:])
    assert sub_band == pytest.approx(5.733e-3 * 165e12, rel=1e-3)
    assert round(sub_band / 1e9) == 946


@pytest.mark.parametrize("rows,t,n_in,h", [(3, 5, 7, 4), (2, 9, 32, 16)])
def test_bench_lstm_layer_closed_form(rows, t, n_in, h):
    x = torch.empty(rows, t, n_in, device="meta")
    w_ih = torch.empty(4 * h, n_in, device="meta")
    w_hh = torch.empty(4 * h, h, device="meta")
    b = torch.empty(4 * h, device="meta")
    got = common.counted(rc.lstm_layer, x, w_ih, w_hh, b, rc.FP32)
    assert got == fsn.layer_flops(rows, t, n_in, h)


def test_bench_fullsubnet_enhance_closed_form():
    """The meta count of a whole enhance call: the four LSTM layer calls
    and the two Linear layers, nothing else."""
    b, n = 2, 64000
    sd = _fullsubnet_sd()
    t = fsn.frames(FSN, n) + FSN["model"]["look_ahead"]
    f, fb, sb = 257, 512, 384
    linears = 2.0 * b * t * fb * f + 2.0 * b * f * t * sb * 2
    lstm = sum(fsn.layer_flops(*c) for c in fsn.lstm_layers(FSN, b, n))
    got = fsn.model_flops("enhance", FSN, sd, {"batch": b, "samples": n})
    assert got == lstm + linears


def test_bench_fullsubnet_train_count():
    """Forward and backward: between twice and three times the forward,
    with drop_band's half of the sub band."""
    b, n = 4, 16000
    sd = _fullsubnet_sd()
    shape = {"batch": b, "samples": n}
    fwd = fsn.model_flops("enhance", FSN, sd, shape)
    train = fsn.model_flops("train", FSN, sd, shape)
    assert 1.0 * fwd < train < 3.0 * fwd


@pytest.mark.parametrize("level", range(12))
def test_bench_unet_level_closed_form(level):
    b, n = 1, 3200
    kind, rows, f_in, f_out, cin, cout = ufm.unet_levels(UFM, b, n)[level]
    t = rows // b
    sd = _uformer_sd()
    m = {k: torch.empty(v.shape, device="meta") for k, v in sd.items()}

    def z(c, f):
        return torch.empty(b, c, f, t, device="meta")

    if kind == "encoder":
        got = common.counted(ref_u._encoder, level, z(cin, f_in),
                             z(cin, f_in), z(cin, f_in), m, rc.FP32)
    else:
        i = level - 6
        got = common.counted(ref_u._decoder, i, z(cin, f_in), z(cin, f_in),
                             z(cin, f_in), m, rc.FP32)
    assert got == ufm.level_flops(kind, rows, f_in, f_out, cin, cout)
    assert f_out == (f_in // 2 if kind == "encoder" else 2 * f_in)


def test_bench_uformer_enhance_count_covers_levels():
    sd = _uformer_sd()
    shape = {"batch": 1, "samples": 16000}
    total = ufm.model_flops("enhance", UFM, sd, shape)
    levels = sum(ufm.level_flops(*lv) for lv in ufm.unet_levels(UFM, 1, 16000))
    assert levels < total < 3 * levels


def _fullsubnet_sd():
    from se_tpu_torch.models.fullsubnet import FullSubNet

    return FullSubNet(device="cpu").state_dict()


def _uformer_sd():
    from se_tpu_torch.models.uformer import Uformer

    return Uformer(device="cpu").state_dict()
