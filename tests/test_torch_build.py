"""se_tpu_torch/ops/_build.py `launch` runs an entry on its tensors' one
CUDA device: `launch_device` finds it and refuses tensors that span
devices or lie on none, before anything is built or loaded (so the CPU
reaches it). `launch_dtype` gives a launch's one activation dtype: fp32
or bf16, each kernel's variant; mixed dtypes and any other dtype raise,
before anything is built, on meta tensors here. The LSTM has its own
rule (`lstm_dtype`):
the weights pick the variant, x is fp32 or (bf16 weights) bf16, XP and
the carries fp32."""

import pytest
import torch

from se_tpu_torch.ops import _build, attention, decoder, dsconv, encoder, lstm

CUDA0, CUDA1 = torch.device("cuda", 0), torch.device("cuda", 1)


@pytest.mark.parametrize("devices,want", [([CUDA0], CUDA0),
                                          ([CUDA1, CUDA1, CUDA1], CUDA1)])
def test_launch_device_is_the_tensors_device(devices, want):
    assert _build.launch_device(devices) == want


@pytest.mark.parametrize("devices,match", [
    ([CUDA0, CUDA1], "cuda:0, cuda:1"),
    ([CUDA1, torch.device("cpu")], "one CUDA device"),
    ([], "none"),
    ([torch.device("cpu")], "a CUDA device, got cpu"),
    ([torch.device("cuda")], "a CUDA device, got cuda"),
])
def test_launch_device_refuses_spans_and_other_devices(devices, match):
    with pytest.raises(ValueError, match=match):
        _build.launch_device(devices)


def test_launch_refuses_tensors_on_two_devices_before_building(monkeypatch):
    def no_build():
        raise AssertionError("launch built the library")

    monkeypatch.setattr(_build, "library", no_build)
    with pytest.raises(ValueError, match="one CUDA device"):
        _build.launch("se_lstm_layer", torch.zeros(2),
                      torch.zeros(2, device="meta"), 3)


BF16 = torch.bfloat16


@pytest.mark.parametrize("kernel", ["attention", "encoder", "decoder",
                                    "dsconv_pair", "dsconv", "stft"])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_launch_dtype_of_a_launch(kernel, dtype):
    """Every kernel but the LSTM's (`lstm_dtype`) takes fp32 or its bf16
    variant, by its activations' one dtype."""
    x = torch.zeros(2, dtype=dtype)
    assert _build.launch_dtype(kernel, x, x.clone()) == dtype
    assert _build.variant("se_x", dtype) == (
        "se_x_bf16" if dtype == BF16 else "se_x")


@pytest.mark.parametrize("kernel", ["attention", "encoder", "lstm"])
def test_launch_dtype_refuses_mixed_and_other_dtypes(kernel):
    with pytest.raises(TypeError, match="share one dtype"):
        _build.launch_dtype(kernel, torch.zeros(2),
                            torch.zeros(2, dtype=BF16))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _build.launch_dtype(kernel, torch.zeros(2, dtype=torch.float16))


def _meta(*shape, dtype=BF16):
    return torch.zeros(shape, dtype=dtype, device="meta")


def _no_build(monkeypatch):
    def no_build():
        raise AssertionError("launch built the library")

    monkeypatch.setattr(_build, "library", no_build)


@pytest.mark.parametrize("call", [
    lambda: attention._launch(_meta(1, 1, 4, 16),
                              _meta(1, 1, 4, 16, dtype=torch.float32),
                              _meta(1, 1, 4, 16), 0.25, "small_l"),
    lambda: encoder._launch(_meta(1, 2, 8, 16),
                            _meta(1, 2, 8, 8, dtype=torch.float32),
                            (None,) * 5 + (_meta(2, 5, 8, 8),) + (None,) * 4,
                            "tc"),
    lambda: decoder._launch(_meta(1, 2, 4, 16),
                            _meta(1, 2, 4, 8, dtype=torch.float32),
                            (None,) * 6 + (_meta(6, 8, 4),) + (None,) * 5,
                            True, "tc"),
    lambda: dsconv._pair_launch(_meta(1, 2, 4, 16),
                                _meta(1, 2, 4, 8, dtype=torch.float32),
                                (), (), 1, 1, None),
])
def test_bf16_wrappers_refuse_mixed_dtypes(monkeypatch, call):
    _no_build(monkeypatch)
    with pytest.raises(TypeError, match="share one dtype"):
        call()


F32 = torch.float32


@pytest.mark.parametrize("x,w,want", [(F32, F32, F32), (F32, BF16, BF16),
                                      (BF16, BF16, BF16), (None, BF16, BF16)])
def test_lstm_dtype_is_the_weights(x, w, want):
    """The LSTM's own rule: the weights pick the variant; bf16 weights take
    an fp32 or a bf16 x (se_tpu casts the parameters, not the input)."""
    xt = None if x is None else torch.zeros(2, dtype=x)
    weights = (torch.zeros(2, dtype=w), torch.zeros(3, dtype=w))
    assert _build.lstm_dtype(xt, weights, (("xp", torch.zeros(2)),)) == want


@pytest.mark.parametrize("x,weights,fp32,match", [
    (BF16, (F32, F32), None, "x is torch.bfloat16"),
    (torch.float64, (BF16, BF16), None, "x is torch.float64"),
    (F32, (F32, BF16), None, "share one dtype"),
    (torch.float16, (torch.float16,), None, "float32 or bfloat16 weights"),
    (F32, (BF16,), BF16, "h0 is float32 at every variant"),
])
def test_lstm_dtype_refuses_other_mixes(x, weights, fp32, match):
    with pytest.raises(TypeError, match=match):
        _build.lstm_dtype(torch.zeros(2, dtype=x),
                          [torch.zeros(2, dtype=w) for w in weights],
                          (("h0", None if fp32 is None
                            else torch.zeros(2, dtype=fp32)),))


@pytest.mark.parametrize("call,match", [
    (lambda: lstm._project_launch(_meta(2, 3, 4), _meta(4, 8, dtype=F32),
                                  _meta(8, dtype=F32)), "x is"),
    (lambda: lstm._recur_launch(_meta(2, 3, 8), _meta(2, 8), False, None,
                                None), "xp is float32"),
    (lambda: lstm._check_layer(_meta(2, 3, 4), _meta(4, 8), _meta(2, 8),
                               _meta(8, dtype=F32)), "share one dtype"),
    (lambda: lstm._check_layer(_meta(2, 3, 4, dtype=F32), _meta(4, 8),
                               _meta(2, 8), _meta(8), _meta(2, 2)),
     "h0 is float32"),
])
def test_lstm_wrappers_refuse_other_mixes_before_building(monkeypatch, call,
                                                          match):
    """The bf16 LSTM wrappers take bf16 weights with an fp32 or bf16 x and
    fp32 carries; any other mix raises TypeError before anything is built,
    checked or cast."""
    _no_build(monkeypatch)
    with pytest.raises(TypeError, match=match):
        call()
