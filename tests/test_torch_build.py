"""se_tpu_torch/ops/_build.py `launch` runs an entry on its tensors' one
CUDA device: `launch_device` finds it and refuses tensors that span
devices or lie on none, before anything is built or loaded (so the CPU
reaches it)."""

import pytest
import torch

from se_tpu_torch.ops import _build

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
