"""The control of `correct`: the reference in the program's place at
TF32, the nearest precision below the configuration's float32 with TF32
off, comes out not correct. Here at a small size on the CPU (TF32 is
emulated by rounding every product's operands, so it runs anywhere); on
the card at each cell's own size on three seeds (marked `cuda`)."""

import pytest

from port_bench import harness
from port_bench.calibrate import reading
from port_bench.tests._tiny import CELLS, tiny_cell


@pytest.mark.parametrize("name", CELLS)
def test_bench_control_fails_at_small_size(name):
    cell = tiny_cell(name)
    got = reading(cell, 2 ** 31 + 29, "cpu", 0.2, "control")["numbers"]
    assert any(v > cell.limits[k] for k, v in got.items()), got


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_bench_control_fails_on_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control at the cell's size")
    cell = harness.cell(name)
    for seed in (101, 2 ** 31 + 7, 4_000_000_019):
        got = reading(cell, seed, "cuda", 2.0, "control")["numbers"]
        assert any(v > cell.limits[k] for k, v in got.items()), (seed, got)
