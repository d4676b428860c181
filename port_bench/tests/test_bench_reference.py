"""(b) Each reference agrees with the port's plain CPU path at a small
size, on the benchmark's own weights and inputs."""

import pytest

from port_bench.tests._tiny import CELLS, tiny_cell

# the port's CPU path and the reference compute the same fp32 functions
# in other orders (a matmul DFT against an FFT, folded weights against
# separate convs): agreement to a few fp32 roundings
AGREE = 1e-5


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11])
def test_bench_reference_agrees_with_port_cpu(name, seed):
    cell = tiny_cell(name)
    program = cell.mode().Program(cell, seed, "cpu")
    for i in range(2):
        assert program.call(i) is not False
    numbers = dict(program.compare())
    assert numbers and all(v <= AGREE for v in numbers.values()), numbers
