"""Small sizes at which the tests drive the benchmark on the CPU: the
published widths, two utterances of 0.3 s."""

from __future__ import annotations

import time

from port_bench import harness

TINY = {
    "enhance": {"batch": 2, "utterance_s": 0.3, "pool": 2, "warmup_calls": 1,
                "check_calls": 2, "ref_block": 1},
    "train": {"batch": 2, "utterance_s": 0.3, "pool": 4},
}
CELLS = ("fullsubnet-enhance-b32", "uformer-enhance-b64",
         "fullsubnet-train-b32")


def tiny_cell(name: str) -> harness.Cell:
    cell = harness.cell(name)
    cell.traffic.update(TINY[cell.traffic["mode"]])
    return cell


def run_tiny(name: str, seed: int = 2 ** 31 + 3, seconds: float = 0.5):
    from port_bench import runner

    return runner.run_cell(tiny_cell(name), seed, seconds, False, "cpu",
                           time.perf_counter())
