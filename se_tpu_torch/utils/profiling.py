"""Parameter and FLOP reporting and a profiler trace: the port of
se_tpu/utils/profiling.py (the reference's numParams and ptflops role,
ref SURVEY.md §5 "Tracing / profiling"; MACs table: BASELINE.md Table D).
"""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block, CPU and (where there is one) CUDA
    activity, written to `log_dir` as a Chrome trace
    (`trace.json`; chrome://tracing or Perfetto read it)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def num_params(model: torch.nn.Module) -> int:
    """Total trained parameter count (ref LSTM/Backup.py:94-99
    numParams). Buffers do not count: BN statistics, and the LSTMs'
    `bias_hh`, zero, as se_tpu keeps one combined bias."""
    return int(sum(p.numel() for p in model.parameters()))


def flops_estimate(fn, *args) -> float | None:
    """FLOPs of one call `fn(*args)` by torch.utils.flop_counter: 2 FLOPs
    a multiply-add of its matmuls and convolutions (se_tpu's XLA cost
    analysis counts 1 a multiply-add for dots, so this is twice its number
    for the same net). Work inside the port's CUDA kernels and plain
    elementwise ops are not counted. None where the counter fails."""
    from torch.utils.flop_counter import FlopCounterMode

    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            fn(*args)
    except RuntimeError:  # an op the counter cannot trace
        return None
    return float(counter.get_total_flops())


def summary(name: str, model: torch.nn.Module, fn=None, *args) -> str:
    lines = [f"model: {name}", f"params: {num_params(model) / 1e6:.2f} M"]
    if fn is not None:
        fl = flops_estimate(fn, *args)
        if fl:
            lines.append(f"flops/call: {fl / 1e9:.2f} G")
    return "\n".join(lines)
