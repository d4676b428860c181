"""Parameter and FLOP reporting, the port's span recorder and a profiler
trace: the port of se_tpu/utils/profiling.py (the reference's numParams
and ptflops role, ref SURVEY.md §5 "Tracing / profiling"; MACs table:
BASELINE.md Table D).

Spans. `span(name)` marks a stretch of the host's work at a layer
boundary: `enhance` and its `enhance.gain`, `.h2d`, `.model`, `.d2h`,
`.ungain` (eval/enhance.py), `train.step` and its `train.forward` (with
`train.prep`), `train.backward`, `train.optimizer` (train/trainer.py),
`autograd.kernel` and `autograd.twin` (ops/_autograd.py), `kernel.launch`
(ops/_build.py `launch`) and each weight pack, named by its function
(`pack_weights`, ...; ops/_build.py `packs`). A span records
`(name, start_ns, end_ns, parent)`: `time.perf_counter_ns()` at its ends
and the index of the span open around it (-1 for none), in start order.
It reads no device state and waits for nothing.

A span records only inside `recording()`, which yields the list, or
while torch.profiler traces the process, into `PROFILED` (at most
`PROFILED_MAX` spans; the caller clears it), so a device trace always
has the host's spans beside it. Otherwise `span` returns one shared null
context after a flag check. Spans nest by time, not by thread: a span's
parent is the innermost span open when it starts, on any thread, and a
span leaves the open ones by its own index. So autograd, which runs a CUDA
backward on its own thread while the caller waits inside
`loss.backward()`, nests the twins' spans under `train.backward`, and
spans from threads that run at once keep their own ends.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time

import torch
import torch.autograd.profiler as _torch_profiler

PROFILED_MAX = 1 << 18


class _Sink:
    """Where spans go: the spans, the indices of the open ones
    (innermost last), the most it keeps (None: no bound) and the lock
    that gives each span its own index."""

    __slots__ = ("spans", "open", "limit", "lock")

    def __init__(self, limit: int | None = None):
        self.spans: list = []
        self.open: list = []
        self.limit = limit
        self.lock = threading.Lock()


_PROFILED = _Sink(PROFILED_MAX)
PROFILED = _PROFILED.spans
_recording: _Sink | None = None
_NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "sink", "index")

    def __init__(self, name: str, sink: _Sink):
        self.name, self.sink = name, sink

    def __enter__(self):
        sink = self.sink
        with sink.lock:
            self.index = len(sink.spans)
            if sink.limit is not None and self.index >= sink.limit:
                self.sink = None
                return self
            parent = sink.open[-1] if sink.open else -1
            sink.open.append(self.index)
            sink.spans.append((self.name, time.perf_counter_ns(), -1,
                               parent))
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        sink = self.sink
        if sink is not None:
            sink.open.remove(self.index)
            name, start, _, parent = sink.spans[self.index]
            sink.spans[self.index] = (name, start, end, parent)
        return False


def span(name: str):
    """A context manager that records the block as span `name` while
    the recorder is on (see the module's docstring); else the shared
    null context."""
    if _recording is not None:
        return _Span(name, _recording)
    if getattr(_torch_profiler, "_is_profiler_enabled", False):
        return _Span(name, _PROFILED)
    return _NULL


@contextlib.contextmanager
def recording():
    """Record every span inside the block, also while torch.profiler
    traces; yields the list of `(name, start_ns, end_ns, parent)`."""
    global _recording
    outer, _recording = _recording, _Sink()
    try:
        yield _recording.spans
    finally:
        _recording = outer


def trace_events(spans: list, base_ns: int, pid: int) -> list:
    """`spans` as Chrome trace complete events ("ph": "X", µs) on the
    profiler's clock: the wall clock (the profiler's events' own) less
    `base_ns`, on one track of process `pid` named "se_tpu_torch spans".
    Spans still open are left out."""
    offset = time.time_ns() - time.perf_counter_ns() - base_ns
    events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
               "args": {"name": "se_tpu_torch spans"}}]
    for name, start, end, parent in spans:
        if end >= 0:
            events.append({"ph": "X", "cat": "se_tpu_torch", "name": name,
                           "pid": pid, "tid": 0,
                           "ts": (start + offset) / 1e3,
                           "dur": (end - start) / 1e3,
                           "args": {"parent": parent}})
    return events


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block, CPU and (where there is one) CUDA
    activity, with the span recorder on, written to `log_dir` as one
    Chrome trace (`trace.json`; chrome://tracing or Perfetto read it):
    the spans on a track of their own above the profiler's events."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with recording() as spans, profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"] += trace_events(
        spans, int(doc.get("baseTimeNanoseconds", 0)), os.getpid())
    with open(path, "w") as f:
        json.dump(doc, f)


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
