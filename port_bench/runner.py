"""One run of one cell: set-up, the window, the check of `correct`, and
the result line's fields. `run.py` calls `run_cell` on the card; the
tests call it on the CPU at small sizes."""

from __future__ import annotations

import contextlib
import gc
import statistics
import subprocess
import sys
import time

from port_bench import harness


# end-to-end metric -> (unit, its reading from the run)
END_TO_END = {
    "setup_s": ("s", lambda r: r["setup_s"]),
    "enhance_au_s_per_s": ("au-s/s", lambda r: r["rate"]),
    "train_au_s_per_s": ("au-s/s", lambda r: r["rate"]),
    "enhance_call_p95_ms": ("ms", lambda r: harness.percentile(
        r["window"].durations_ms(), 95)),
}


def power_limit() -> str | None:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout else None


def run_cell(cell: harness.Cell, seed: int, seconds: float, trace: bool,
             device: str, started: float) -> tuple[dict, list, dict]:
    """-> (the result line, [(number, value, limit)], an info line).
    `started`: perf_counter seconds at which the process began."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = device.startswith("cuda")
    program = cell.mode().Program(cell, seed, device)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - started

    if trace and cuda:
        from torch.profiler import ProfilerActivity, profile

        tracing = profile(activities=[ProfilerActivity.CUDA])
    else:
        tracing = contextlib.nullcontext()
    with tracing as prof:
        window = harness.run_window(program.call, seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    shape, items = program.shape, program.items_per_call

    program.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = program.compare()
    checks = [(name, value, cell.limits[name]) for name, value in numbers]
    correct = window.failed == 0 and all(v <= lim for _, v, lim in checks)

    reading = {"setup_s": setup_s, "window": window,
               "rate": len(window.spans) * items / window.seconds}
    metrics = {}
    result = {"correct": correct, "attempted": len(window.spans),
              "failed": window.failed, "metrics": metrics}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    if not trace:
        for m in cell.end_to_end:
            unit, read = END_TO_END[m["name"]]
            metrics[m["name"]] = {"value": read(reading), "unit": unit}
    elif prof is not None:
        record = _record(cell, program, window, prof, shape)
        for m in cell.per_layer:
            value = harness.module("metrics", m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": record.trace.top_ops(),
                               "idle_gaps": record.trace.idle_gaps()}
        lo, hi = record.trace.window
        dev.update(busy_s=record.trace.busy_s(), window_s=(hi - lo) / 1e9)
    result["device"] = dev
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    durations = window.durations_ms()
    info = {"calls": len(durations),
            "call_median_ms": statistics.median(durations),
            "call_p95_ms": harness.percentile(durations, 95),
            "window_s": window.seconds, "setup_s": setup_s,
            "card": power_limit() if cuda else None}
    return result, checks, info


def _record(cell, program, window, prof, shape):
    peaks = harness.peaks()
    flops = cell.flops()
    return harness.Record(
        cell=cell, window=window,
        trace=harness.Trace.from_profile(prof, window),
        model_flops=flops.model_flops(cell.traffic["mode"], cell.config,
                                      program.sd, shape),
        rooflines=flops.rooflines(cell.config, shape,
                                  peaks["tflops"][cell.config["dtype"]]
                                  * 1e12, peaks["hbm_bytes_per_s"]),
        peaks=peaks)


def report(result: dict, checks: list, info: dict, out=sys.stdout,
           err=sys.stderr) -> None:
    """The info line, then the result as the last line of standard
    output; each number compared beside its limit as the last lines of
    standard error."""
    import json

    print(json.dumps({"info": info}), file=out)
    print(json.dumps(result), file=out, flush=True)
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r} "
              f"{'ok' if value <= limit else 'FAILED'}", file=err)
    err.flush()
