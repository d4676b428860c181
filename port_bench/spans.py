"""The port's own spans in a traced window, on the trace's clock, and the
device's idle time split by them.

While torch.profiler traces a run, the port records its spans
(`se_tpu_torch/utils/profiling.py` `PROFILED`: `(name, start_ns, end_ns,
parent)` on `time.perf_counter_ns()`, the window's clock); the window's
`wall_offset_ns` moves them onto the profiler's. The readers of
`metrics/*_idle_ms.*`, `launch_host_ms.enhance`,
`packs_made_per_call.enhance` and `kernel_launches_per_call.enhance`
read them here. A port that records no spans (one from before the
recorder) gives None, and its metrics are left out.

    python3 port_bench/spans.py --workload <cell> --seed <n> --seconds <s>

runs a cell's program traced on the card and prints one JSON line: the
span metrics, the idle time by the deepest open span (`idle_by_span`),
what no span holds, and for enhance cells the share of calls whose first
host-to-device copy starts inside `enhance.h2d` and whose last
device-to-host copy ends inside `enhance.d2h` (`clock`).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench import harness  # noqa: E402

# the outermost span of a call or step, by mode
ROOTS = {"enhance": "enhance", "train": "train.step"}


def recorded(record) -> list | None:
    """The spans that began inside the window, (name, start, end) in
    wall-clock ns, in start order; None where the port records none, the
    window holds no call's outermost span, or the recorder was full."""
    try:
        from se_tpu_torch.utils import profiling
    except ImportError:
        return None
    spans = getattr(profiling, "PROFILED", None)
    if spans is None or len(spans) >= profiling.PROFILED_MAX:
        return None
    lo, hi = record.window.spans[0][0], record.window.spans[-1][1]
    o = record.window.wall_offset_ns
    out = [(n, a + o, b + o) for n, a, b, _ in spans
           if lo <= a <= hi and b >= a]
    root = ROOTS[record.cell.traffic["mode"]]
    return out if any(n == root for n, _, _ in out) else None


def union(intervals) -> list:
    """Sorted, merged [a, b) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def intersect(xs: list, ys: list) -> list:
    """The intersection of two merged interval lists."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append([a, b])
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def length_ns(xs: list) -> int:
    return sum(b - a for a, b in xs)


def idle(record) -> list:
    """Where the device runs nothing inside the benchmark's spans around
    the calls: the time `Record.host_ms_per_call` sums."""
    lo, hi = record.trace.window
    free, t = [], lo  # the window less the device's busy intervals
    for a, b, _, _ in record.trace.busy():
        if a > t:
            free.append([t, a])
        t = max(t, b)
    if hi > t:
        free.append([t, hi])
    return intersect(union(record.spans_wall()), free)


def covered(spans: list, names) -> list:
    """The merged intervals of the spans named in `names`."""
    return union((a, b) for n, a, b in spans if n in names)


def idle_ms_per_call(record, names, without=()) -> float | None:
    """Device-idle ms a call inside a span named in `names` and inside
    none named in `without`."""
    spans = recorded(record)
    if spans is None:
        return None
    gaps = intersect(idle(record), covered(spans, names))
    ns = length_ns(gaps)
    if without:
        ns -= length_ns(intersect(gaps, covered(spans, without)))
    return ns / record.calls / 1e6


def count_per_call(record, match) -> float | None:
    """Spans a call whose name `match` keeps."""
    spans = recorded(record)
    if spans is None:
        return None
    return sum(1 for n, _, _ in spans if match(n)) / record.calls


def host_ms_per_call(record, name) -> float | None:
    """Host ms a call inside spans named `name` (none nest in another)."""
    spans = recorded(record)
    if spans is None:
        return None
    return sum(b - a for n, a, b in spans if n == name) \
        / record.calls / 1e6


def idle_by_span(record, n: int = 10) -> list | None:
    """[[name, s]]: the window's idle seconds inside the calls by the
    deepest span open ("none" where no span is), the largest first."""
    spans = recorded(record)
    if spans is None:
        return None
    gaps = idle(record)
    by = {}
    i = 0
    for a, b, name in segments(spans):  # in order, disjoint
        while i < len(gaps) and gaps[i][1] <= a:
            i += 1
        k = i
        while k < len(gaps) and gaps[k][0] < b:
            by[name] = by.get(name, 0) \
                + min(b, gaps[k][1]) - max(a, gaps[k][0])
            k += 1
    by["none"] = length_ns(gaps) - sum(by.values())
    return sorted(([k, v / 1e9] for k, v in by.items() if v > 0),
                  key=lambda kv: -kv[1])[:n]


def segments(spans: list) -> list:
    """[a, b, name]: the spans' time cut where the innermost open span
    changes, each piece labelled by that span; no piece where none is
    open. A span of no length holds no time and is left out."""
    cuts = []  # (t, 1 opens / 0 closes, start order, name)
    for k, (n, a, b) in enumerate(spans):
        if b > a:
            cuts.append((a, 1, k, n))
            cuts.append((b, 0, k, n))
    cuts.sort(key=lambda c: c[:3])
    out, stack, t = [], [], None
    for when, opens, k, name in cuts:
        if stack and when > t:
            out.append([t, when, stack[-1][1]])
        if opens:
            stack.append((k, name))
        else:
            stack = [s for s in stack if s[0] != k]
        t = when
    return out


def clock(record, trace_ops) -> dict | None:
    """For enhance cells: the share of calls whose first Memcpy HtoD
    starts inside the call's `enhance.h2d` span and whose last Memcpy
    DtoH ends inside its `enhance.d2h` span, and the worst distance
    outside, in µs."""
    spans = recorded(record)
    if spans is None or record.cell.traffic["mode"] != "enhance":
        return None
    h2d = [(a, b) for n, a, b in spans if n == "enhance.h2d"]
    d2h = [(a, b) for n, a, b in spans if n == "enhance.d2h"]
    ups = [o[1] for o in trace_ops if "HtoD" in o[0]]
    downs = [o[2] for o in trace_ops if "DtoH" in o[0]]
    calls = record.spans_wall()
    inside = near = 0
    worst = 0
    for lo, hi in calls:
        up = [t for t in ups if lo <= t < hi]
        down = [t for t in downs if lo < t <= hi]
        up_span = [s for s in h2d if lo <= s[0] < hi]
        down_span = [s for s in d2h if lo <= s[0] < hi]
        if not (up and down and up_span and down_span):
            continue
        (ua, ub), (da, db) = up_span[0], down_span[-1]
        off = max(ua - up[0], up[0] - ub, da - down[-1], down[-1] - db, 0)
        worst = max(worst, off)
        inside += off == 0
        near += off <= 50_000
    return {"calls": len(calls), "inside_share": inside / len(calls),
            "within_50us_share": near / len(calls),
            "worst_outside_us": worst / 1e3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    harness.set_cache_env()
    import torch
    from torch.profiler import ProfilerActivity, profile

    from port_bench import runner
    from se_tpu_torch.utils import profiling

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.cell(args.workload)
    program = cell.mode().Program(cell, args.seed, "cuda")
    torch.cuda.synchronize()
    profiling.PROFILED.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        window = harness.run_window(program.call, args.seconds)
    record = runner._record(cell, program, window, prof, program.shape)
    out = {"cell": cell.name, "seed": args.seed, "calls": record.calls,
           "host_ms_per_call": record.host_ms_per_call(),
           "spans": len(profiling.PROFILED)}
    for m in cell.per_layer:
        out[m["name"]] = harness.module("metrics", m["name"]).read(record)
    by = idle_by_span(record, n=1000)
    out["idle_by_span"] = by
    out["none_ms_per_call"] = None if by is None else \
        dict(by).get("none", 0.0) * 1e3 / record.calls
    out["clock"] = clock(record, record.trace.ops)
    out["call_median_ms"] = statistics.median(window.durations_ms())
    out["card"] = runner.power_limit()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
