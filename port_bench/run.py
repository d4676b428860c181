"""Run one cell of the port's benchmark once and print its result.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the port (`se_tpu_torch`). The
cell's configuration, traffic and limits are the files that
`BENCHMARK.json` names. Set-up builds the port's system from the seed and
warms the cell's shapes; the window then runs calls or steps back to
back for `--seconds`; with `--trace 1` under torch.profiler (the
device's activity), whose reduction gives the per-layer metrics. The
last line of standard output is the result (JSON); the numbers compared
for `correct`, each beside its limit, are the last lines of standard
error. Exits 3 without a CUDA device for the cell, 4 if JAX or the JAX
package was loaded.
"""

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench import harness, runner  # noqa: E402


def process_age_s() -> float:
    """Seconds since this process began (Linux's /proc; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        import os

        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def main(argv=None) -> int:
    started = _STARTED - process_age_s()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.set_cache_env()
    cell = harness.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result, checks, info = runner.run_cell(cell, args.seed, args.seconds,
                                           bool(args.trace), "cuda",
                                           started)
    found = harness.loaded_forbidden()
    if found:
        print(f"modules that a run may not load were loaded: {found}",
              file=sys.stderr)
        return 4
    runner.report(result, checks, info)
    return 0


if __name__ == "__main__":
    sys.exit(main())
