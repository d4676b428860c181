"""The readings that the limits of `correct` are set from, in one process:
the program's numbers over many seeds (the lower readings), the
control's (the reference at TF32 in the program's place: the upper
readings), and for a train cell the half-batch fault's.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--fault-seeds 7,8,9] [--seconds 2] \
        [--out readings.jsonl]

Each reading is a JSON line on standard output (and in `--out`), with
the numbers compared and a `detail` of what lies under them. Runs on
the card; `port_bench/tests/test_bench_control.py` calls `reading` on the
CPU at a small size.
"""

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench import harness  # noqa: E402
from port_bench.reference.common import TF32  # noqa: E402


@contextlib.contextmanager
def half_batch_loss():
    """The train step's loss over the first half of its rows alone."""
    from se_tpu_torch.train import losses

    orig = losses.com_mag_mse_loss

    def half(esti, label, frames):
        n = esti.shape[0] // 2
        return orig(esti[:n], label[:n], frames[:n])

    losses.com_mag_mse_loss = half
    try:
        yield
    finally:
        losses.com_mag_mse_loss = orig


def reading(cell, seed, device, seconds, kind):
    import torch

    mode = cell.mode()
    t0 = time.perf_counter()
    fault = half_batch_loss() if kind == "fault" else \
        contextlib.nullcontext()
    with fault:
        program = mode.Program(cell, seed, device)
        harness.run_window(program.call, seconds)
    program.free()
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    detail = {}
    if kind == "control":
        if cell.traffic["mode"] == "train":
            numbers = program.compare(program.reference(TF32), detail)
        else:
            numbers = program.compare([(i, program.reference(i, TF32))
                                       for i, _ in program.kept], detail)
    else:
        numbers = program.compare(detail=detail)
    return {"workload": cell.name, "kind": kind, "seed": seed,
            "numbers": dict(numbers), "detail": detail,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    harness.set_cache_env()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.cell(args.workload)

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    out = open(args.out, "a") if args.out else None
    try:
        for kind, text in (("program", args.seeds),
                           ("control", args.control_seeds),
                           ("fault", args.fault_seeds)):
            for seed in seeds(text):
                line = json.dumps(reading(cell, seed, "cuda", args.seconds,
                                          kind))
                print(line, flush=True)
                if out:
                    print(line, file=out, flush=True)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
