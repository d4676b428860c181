#!/usr/bin/env python3
"""Time se_tpu_torch's train step in two checkouts of this repository in
turns on one NVIDIA GPU, so that a change's effect on the train path can
be told from the host's drift between calls.

    python3 train_speed_ab.py PARENT_DIR CHANGE_DIR

The turns run parent, change, change, parent. Each turn is one process
started in its checkout, on that checkout's se_tpu_torch (its kernels
built there on first use) and chip_smoke.py: each of FAMILIES (three
whose backward runs the LSTM twin, and ResNetV2, which has no LSTM, as a
control) one step at B = 32 x 4 s as chip_smoke.py's phase 7d makes it
(`trainer_step`; DeepXi `deepxi_step`, its driver's step), fp32, with
chip_smoke.py's settings (no TF32), 2 warm-up steps and then 5 timed,
each to its loss's `.item()`. One JSON line a turn and family: the median
audio-seconds/s, the least and the most, each timed step's ms; then the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

WARM, TIMED = 2, 5
FAMILIES = ("dpcrn", "deepxi_reslstm", "deepxi", "fullsubnet")

TURN = r"""
import json, statistics, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from se_tpu_torch.ops import _build

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
_build.library()
label, warm, timed = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
for name in sys.argv[4:]:
    make = cs.deepxi_step if name in cs.DEEPXI_NETWORK else cs.trainer_step
    step = make(name, torch.device("cuda"))
    times = []
    for i in range(warm + timed):
        t0 = time.perf_counter()
        step().item()
        if i >= warm:
            times.append(time.perf_counter() - t0)
    rates = [cs.TRAIN_BATCH * cs.SECONDS / t for t in times]
    print(json.dumps({"tree": label, "family": name,
                      "batch": cs.TRAIN_BATCH, "warm_up": warm,
                      "timed": timed,
                      "audio_s_per_s": statistics.median(rates),
                      "min": min(rates), "max": max(rates),
                      "step_ms": [t * 1e3 for t in times]}), flush=True)
    del step
    torch.cuda.empty_cache()
"""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path)
    args = ap.parse_args()
    trees = {"parent": args.parent.resolve(), "change": args.change.resolve()}
    for root in trees.values():
        if not (root / "chip_smoke.py").is_file():
            sys.exit(f"train_speed_ab: no chip_smoke.py in {root}")
    for label in ("parent", "change", "change", "parent"):
        done = subprocess.run(
            [sys.executable, "-c", TURN, label, str(WARM), str(TIMED),
             *FAMILIES], cwd=trees[label], timeout=1800)
        if done.returncode:
            sys.exit(f"train_speed_ab: the {label} turn exited "
                     f"{done.returncode}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
