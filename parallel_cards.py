#!/usr/bin/env python3
"""Parallelism across every visible NVIDIA GPU, one rank a card (an NCCL
group): chip_smoke.py's phase 10 at that world, its "data" mesh and a
{"data": world / 2, "model": 2} mesh, and `train --data-parallel` on all
cards against the plain `train` on one.

    python3 parallel_cards.py

Needs an even number of cards. It builds the kernels, then runs
`chip_smoke.parallel_phase` with one rank a card: the sharded Uformer and
DPCRN decodes (2 utterances of 4 s a rank) against the one-process decode
on card 0, within 1e-3 x max|ref|, and the sharded DPCRN and FullSubNet
train steps (2 and 4 rows a rank) against the one-process step, by phase
7b's rules; each rank's launches. The ranks then form a {"data": world /
2, "model": 2} mesh (on four cards subgroups of two): Uformer's decode of
the same batch, each rank its kernels on half its data group's rows,
against card 0's one-process decode (phase 4's rule), and one Uformer
train step at 2 rows a data group against card 0's one-process step (7b's
rules). Then, in a temporary directory of
4 x world seeded 1 s noisy / clean pairs, `python -m se_tpu_torch train
--model dpcrn --batch-size 4 x world --data-parallel` (it spawns a rank a
card) beside the same `train` without it (one card): one step each,
whose checkpoints must agree (`chip_smoke.checkpoints_agree`). One JSON
line a result, after the cards' names and power limits; the last line
says ok. Any failure exits non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def cli_data_parallel(world: int, card: str) -> None:
    """`train --data-parallel` on `world` cards against `train` on one."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from se_tpu_torch.data import write_wav

    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(0)
        for d in ("noisy", "clean"):
            os.makedirs(os.path.join(tmp, d))
        ids = [f"u{i}" for i in range(4 * world)]
        for fid in ids:
            c = (rng.standard_normal(cs.SR) * 0.1).astype(np.float32)
            n = (rng.standard_normal(cs.SR) * 0.03).astype(np.float32)
            write_wav(os.path.join(tmp, "clean", f"{fid}.wav"), c, cs.SR)
            write_wav(os.path.join(tmp, "noisy", f"{fid}.wav"), c + n, cs.SR)
        with open(os.path.join(tmp, "files.json"), "w") as f:
            json.dump(ids, f)
        args = ["train", "--model", "dpcrn", "--mix-dir", "noisy",
                "--clean-dir", "clean", "--manifest", "files.json",
                "--batch-size", str(4 * world), "--epochs", "1"]
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        runs = {"train": (args + ["--checkpoint-dir", "CP"],
                          dict(env, CUDA_VISIBLE_DEVICES="0")),
                "train data parallel": (
                    args + ["--checkpoint-dir", "CP_dp", "--data-parallel"],
                    env)}
        procs = {}
        for label, (argv, penv) in runs.items():
            log = open(os.path.join(tmp, f"{label}.log"), "w+")
            procs[label] = (time.perf_counter(), log, subprocess.Popen(
                [sys.executable, "-m", "se_tpu_torch", *argv], cwd=tmp,
                env=penv, stdout=log, stderr=subprocess.STDOUT))
        walls, said = {}, {}
        for label, (t0, log, proc) in procs.items():
            try:
                code = proc.wait(timeout=600)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                code = None
            walls[label] = time.perf_counter() - t0
            log.seek(0)
            said[label] = log.read()[-2000:]
            log.close()
            if code != 0:
                cs.fail(f"cli {label}: exit {code}\n{said[label]}")
        agree = cs.checkpoints_agree(*(
            torch.load(os.path.join(tmp, d, "model.ckpt-0-1"),
                       weights_only=False) for d in ("CP", "CP_dp")))
        cs.emit({"phase": "parallel cli", "world": world,
                 "batch": 4 * world, "wall_s": walls,
                 "data_parallel_vs_plain_train": agree,
                 "data_parallel_said": said["train data parallel"]
                 .strip().splitlines()[:1], "card": card})


def main() -> None:
    import torch

    start = time.perf_counter()
    if not torch.cuda.is_available():
        print("parallel_cards: FAIL: no CUDA device", file=sys.stderr)
        sys.exit(1)
    world = torch.cuda.device_count()
    if world < 2 or world % 2:
        print(f"parallel_cards: FAIL: {world} card(s); this needs an even "
              "number (the model axis pairs them; chip_smoke.py phase 10 "
              "runs two ranks on one)", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from se_tpu_torch.ops import _build

    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = "; ".join(cards)
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    cs.emit({"phase": "build", "seconds": time.perf_counter() - start})
    launches = cs.parallel_phase(torch.device("cuda", 0), card, world)
    cs.emit({"phase": "parallel launches", "launches": launches})
    cs.emit({"phase": "elapsed", "done": "parallel",
             "seconds": time.perf_counter() - start})
    cli_data_parallel(world, card)
    cs.emit({"phase": "elapsed", "done": "parallel cli",
             "seconds": time.perf_counter() - start})
    cs.emit({"ok": True, "cards": world})


if __name__ == "__main__":
    main()
