#!/usr/bin/env python3
"""Time the two designs of se_tpu_torch's LSTM layer against each other
over the sequence length, on one NVIDIA GPU: the tensor-core step
(`ops.lstm.lstm_step`, a launch a frame) and the small fold's projection
plus persistent recurrence (`lstm_project` then `lstm_recur`), at the
small-fold layer shapes of the seven families' B = 4 (and DPCRN's B = 5)
forward. It is what `ops.lstm.SHORT_T` is chosen from.

    python3 lstm_dispatch_sweep.py

One JSON line per (shape, T): both designs' ms (CUDA events, median of 5
rounds of 10 calls after warm-up, through the wrappers, so the host's
packing and launches count as a caller pays them), each design's error
against the plain twin, and the design `step_variant` picks. Then one line
a shape with the shortest swept T from which the persistent design is
faster at every longer T, and the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T_SWEEP = (2, 4, 8, 12, 16, 24, 32, 64, 128)
# (label, Bf, In, H): the small-fold layer calls of a B = 4 forward
SHAPES = (("DPCRN intra B=4", 1604, 128, 64),
          ("DPCRN intra B=5", 2005, 128, 64),
          ("DPCRN inter", 16, 128, 128),
          ("DCCRN clstm0", 8, 512, 128),
          ("FullSubNet full band", 4, 512, 512),
          ("GCRN glstm", 4, 512, 512),
          ("LSTMNet / CRN", 4, 1024, 1024))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("lstm_dispatch_sweep: torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    from chip_smoke import cuda_ms, lstm_weights
    from se_tpu_torch.ops import lstm

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(3)

    def persistent(x, wx, wh, b):
        return lstm.lstm_recur(lstm.lstm_project(x, wx, b), wh)

    for label, bf, in_dim, h in SHAPES:
        wx, wh, b = lstm_weights(gen, dev, in_dim, h)
        faster = []
        for t_len in T_SWEEP:
            x = torch.randn(bf, t_len, in_dim, generator=gen).to(dev)
            with torch.no_grad():
                want, _ = lstm._reference(x, wx, wh, b)
                errs = {}
                for name, fn in (("tensor_core", lstm.lstm_step),
                                 ("persistent", persistent)):
                    got, _ = fn(x, wx, wh, b)
                    errs[name] = float((got - want).abs().max())
                ms = {name: cuda_ms(lambda fn=fn: fn(x, wx, wh, b))
                      for name, fn in (("tensor_core", lstm.lstm_step),
                                       ("persistent", persistent))}
            faster.append(ms["persistent"] < ms["tensor_core"])
            print(json.dumps({
                "case": f"{label} {bf}x{t_len}x{in_dim}->{h}", "T": t_len,
                "tensor_core_ms": ms["tensor_core"],
                "persistent_ms": ms["persistent"],
                "tensor_core_err": errs["tensor_core"],
                "persistent_err": errs["persistent"],
                "step_variant": lstm.step_variant(bf, t_len, h, sms)}),
                flush=True)
        cross = None
        for i in range(len(T_SWEEP) - 1, -1, -1):
            if not faster[i]:
                break
            cross = T_SWEEP[i]
        print(json.dumps({"shape": label, "persistent_faster_from_T": cross,
                          "short_t": lstm.SHORT_T}), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
