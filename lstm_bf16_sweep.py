#!/usr/bin/env python3
"""Time the designs of se_tpu_torch's bf16 LSTM kernels against each other
on one NVIDIA GPU. It is what `ops.lstm.bf16_step_design` and
`ops.lstm.recur_bf16_designs` are chosen from.

    python3 lstm_bf16_sweep.py [step|recur]

`step` (the default): the four designs of the bf16 large-fold step, one
or two m16 tiles a warp, frames launched plainly or as programmatic
dependents, at the layer calls that take it (FullSubNet's sub band at
B = 4 and 32, LSTMNet's at B = 256, DPCRN's intra LSTM), with cuDNN's bf16
LSTM on the same bf16 weights beside them. One JSON line a shape: each
design's ms (CUDA events: chip_smoke.py `cuda_ms`, through
`ops.lstm._step_launch`, so the packing, the shadow and the launches count
as a caller pays them) and its largest difference from the picked design's
y (the designs sum in the same order: 0), the design `bf16_step_design`
picks, and cuDNN's ms.

`recur`: the bf16 small fold's recurrence (`lstm_recur_bf16`) in each plan
`persistent_plan` makes of a design (units a block, warps over K, most
blocks an SM), at the small-fold calls of LSTMNet and CRN (H = 1024),
GCRN (also B = 256: four row chunks a block) and FullSubNet's full band
(512), DPCRN's inter LSTM and DCCRN (128) at B = 4 and 32, with the fp32
recurrence (`lstm_recur_persistent`) and cuDNN's bf16 LSTM layer beside
them. One JSON line a shape: each plan's
grid, ms (CUDA events, through `ops.lstm._recur_launch`) and device time
of the recurrence kernel alone (torch.profiler: chip_smoke.py
`device_ms`) a call and a frame, its largest difference from the picked
design's y (the warps split K in other places: fp32 round-off), and the
plan `persistent_plan` picks of `recur_bf16_designs`.

Then the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# (label, Bf, T, In, H, x bf16)
SHAPES = (("FullSubNet sub band 1", 1028, 253, 32, 384, False),
          ("FullSubNet sub band 2", 1028, 253, 384, 384, False),
          ("FullSubNet sub band 1 B=32", 8224, 253, 32, 384, False),
          ("FullSubNet sub band 2 B=32", 8224, 253, 384, 384, False),
          ("LSTMNet lstm1 B=256", 256, 401, 161, 1024, True),
          ("LSTMNet lstm2 B=256", 256, 401, 1024, 1024, False),
          ("DPCRN intra B=32", 12832, 4, 128, 64, False))
DESIGNS = ((1, False), (1, True), (2, False), (2, True))
# (label, Bf, T, In, H) of the bf16 small fold's calls
RECUR_SHAPES = (("LSTMNet / CRN lstm2", 4, 401, 1024, 1024),
                ("LSTMNet / CRN lstm2 B=32", 32, 401, 1024, 1024),
                ("GCRN glstm", 4, 401, 512, 512),
                ("GCRN glstm B=32", 32, 401, 512, 512),
                ("GCRN glstm B=256", 256, 401, 512, 512),
                ("FullSubNet full band", 4, 253, 257, 512),
                ("DPCRN inter", 16, 401, 128, 128),
                ("DPCRN inter B=32", 128, 401, 128, 128),
                ("DCCRN clstm", 8, 501, 128, 128))
# (units a block, warps, most blocks an SM)
RECUR_DESIGNS = ((16, 8, 1), (16, 8, 2), (16, 4, 1), (16, 4, 4),
                 (8, 4, 1), (8, 4, 4))


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def sweep_step(dev, gen) -> None:
    import torch

    from chip_smoke import cuda_ms, cudnn_lstm_bf16, lstm_weights
    from se_tpu_torch.ops import lstm

    for label, bf, t_len, in_dim, h, x_bf16 in SHAPES:
        wx, wh, b = (w.to(torch.bfloat16)
                     for w in lstm_weights(gen, dev, in_dim, h))
        x = torch.randn(bf, t_len, in_dim, generator=gen).to(dev)
        x = x.to(torch.bfloat16) if x_bf16 else x
        pick = lstm.bf16_step_design(in_dim, h)
        ys = {d: lstm._step_launch(x, wx, wh, b, False, None, None,
                                   design=d)[0] for d in DESIGNS}
        ms = {d: cuda_ms(lambda d=d: lstm._step_launch(
            x, wx, wh, b, False, None, None, design=d)) for d in DESIGNS}
        print(json.dumps({
            "shape": f"{label} {bf}x{t_len}x{in_dim}->{h} x "
                     f"{'bf16' if x_bf16 else 'fp32'}",
            "ms": {f"mt={m} programmatic={p}": ms[(m, p)]
                   for m, p in DESIGNS},
            "max_abs_diff": {f"mt={m} programmatic={p}": float(
                (ys[(m, p)] - ys[pick]).abs().max()) for m, p in DESIGNS},
            "picked": f"mt={pick[0]} programmatic={pick[1]}",
            "cudnn_bf16_ms": cuda_ms(cudnn_lstm_bf16(
                dev, in_dim, h, wx, wh, b, bf, t_len))}),
            flush=True)
        del ys
        torch.cuda.empty_cache()


def sweep_recur(dev, gen) -> None:
    import torch

    from chip_smoke import (
        cuda_ms, cudnn_lstm_bf16, device_ms, lstm_weights,
    )
    from se_tpu_torch.ops import lstm

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def kernel_ms(fn, name: str) -> float:
        return sum(t for k, t in device_ms(fn).items() if name in k)

    for label, bf, t_len, in_dim, h in RECUR_SHAPES:
        wx, wh, b = (w.to(torch.bfloat16)
                     for w in lstm_weights(gen, dev, in_dim, h))
        xp = torch.randn(bf, t_len, 4 * h, generator=gen).to(dev)
        picked = lstm.persistent_plan(bf, h, sms, torch.bfloat16)
        want = lstm._recur_launch(xp, wh, False, None, None)[0]
        plans, rows = set(), {}
        for design in RECUR_DESIGNS:
            plan = lstm.persistent_plan(bf, h, sms, torch.bfloat16, design)
            # one run a grid: the blocks an SM a plan assumes launch nothing
            grid = plan and plan._replace(smem=0, blocks_sm=0)
            if plan is None or grid in plans:
                continue
            plans.add(grid)

            def run(design=design):
                return lstm._recur_launch(xp, wh, False, None, None, design)

            dev_ms = kernel_ms(run, "lstm_recur_bf16")
            rows["units={} warps={} blocks_sm<={}".format(*design)] = {
                "plan": plan._asdict(), "blocks": plan.blocks,
                "ms": cuda_ms(run, reps=2), "device_ms": dev_ms,
                "device_us_per_frame": 1e3 * dev_ms / t_len,
                "max_abs_diff": float((run()[0] - want).abs().max()),
                "picked": plan == picked}
        whf = wh.float()
        fp32_ms = kernel_ms(lambda: lstm.lstm_recur(xp, whf),
                            "lstm_recur_persistent")
        print(json.dumps({
            "shape": f"{label} {bf}x{t_len}x{in_dim}->{h}",
            "designs": rows, "picked": picked._asdict(),
            "fp32_device_ms": fp32_ms,
            "fp32_device_us_per_frame": 1e3 * fp32_ms / t_len,
            "cudnn_bf16_layer_ms": cuda_ms(cudnn_lstm_bf16(
                dev, in_dim, h, wx, wh, b, bf, t_len), reps=2)}), flush=True)
        torch.cuda.empty_cache()


def main() -> None:
    import torch

    mode = sys.argv[1] if len(sys.argv) > 1 else "step"
    if mode not in ("step", "recur"):
        sys.exit(f"lstm_bf16_sweep: no sweep {mode!r}: step, recur")
    if not torch.cuda.is_available():
        sys.exit("lstm_bf16_sweep: torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        (sweep_step if mode == "step" else sweep_recur)(dev, gen)
    print(json.dumps({"card": _card()}))


if __name__ == "__main__":
    main()
