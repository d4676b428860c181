#!/usr/bin/env python3
"""Time the four designs of se_tpu_torch's bf16 LSTM step against each
other on one NVIDIA GPU: one or two m16 tiles a warp, frames launched
plainly or as programmatic dependents (`ops.lstm.bf16_step_design` picks
one a layer), at the layer calls that take the bf16 step (FullSubNet's
sub band at B = 4 and 32, LSTMNet's at B = 256, DPCRN's intra LSTM), with
cuDNN's bf16 LSTM on the same bf16 weights beside them. It is what
`bf16_step_design` is chosen from.

    python3 lstm_bf16_sweep.py

One JSON line a shape: each design's ms (CUDA events: chip_smoke.py
`cuda_ms`, through `ops.lstm._step_launch`, so the packing, the shadow and
the launches count as a caller pays them) and its largest difference from
the picked design's y (the designs sum in the same order: 0), the design
`bf16_step_design` picks, and cuDNN's ms. Then the card's name and power
limit.
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


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("lstm_bf16_sweep: torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    from chip_smoke import cuda_ms, lstm_weights
    from se_tpu_torch.ops import lstm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
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
            lib = torch.nn.LSTM(in_dim, h, batch_first=True).to(dev).to(
                torch.bfloat16)
            lib.weight_ih_l0.copy_(wx.t())
            lib.weight_hh_l0.copy_(wh.t())
            lib.bias_ih_l0.copy_(b)
            lib.bias_hh_l0.zero_()
            lib.flatten_parameters()
            xl = x.to(torch.bfloat16)
            print(json.dumps({
                "shape": f"{label} {bf}x{t_len}x{in_dim}->{h} x "
                         f"{'bf16' if x_bf16 else 'fp32'}",
                "ms": {f"mt={m} programmatic={p}": ms[(m, p)]
                       for m, p in DESIGNS},
                "max_abs_diff": {f"mt={m} programmatic={p}": float(
                    (ys[(m, p)] - ys[pick]).abs().max()) for m, p in DESIGNS},
                "picked": f"mt={pick[0]} programmatic={pick[1]}",
                "cudnn_bf16_ms": cuda_ms(lambda: lib(xl))}), flush=True)
            del ys
            torch.cuda.empty_cache()
    print(json.dumps({"card": smi}))


if __name__ == "__main__":
    main()
