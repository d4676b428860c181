#!/usr/bin/env python3
"""Time the bf16 ring's depth and residency choices of se_tpu_torch's two
bf16 tensor-core kernels on one NVIDIA GPU: the decoder level
(csrc/decoder.cu `BF_STAGES`, `BF_BLOCKS`) and the DSConv pair stage
(csrc/dsconv.cu `PRE_BF_STAGES`, `POST_BF_STAGES`, `POST_BF_BLOCKS`). It is
what those constants are chosen from.

    python3 bf16_ring_sweep.py [decoder|pair]

`decoder` (the default) varies chiefly the decoder's constants, `pair`
the pair stage's; every variant times both kernels. Each variant runs in
a process of its own (`--variant sweep i`): the sources copied under
se_tpu_torch/_build/sweep/ with the variant's constants written in,
built and loaded from there; the shipped constants run first and last.
One JSON line a variant: the constants, each new kernel's registers,
spill bytes, shared bytes and blocks an SM (chip_smoke.py
`kernel_resources`), and the ms of chip_smoke.py phase 3's decoder_bf16
and dsconv_pair_bf16 cases, CUDA events (`cuda_ms`, median of 5) and the
device time by kernel name (`device_ms`, torch.profiler): summed over
Uformer's B = 4 forward (the rows' sums) and at B = 32, each case's
largest distance from its bf16 twin beside. Then the card's name and
power limit.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHIPPED = ("shipped", {})
# sweep: (label, {constant: value}) a variant, the shipped constants first
# and last
SWEEPS = {
    "decoder": (SHIPPED,
                ("decoder 5 stages; pre 3 stages",
                 {"BF_STAGES": 5, "PRE_BF_STAGES": 3}),
                ("decoder 3 stages, 6 blocks; post 3 stages, 3 blocks",
                 {"BF_STAGES": 3, "BF_BLOCKS": 6, "POST_BF_STAGES": 3,
                  "POST_BF_BLOCKS": 3}),
                ("decoder 6 stages, 4 blocks",
                 {"BF_STAGES": 6, "BF_BLOCKS": 4}),
                SHIPPED),
    "pair": (SHIPPED,
             ("post 3 stages, 3 blocks",
              {"POST_BF_STAGES": 3, "POST_BF_BLOCKS": 3}),
             ("post 4 stages, 2 blocks; pre 8 stages",
              {"POST_BF_STAGES": 4, "POST_BF_BLOCKS": 2,
               "PRE_BF_STAGES": 8}),
             ("post 6 stages, 2 blocks",
              {"POST_BF_STAGES": 6, "POST_BF_BLOCKS": 2}),
             SHIPPED),
}


def variant_sources(i: int, consts: dict) -> Path:
    """csrc with `consts` written into its `constexpr int NAME = v;`
    lines, under se_tpu_torch/_build/sweep/v<i>/csrc."""
    dst = ROOT / "se_tpu_torch" / "_build" / "sweep" / f"v{i}" / "csrc"
    shutil.rmtree(dst.parent, ignore_errors=True)
    shutil.copytree(ROOT / "se_tpu_torch" / "csrc", dst)
    for name, value in consts.items():
        hits = 0
        for src in dst.glob("*.cu"):
            text, n = re.subn(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {value};",
                              src.read_text())
            src.write_text(text)
            hits += n
        if hits != 1:
            sys.exit(f"bf16_ring_sweep: {name} found {hits} times")
    return dst


def run_variant(sweep: str, i: int) -> None:
    import torch

    sys.path.insert(0, str(ROOT))
    from chip_smoke import (
        _decoder_kernel, _decoder_twin, _pair_kernel, _pair_twin,
        bf16_decoder_cases, bf16_pair_cases, cuda_ms, device_ms,
        kernel_resources,
    )
    from se_tpu_torch.ops import _build
    from se_tpu_torch.ops._dtype import bf16_compare

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    label, consts = SWEEPS[sweep][i]
    _build.CSRC = variant_sources(i, consts)
    _build.BUILD_DIR = _build.CSRC.parent
    resources = kernel_resources(_build.library())
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    out = {"sweep": sweep, "variant": label, "constants": consts,
           "resources": resources}
    for kind, cases, kernel, twin in (
            ("decoder_bf16", bf16_decoder_cases, _decoder_kernel,
             _decoder_twin),
            ("dsconv_pair_bf16", bf16_pair_cases, _pair_kernel, _pair_twin)):
        row = {"ms_b4": 0.0, "ms_b32": 0.0, "max_abs_err": 0.0, "ok": True,
               "device_ms_b4": {}, "device_ms_b32": {}, "cases": {}}
        for case, args, _, _, _, in_row in cases(gen, dev):
            with torch.no_grad():
                check = bf16_compare(kernel(*args), twin(*args))
                ms = cuda_ms(lambda: kernel(*args))
                split = device_ms(lambda: kernel(*args))
            row["max_abs_err"] = max(row["max_abs_err"], check.max_abs_err)
            row["ok"] = row["ok"] and check.ok
            b = "b4" if in_row else "b32"
            row[f"ms_{b}"] += ms
            for name, t in split.items():
                row[f"device_ms_{b}"][name] = \
                    row[f"device_ms_{b}"].get(name, 0.0) + t
            row["cases"][case] = ms
        out[kind] = row
    print(json.dumps(out), flush=True)


def main() -> None:
    if "--variant" in sys.argv:
        at = sys.argv.index("--variant")
        run_variant(sys.argv[at + 1], int(sys.argv[at + 2]))
        return
    sweep = sys.argv[1] if len(sys.argv) > 1 else "decoder"
    if sweep not in SWEEPS:
        sys.exit(f"bf16_ring_sweep: no sweep {sweep!r}: {', '.join(SWEEPS)}")
    import torch

    if not torch.cuda.is_available():
        sys.exit("bf16_ring_sweep: torch.cuda.is_available() is false")
    for i in range(len(SWEEPS[sweep])):
        subprocess.run([sys.executable, __file__, "--variant", sweep,
                        str(i)], check=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)

if __name__ == "__main__":
    main()
