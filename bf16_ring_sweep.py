#!/usr/bin/env python3
"""Time the bf16 ring's depth, residency and block choices of se_tpu_torch's
bf16 tensor-core kernels on one NVIDIA GPU: the decoder level
(csrc/decoder.cu `BF_STAGES`, `BF_BLOCKS`), the DSConv pair stage
(csrc/dsconv.cu `PRE_BF_STAGES`, `POST_BF_STAGES`, `POST_BF_BLOCKS`), the
encoder level (csrc/encoder.cu `ENC_BF_STAGES`, `ENC_BF_BLOCKS`), the
flash attention (csrc/attention.cu `ATT_BF_STAGES`) and the bf16 LSTM's
small fold (csrc/lstm.cu: the projection's `PROJ_STAGES`, `PROJ_NT`,
`PROJ_BLOCKS`, its ring depth, its column tile of 16 PROJ_NT and its
register cap; every variant also times the recurrence) and the single
DSConv block in bf16, which shares the pair's three constants. It is what
those constants are chosen from.

    python3 bf16_ring_sweep.py [decoder|pair|encoder|attention|lstm|block]

`decoder` (the default) varies chiefly the decoder's constants, `pair`
the pair stage's, and every variant of the two times both kernels;
`encoder`, `attention`, `lstm` and `block` time their own kernels
(`block`: the pair's constants, chip_smoke.py's dsconv_bf16 cases at B =
4 and 32), `attention`
also the complex T-attention's shape at L = 640 to 2048 (a long utterance
decoded in one call). Each variant runs in a process of its own
(`--variant sweep i`): the sources copied under se_tpu_torch/_build/sweep/ with the variant's
constants written in (a name with a dot sets that attribute of
se_tpu_torch.ops.<module> instead), built and loaded from there; the
shipped constants run first and last. One JSON line a variant: the
constants, each bf16 ring kernel's registers, spill bytes, shared bytes
and blocks an SM (chip_smoke.py `kernel_resources`), and the ms of
chip_smoke.py phase 3's cases of the swept kernels, CUDA events
(`cuda_ms`, median of 5) and the device time by kernel name (`device_ms`,
torch.profiler): summed over Uformer's B = 4 forward (the rows' sums), at
B = 32 and (attention) at the long L, each case's largest distance from
its bf16 twin beside. Then the card's name and power limit.
"""

from __future__ import annotations

import importlib
import itertools
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
    "encoder": (SHIPPED,
                ("5 stages, 5 blocks",
                 {"ENC_BF_STAGES": 5, "ENC_BF_BLOCKS": 5}),
                ("3 stages, 6 blocks",
                 {"ENC_BF_STAGES": 3, "ENC_BF_BLOCKS": 6}),
                ("6 stages, 4 blocks",
                 {"ENC_BF_STAGES": 6, "ENC_BF_BLOCKS": 4}),
                SHIPPED),
    "attention": (SHIPPED,
                  ("ring 2 stages", {"ATT_BF_STAGES": 2}),
                  ("ring 6 stages", {"ATT_BF_STAGES": 6}),
                  SHIPPED),
    "block": (SHIPPED,
              ("post 3 stages, 3 blocks",
               {"POST_BF_STAGES": 3, "POST_BF_BLOCKS": 3}),
              ("post 4 stages, 2 blocks; pre 8 stages",
               {"POST_BF_STAGES": 4, "POST_BF_BLOCKS": 2,
                "PRE_BF_STAGES": 8}),
              ("post 2 stages, 5 blocks; pre 3 stages",
               {"POST_BF_BLOCKS": 5, "PRE_BF_STAGES": 3}),
              SHIPPED),
    "lstm": (SHIPPED,
             ("ring 3 stages", {"PROJ_STAGES": 3}),
             ("ring 6 stages", {"PROJ_STAGES": 6}),
             ("128-column tile", {"PROJ_NT": 8}),
             ("four blocks an SM (128 registers)", {"PROJ_BLOCKS": 4}),
             ("128-column tile, ring 3 stages",
              {"PROJ_NT": 8, "PROJ_STAGES": 3}),
             SHIPPED),
}
# sweep: the phase-3 rows it times
TIMED = {"decoder": ("decoder_bf16", "dsconv_pair_bf16"),
         "pair": ("decoder_bf16", "dsconv_pair_bf16"),
         "encoder": ("encoder_bf16",), "attention": ("attention_bf16",),
         "block": ("dsconv_bf16",),
         "lstm": ("lstm_project_bf16", "lstm_recur_bf16")}
LONG_L = (640, 1024, 1500, 2048)


def variant_sources(i: int, consts: dict) -> Path:
    """csrc with `consts` written into its `constexpr int NAME = v;`
    lines, under se_tpu_torch/_build/sweep/v<i>/csrc."""
    dst = ROOT / "se_tpu_torch" / "_build" / "sweep" / f"v{i}" / "csrc"
    shutil.rmtree(dst.parent, ignore_errors=True)
    shutil.copytree(ROOT / "se_tpu_torch" / "csrc", dst)
    for name, value in consts.items():
        if "." in name:  # a Python attribute, set in run_variant
            continue
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


def long_attention_cases(gen, dev):
    """The complex T-attention's shape at B = 4 (16 x 8 heads) at the L of
    LONG_L, bf16, on the design att_design gives each."""
    import torch

    from se_tpu_torch.ops import attention

    for length in LONG_L:
        q, k, v = ((torch.randn(16, 8, length, 16, generator=gen) * 0.5)
                   .to(dev).to(torch.bfloat16) for _ in range(3))
        design = attention.att_design(128, length)
        yield (f"attention bf16 16x8x{length}x16 design={design}",
               (q, k, v, 0.25, None), None, None, None, "long")


def case_group(case: str, in_row) -> str:
    """The sum a case's ms joins: "b4" (the row's B = 4 forward), "b32"
    (phase 5's batch), "long" (LONG_L), "other" (a design not taken, the
    widened route, chip_smoke.py's own long-L case)."""
    if in_row == "long":
        return "long"
    if in_row:
        return "b4"
    return "b32" if re.search(r"B=32 | 32x", case) else "other"


def run_variant(sweep: str, i: int) -> None:
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from se_tpu_torch.ops import _build, lstm
    from se_tpu_torch.ops._dtype import (
        BF16_FLOOR, LSTM_FLOOR, att_flip_slack, bf16_compare,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    label, consts = SWEEPS[sweep][i]
    for name, value in consts.items():
        if "." in name:
            module, attr = name.split(".")
            setattr(importlib.import_module(f"se_tpu_torch.ops.{module}"),
                    attr, value)
    _build.CSRC = variant_sources(i, consts)
    _build.BUILD_DIR = _build.CSRC.parent
    resources = cs.kernel_resources(_build.library())
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    out = {"sweep": sweep, "variant": label, "constants": consts,
           "resources": resources}
    kinds = {
        "decoder_bf16": (cs.bf16_decoder_cases, cs._decoder_kernel,
                         cs._decoder_twin),
        "dsconv_pair_bf16": (cs.bf16_pair_cases, cs._pair_kernel,
                             cs._pair_twin),
        "encoder_bf16": (cs.bf16_encoder_cases, cs._encoder_kernel,
                         cs._encoder_twin),
        "dsconv_bf16": (cs.bf16_dsconv_cases, cs._block_kernel,
                        cs._block_twin),
        "attention_bf16": (cs.bf16_attention_cases, cs._att_kernel,
                           cs._att_twin),
        "lstm_project_bf16": (cs.bf16_lstm_project_cases, lstm.lstm_project,
                              lstm._project_reference),
        "lstm_recur_bf16": (cs.bf16_lstm_recur_cases,
                            cs._flat_lstm(lstm.lstm_recur),
                            cs._flat_lstm(lstm._recur_reference)),
    }
    for kind in TIMED[sweep]:
        cases, kernel, twin = kinds[kind]
        groups = ("b4", "b32", "other") + (
            ("long",) if kind == "attention_bf16" else ())
        row = {"max_abs_err": 0.0, "ok": True, "cases": {},
               **{f"ms_{g}": 0.0 for g in groups},
               **{f"device_ms_{g}": {} for g in groups}}
        every = cases(gen, dev)  # lazily: a case's tensors one at a time
        if kind == "attention_bf16":
            every = itertools.chain(every, long_attention_cases(gen, dev))
        for case, args, _, _, _, in_row, *_ in every:
            with torch.no_grad():
                slack = ([att_flip_slack(*args[:4])]
                         if kind == "attention_bf16" else None)
                got, want = kernel(*args), twin(*args)
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                check = bf16_compare(
                    got, want, slack,
                    LSTM_FLOOR if kind == "lstm_recur_bf16" else BF16_FLOOR)
                del got, want, slack
                ms = cs.cuda_ms(lambda: kernel(*args))
                split = cs.device_ms(lambda: kernel(*args))
            row["max_abs_err"] = max(row["max_abs_err"], check.max_abs_err)
            row["ok"] = row["ok"] and check.ok
            g = case_group(case, in_row)
            row[f"ms_{g}"] += ms
            for name, t in split.items():
                row[f"device_ms_{g}"][name] = \
                    row[f"device_ms_{g}"].get(name, 0.0) + t
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
