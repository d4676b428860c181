"""The readings behind `ops._dtype.bf16_step_compare`'s floor: for each
family named (all ten of the trainer by default), the port's bf16 train
step against se_tpu's bf16 and fp32 steps on the CPU, as
tests/test_torch_bf16_train*.py make them, one JSON line a family:

- the step's largest |gradient| and its gradient tensors, how many of
  them lie under the step's floor (STEP_FLOOR x that largest), and how
  many have their floor's cap lifted (`cap_lifted`: scalars, tensors
  se_tpu's bf16 step does not resolve);
- the rule's verdict, its tensors past twice se_tpu's distance, the worst
  ratio of a tensor's distance to its limit, the pooled distances;
- for the capped rule and for one floor the same for every tensor (the
  step's), the share of gradient tensors that a zeroed or negated tensor
  would fail even as a stray (distance past 4 x se_tpu's plus the floor).

    JAX_PLATFORMS=cpu python tests/bf16_step_readings.py [family ...]
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from se_tpu_torch.ops._dtype import (  # noqa: E402
    FLOOR_SHARE, STEP_FLOOR, bf16_step_compare, cap_lifted,
)
from test_torch_bf16_train import bf16_steps  # noqa: E402
from test_torch_bf16_train_conv import SEEDS as CONV_SEEDS  # noqa: E402
from test_torch_bf16_train_tcm import SEEDS as TCM_SEEDS  # noqa: E402
from test_torch_train import FAMILIES  # noqa: E402

SEEDS = {**{name: 3 for name in FAMILIES}, **CONV_SEEDS, **TCM_SEEDS}


def readings(name: str) -> dict:
    got, ref16, ref32 = bf16_steps(name, SEEDS[name])
    check = bf16_step_compare(got, ref16, ref32)
    rows = []
    for k, want in ref32.items():
        if k == "loss" or "running" in k:
            continue
        want = np.asarray(want, np.float64).reshape(-1)
        scale = float(np.abs(want).max())
        e_ref = float(np.abs(np.asarray(ref16[k], np.float64).reshape(-1)
                             - want).max())
        e_got = float(np.abs(got[k].detach().double().numpy().reshape(-1)
                             - want).max())
        rows.append((scale, e_ref, e_got, want.size))
    gmax = max(r[0] for r in rows)
    step = STEP_FLOOR * gmax

    def floor(scale, e_ref, n):
        return step if cap_lifted(e_ref, scale, n) else \
            min(step, FLOOR_SHARE * scale)

    def caught(floor_of, times):
        return sum(times * s > 4 * e + floor_of(s, e, n)
                   for s, e, _, n in rows) / len(rows)

    def flat(s, e, n):
        return step

    return {"family": name, "largest_grad": gmax, "grad_tensors": len(rows),
            "under_step_floor": sum(s < step for s, *_ in rows),
            "cap_lifted": check.uncapped, "ok": check.ok,
            "past_twice": len(check.failures),
            "worst_over_limit": max(g / (2 * e + floor(s, e, n))
                                    for s, e, g, n in rows),
            "pooled_port": check.pooled_got,
            "pooled_se_tpu": check.pooled_ref,
            "zero_caught": caught(floor, 1), "negate_caught": caught(floor, 2),
            "zero_caught_step_floor": caught(flat, 1),
            "negate_caught_step_floor": caught(flat, 2)}


def main() -> None:
    names = sys.argv[1:] or sorted(SEEDS)
    torch.set_num_threads(1)
    for name in names:
        print(json.dumps(readings(name)), flush=True)


if __name__ == "__main__":
    main()
