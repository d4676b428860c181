"""se_tpu_torch's bf16 training against se_tpu's on the CPU, TaylorSENet
and G2Net (G2Net's stagewise loss over its three stages): one bf16 step
from the same weights on the batch of tests/test_torch_train.py (B = 2,
16 frames), at published widths, held by `ops._dtype.bf16_step_compare`
against se_tpu's bf16 and fp32 steps, as test_torch_bf16_train.py holds
the LSTM families. The train contract casts the complex spectrum to bf16
(the bf16 enhance keeps it fp32). Then one bf16 step with Adam: masters,
gradients, Adam's moments and buffers fp32. And the rule fails G2Net's
bf16 step with one small gradient tensor zeroed, negated or NaN. ~2 min
alone."""

import pytest

from test_torch_bf16_train import (  # noqa: F401  (_one_thread: fixture)
    _one_thread, check_bf16_step, check_masters_stay_fp32,
    check_planted_fault,
)

SEEDS = {"taylorsenet": 5, "g2net": 5}


@pytest.mark.parametrize("name", sorted(SEEDS))
def test_bf16_train_step_tracks_se_tpu(name):
    check_bf16_step(name, seed=SEEDS[name])


@pytest.mark.parametrize("name", sorted(SEEDS))
def test_bf16_step_keeps_fp32_masters(name):
    check_masters_stay_fp32(name, {})


@pytest.mark.parametrize("fault", ["zero", "negate", "nan"])
def test_bf16_rule_fails_a_planted_fault(fault):
    check_planted_fault("g2net", SEEDS["g2net"], fault)
