"""se_tpu_torch's bf16 training against se_tpu's on the CPU, Uformer and
CTSNet (the other TCM families: test_torch_bf16_train_tcm.py): one bf16
step from the same weights on the batch of tests/test_torch_train.py
(B = 2, 16 frames), at published widths, held by
`ops._dtype.bf16_step_compare` against se_tpu's bf16 and fp32 steps, as
test_torch_bf16_train.py holds the LSTM families; dropout off on both
sides. Uformer's train mode runs its levels and DSConv blocks on the
plain path, in bf16, and its attention through the bf16 twin. Then one
bf16 step with Adam: masters, gradients, Adam's moments and buffers
fp32. ~2 min alone (se_tpu's two compiles of each family)."""

import pytest

from test_torch_bf16_train import (  # noqa: F401  (_one_thread: fixture)
    _one_thread, check_bf16_step, check_masters_stay_fp32,
)

SEEDS = {"uformer": 4, "ctsnet": 5}


@pytest.mark.parametrize("name", sorted(SEEDS))
def test_bf16_train_step_tracks_se_tpu(name):
    check_bf16_step(name, seed=SEEDS[name])


@pytest.mark.parametrize("name", sorted(SEEDS))
def test_bf16_step_keeps_fp32_masters(name):
    check_masters_stay_fp32(name, {})
