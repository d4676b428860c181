"""se_tpu_torch's conformer stage `dsconv_pair_block` (its plain twin
`_pair_reference` on a CPU tensor) against se_tpu's Pallas pair kernel run
with `interpret=True` and against its composed `_pair_reference`, as
tests/test_pallas_dsconv.py runs them. Tolerance 2e-5 absolute on O(1)
outputs: fp32 on both sides, sums in another order.
"""

import pytest

from se_tpu.ops import pallas_dsconv as jds
from se_tpu_torch.ops import _build, dsconv
from se_tpu_torch.ops.encoder import fuse
from torch_kernel_inputs import close, pair_inputs, to_torch

ATOL = 2e-5


@pytest.mark.parametrize("d1,d2,t", [(1, 8, 12), (16, 2, 12)])
def test_pair_twin_matches_jax(rng, d1, d2, t):
    """Includes a dilation larger than T (16 > 12)."""
    xc, xm, pc, pm = pair_inputs(rng, 2, t, 4, 8, 4)
    got = dsconv.dsconv_pair_block(*to_torch((xc, xm)), to_torch(pc),
                                   to_torch(pm), d1, d2)
    assert got[0].shape == xc.shape and got[1].shape == xm.shape
    close(got, jds._pair_reference(xc, xm, pc + pm, d1, d2), ATOL)
    close(got, jds.dsconv_pair_block(xc, xm, pc, pm, d1, d2,
                                     interpret=True), ATOL)


def test_pair_twin_is_two_blocks_and_fusion(rng):
    """The stage equals the two single-block twins followed by the
    encoder's `fusion`, the composed path se_tpu takes outside eval."""
    xc, xm, pc, pm = pair_inputs(rng, 1, 9, 4, 8, 4)
    xc, xm = to_torch((xc, xm))
    pc, pm = to_torch(pc), to_torch(pm)
    got = dsconv.dsconv_pair_block(xc, xm, pc, pm, 2, 4)
    want = fuse(dsconv.dsconv_block(xc, pc, 2, 4, 2),
                dsconv.dsconv_block(xm, pm, 2, 4, 1))
    close(got, want, 1e-6)


def test_cpu_pair_launches_nothing(rng):
    xc, xm, pc, pm = pair_inputs(rng, 1, 5, 4, 8, 4)
    before = dict(_build.LAUNCHES)
    dsconv.dsconv_pair_block(*to_torch((xc, xm)), to_torch(pc), to_torch(pm),
                             1, 1)
    assert dict(_build.LAUNCHES) == before
