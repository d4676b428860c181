"""The tensor-core design of the single DSConv block (csrc/dsconv.cu
`se_dsconv_block_tc`: `dsconv_block_pre_tc`, `dsconv_block_post_tc`) on
the CPU: the kernels run only on the card (tests/test_torch_cuda.py), so
what they compute is formed here in plain torch as they form it, and held
against the twin `dsconv._reference`, itself held against se_tpu's Pallas
block kernel run with interpret=True (as tests/test_pallas_dsconv.py runs
it).

- The block is the pair stage's design for one branch: the pre GEMM with
  LN1 in the load, the dilated convs, a * sigmoid(g), LN2 and z *
  sigmoid(z) (tests/test_torch_dsconv_pair_tc.py's emulation), then the
  output 1x1 conv against `pack_block_weights`' ws (K-major, Cin rows of
  round_up(Cm, 8)), + bs + x. In float64 and in the kernel's 3xTF32,
  within 1e-5 * max(1, max|twin|).
- `pack_block_weights` is a permutation of the 13-tuple plus zeros, and
  the shape rule (`_check_block`) raises outside Cin, Cm multiples of 4
  and Cm <= 64 complex, 32 real.
- DSConvCplx / DSConvReal pack their weights once, not once a call.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from se_tpu.ops import pallas_dsconv as jds
from se_tpu_torch.ops import dsconv
from test_torch_dsconv_pair_tc import (
    _fp64, gated_emulated, ln2_swish, pre_emulated,
)
from test_torch_lstm_tc import matmul_3xtf32
from torch_kernel_inputs import close, dsconv_params, rand, to_torch

RTOL = 1e-5


def block_emulated(x, pk, ncomp, d1, d2, matmul):
    """se_dsconv_block_tc's arithmetic: x (B, T, F, Cin) -> out."""
    b, t, f, cin = x.shape
    x2 = x.reshape(-1, cin)
    y = pre_emulated(x2, pk, ncomp, matmul)
    z = ln2_swish(gated_emulated(y, pk, t, f, d1, d2, matmul), pk[9],
                  pk[10], ncomp)
    ws = pk[11]  # (Cin, round_up(Cm, 8))
    s = matmul(F.pad(z, (0, ws.shape[1] - z.shape[1])), ws.t())
    return (s + pk[12][0] + x2).reshape(x.shape)


def _inputs(rng, b, t, cin, cm, ncomp):
    params = to_torch(dsconv_params(rng, cin, cm, ncomp))
    (x,) = to_torch((rand(rng, b, t, 4, cin, scale=0.5),))
    return x, params


def _close(got, want, rtol=RTOL):
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=0, atol=rtol * scale)


# (B, T, Cin, Cm per component, ncomp, d1, d2): the conformer's widths
# (complex Cin 256, Cm 2 x 32; real Cin 128, Cm 32) with d = 128 > T and
# d = 2, 64; narrow Cin 8 (a part-empty 32-channel output pass) and Cm 4
# (padded to 32 a tap, to 8 for the output GEMM), Cin 40 and Cm 12
BLOCKS = [(1, 7, 256, 32, 2, 1, 128), (2, 6, 128, 32, 1, 128, 1),
          (1, 9, 256, 32, 2, 2, 64), (2, 5, 8, 2, 2, 1, 8),
          (2, 5, 8, 4, 1, 2, 1), (1, 9, 40, 12, 1, 8, 2)]


@pytest.mark.parametrize("matmul", [_fp64, matmul_3xtf32],
                         ids=["fp64", "3xtf32"])
@pytest.mark.parametrize("b,t,cin,cm,ncomp,d1,d2", BLOCKS)
def test_block_matches_twin(rng, b, t, cin, cm, ncomp, d1, d2, matmul):
    x, params = _inputs(rng, b, t, cin, cm, ncomp)
    pk = dsconv.pack_block_weights(params, ncomp)
    got = block_emulated(x, pk, ncomp, d1, d2, matmul)
    _close(got, dsconv._reference(x, params, d1, d2, ncomp))


@pytest.mark.parametrize("d1,d2", [(1, 128), (128, 1)])
@pytest.mark.parametrize("ncomp", [2, 1])
def test_block_twin_matches_pallas(rng, ncomp, d1, d2):
    """The twin against se_tpu's block kernel in interpret mode and its
    `_reference` at narrow widths (Cin 16 a component, Cm 8), d = 128 > T:
    2e-5 absolute on O(1) outputs (tests/test_torch_kernels.py's)."""
    cin = 16 * ncomp
    params = dsconv_params(rng, cin, 8, ncomp)
    x = rand(rng, 2, 10, 4, cin, scale=0.5)
    got = dsconv.dsconv_block(*to_torch((x,)), to_torch(params), d1, d2,
                              ncomp)
    close([got], [jds.dsconv_block(x, params, d1, d2, ncomp,
                                   interpret=True)], 2e-5)
    close([got], [jds._reference(x, params, d1, d2, ncomp)], 2e-5)


@pytest.mark.parametrize("cin,cm,ncomp", [(256, 32, 2), (128, 32, 1),
                                          (8, 2, 2), (40, 12, 1)])
def test_pack_is_a_permutation_plus_zeros(rng, cin, cm, ncomp):
    _, params = _inputs(rng, 1, 1, cin, cm, ncomp)
    pk = dsconv.pack_block_weights(params, ncomp)
    tot = cm * ncomp
    k1p, totp = -(-cin // 32) * 32, -(-tot // 32) * 32
    n = (64, 32)[ncomp == 1]
    assert pk[0].shape == (n, k1p) and pk[1].shape == (k1p,)
    assert pk[5].shape == pk[7].shape == (n, 9 * totp)
    assert pk[11].shape == (cin, -(-tot // 8) * 8)
    for i, src in ((0, 2), (5, 5), (7, 7), (11, 11)):
        vals = torch.sort(pk[i][pk[i] != 0]).values
        want = torch.sort(params[src][params[src] != 0]).values
        torch.testing.assert_close(vals, want, rtol=0, atol=0)
    torch.testing.assert_close(pk[11][:, :tot], params[11].t(), rtol=0,
                               atol=0)
    for i in (3, 4, 6, 8, 9, 10, 12):
        assert pk[i] is params[i]


@pytest.mark.parametrize("cin,cm,ncomp,ok", [
    (256, 32, 2, True), (128, 32, 1, True), (8, 2, 2, True),
    (6, 4, 1, False),     # Cin not a multiple of 4
    (16, 3, 2, False),    # Cm 6 not a multiple of 4
    (256, 36, 2, False),  # Cm 72 > 64
    (128, 36, 1, False),  # Cm 36 > 32
])
def test_shape_rule(rng, cin, cm, ncomp, ok):
    """`_check_block` raises the shape rule's ValueError outside it; inside
    it, only the device check (these are CPU tensors) raises."""
    x, params = _inputs(rng, 1, 2, cin, cm, ncomp)
    with pytest.raises(ValueError) as err:
        dsconv._check_block(x, params, ncomp, "dsconv")
    assert ("expected a CUDA tensor" in str(err.value)) == ok
    assert ("multiples of 4" in str(err.value)) != ok


def test_shape_rule_refuses_ncomp_3(rng):
    x, params = _inputs(rng, 1, 2, 12, 4, 3)
    with pytest.raises(ValueError, match="ncomp 1 or 2"):
        dsconv._check_block(x, params, 3, "dsconv")


def test_dsconv_modules_keep_their_pack_until_it_changes():
    """DSConvCplx / DSConvReal make their 13-tuple (and, on the card, its
    pack) once: the same objects come back until a weight changes in
    place; under autograd nothing is cached."""
    from se_tpu_torch.models.uformer import DSConvCplx, DSConvReal

    for cls, cin in ((DSConvCplx, 128), (DSConvReal, 128)):
        blk = cls(cin, 32, 2, 4)
        with torch.no_grad():
            first = blk.weights()
            assert blk.weights() is first and first[1] is None  # CPU
            for prm in blk.sconv.parameters():
                prm.mul_(2.0)
            changed = blk.weights()
        assert changed is not first
        torch.testing.assert_close(changed[0][11], 2.0 * first[0][11])
        graph = blk.weights()
        assert graph is not changed and graph[0][2].requires_grad
