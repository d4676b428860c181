"""The four kernel modules of se_tpu_torch against se_tpu's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch twin; the twin is held
against the JAX `_reference` and against the Pallas kernel run with
`interpret=True`, as tests/test_pallas_*.py run them. The CUDA kernels
are held against these twins on the card in tests/test_torch_cuda.py.
Tolerance: 2e-5 absolute on O(1) outputs (fp32, same math, different
summation order), as tests/test_pallas_dsconv.py uses.
"""

import pytest
import torch

from se_tpu.ops import pallas_attention as jatt
from se_tpu.ops import pallas_decoder as jdec
from se_tpu.ops import pallas_dsconv as jds
from se_tpu.ops import pallas_encoder as jenc
from se_tpu_torch.ops import _build, attention, decoder, dsconv, encoder
from torch_kernel_inputs import (
    att_inputs, close, dec_params, dsconv_params, enc_params, rand, to_torch,
)

ATOL = 2e-5


@pytest.mark.parametrize("l", [4, 65, 401])
def test_attention_twin_matches_jax(rng, l):
    q, k, v = att_inputs(rng, 2, 8, l)
    got = attention.sdp_attention(*to_torch((q, k, v)), 0.25)
    close([got], [jatt._reference(q, k, v, 0.25)], ATOL)
    close([got], [jatt.sdp_attention(q, k, v, 0.25, interpret=True)], ATOL)


@pytest.mark.parametrize("ncomp,d1,d2,t", [(2, 1, 8, 20), (1, 2, 16, 12),
                                           (2, 16, 1, 12)])
def test_dsconv_twin_matches_jax(rng, ncomp, d1, d2, t):
    """Includes a dilation larger than T (16 > 12)."""
    cin = 16 * ncomp
    params = dsconv_params(rng, cin, 8, ncomp)
    x = rand(rng, 2, t, 4, cin, scale=0.5)
    got = dsconv.dsconv_block(*to_torch((x,)), to_torch(params), d1, d2,
                              ncomp)
    close([got], [jds._reference(x, params, d1, d2, ncomp)], ATOL)
    close([got], [jds.dsconv_block(x, params, d1, d2, ncomp,
                                   interpret=True)], ATOL)


@pytest.mark.parametrize("cin,cout,f", [(1, 8, 16), (16, 32, 8)])
def test_encoder_twin_matches_jax(rng, cin, cout, f):
    params = enc_params(rng, cin, cout)
    xc, xm = rand(rng, 2, 6, f, 2 * cin), rand(rng, 2, 6, f, cin)
    got = encoder.encoder_level(*to_torch((xc, xm)), to_torch(params))
    close(got, jenc._reference(xc, xm, params), ATOL)
    close(got, jenc.encoder_level(xc, xm, params, interpret=True), ATOL)


@pytest.mark.parametrize("has_bn", [True, False])
def test_decoder_twin_matches_jax(rng, has_bn):
    cc, cout = 16, 4
    params = dec_params(rng, cc, cout)
    xc, xm = rand(rng, 2, 6, 4, 2 * cc), rand(rng, 2, 6, 4, cc)
    got = decoder.decoder_level(*to_torch((xc, xm)), to_torch(params), has_bn)
    close(got, jdec._reference(xc, xm, params, has_bn), ATOL)
    close(got, jdec.decoder_level(xc, xm, params, has_bn, interpret=True),
          ATOL)


def test_split_phase_weights_matches_jax(rng):
    w = rand(rng, 2, 5, 6, 3)
    got = decoder.split_phase_weights(torch.from_numpy(w))
    close(got, jdec.split_phase_weights(w), atol=0)


def test_cpu_tensors_launch_nothing(rng):
    before = dict(_build.LAUNCHES)
    attention.sdp_attention(*to_torch(att_inputs(rng, 1, 1, 5)), 0.25)
    assert dict(_build.LAUNCHES) == before
