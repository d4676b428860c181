"""The CUDA kernels of se_tpu_torch against their plain PyTorch twins on the
card. Marked `cuda`; each test skips without an NVIDIA GPU (the kernels
have no CPU mode). Imports no JAX, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance 1e-4 absolute on O(1) outputs: fp32 on both sides, sums in
another order (kernel loops against cuBLAS/cuDNN with TF32 off).
"""

import numpy as np
import pytest
import torch

from se_tpu_torch.ops import attention, decoder, dsconv, encoder
from torch_kernel_inputs import (
    att_inputs, close, dec_params, dsconv_params, enc_params, rand, to_torch,
)

ATOL = 1e-4
pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    return np.random.default_rng(0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _kernel_vs_twin(fn, args, dev):
    """fn on CUDA copies of args (the kernel) against fn on the CPU ones
    (the twin)."""
    def to(x):
        if isinstance(x, tuple):
            return tuple(a.to(dev) for a in x)
        return x.to(dev) if isinstance(x, torch.Tensor) else x

    want = fn(*args)
    got = fn(*[to(a) for a in args])
    torch.cuda.synchronize()
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert all(g.device.type == "cuda" for g in got)
    close(got, want, ATOL)


@pytest.mark.parametrize("l", [1, 4, 65, 401])
def test_attention_kernel_matches_twin(gen, dev, l):
    q, k, v = to_torch(att_inputs(gen, 3, 8, l))
    _kernel_vs_twin(attention.sdp_attention, (q, k, v, 0.25), dev)


@pytest.mark.parametrize("ncomp,d1,d2", [(2, 1, 128), (1, 128, 1)])
def test_dsconv_kernel_matches_twin(gen, dev, ncomp, d1, d2):
    cin = 128 * ncomp
    params = to_torch(dsconv_params(gen, cin, 32, ncomp))
    (x,) = to_torch((rand(gen, 2, 50, 4, cin, scale=0.5),))
    _kernel_vs_twin(lambda x, p: dsconv.dsconv_block(x, p, d1, d2, ncomp),
                    (x, params), dev)


@pytest.mark.parametrize("cin,cout,f", [(1, 8, 256), (64, 128, 8)])
def test_encoder_kernel_matches_twin(gen, dev, cin, cout, f):
    params = to_torch(enc_params(gen, cin, cout))
    xc, xm = to_torch((rand(gen, 2, 9, f, 2 * cin), rand(gen, 2, 9, f, cin)))
    _kernel_vs_twin(encoder.encoder_level, (xc, xm, params), dev)


@pytest.mark.parametrize("has_bn", [True, False])
def test_decoder_kernel_matches_twin(gen, dev, has_bn):
    params = to_torch(dec_params(gen, 32, 8))
    xc, xm = to_torch((rand(gen, 2, 9, 16, 64), rand(gen, 2, 9, 16, 32)))
    _kernel_vs_twin(lambda a, b, p: decoder.decoder_level(a, b, p, has_bn),
                    (xc, xm, params), dev)


def test_wrappers_refuse_other_dtypes_and_layouts(gen, dev):
    q, k, v = (t.to(dev) for t in to_torch(att_inputs(gen, 1, 1, 8)))
    with pytest.raises(TypeError):
        attention.sdp_attention(q.double(), k.double(), v.double(), 0.25)
    with pytest.raises(ValueError, match="contiguous"):
        attention.sdp_attention(q.transpose(2, 3).contiguous()
                                .transpose(2, 3), k, v, 0.25)
