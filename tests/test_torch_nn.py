"""se_tpu_torch.nn primitives against their se_tpu (Flax) counterparts on
the CPU: the same numpy weights and inputs through both. Tolerance 1e-5:
fp32 sums of O(10) terms in a different order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from se_tpu.nn import BatchNorm as JBatchNorm
from se_tpu.nn import Conv2d as JConv2d
from se_tpu.nn import ConvTranspose2d as JConvTranspose2d
from se_tpu.nn import LayerNorm as JLayerNorm
from se_tpu.nn.activations import PReLU as JPReLU
from se_tpu.nn.complex_ops import ComplexDense as JComplexDense
from se_tpu.nn.conv import interleave_complex_bias as j_ibias
from se_tpu.nn.conv import interleave_complex_kernel as j_ikernel
from se_tpu.nn.conv import phase_split_tconv_f as j_phase_split
from se_tpu_torch.nn import (
    BatchNorm, ComplexDense, ConvParams, LayerNorm, PReLU,
)
from se_tpu_torch.nn.conv import (
    conv2d_nhwc, interleave_complex_bias, interleave_complex_kernel,
)
from se_tpu_torch.ops.decoder import _tconv_phase_split, split_phase_weights

ATOL = 1e-5


def _r(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_layernorm(rng):
    x, g, b = _r(rng, 3, 7, 32), _r(rng, 32) + 1, _r(rng, 32)
    want = JLayerNorm().apply({"params": {"scale": g, "bias": b}}, x)
    ln = LayerNorm(32)
    ln.load_state_dict({"weight": _t(g), "bias": _t(b)})
    np.testing.assert_allclose(ln(_t(x)).detach().numpy(), np.asarray(want),
                               atol=ATOL)


def test_batchnorm_eval_and_affine(rng):
    x = _r(rng, 2, 5, 4, 16)
    g, b, m = _r(rng, 16) + 1, _r(rng, 16), _r(rng, 16, scale=0.3)
    v = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    want = JBatchNorm().apply(
        {"params": {"bn": {"scale": g, "bias": b}},
         "batch_stats": {"bn": {"mean": m, "var": v}}}, x,
        use_running_average=True)
    bn = BatchNorm(16)
    bn.load_state_dict({"weight": _t(g), "bias": _t(b),
                        "running_mean": _t(m), "running_var": _t(v)})
    np.testing.assert_allclose(bn(_t(x)).detach().numpy(), np.asarray(want),
                               atol=ATOL)
    scale, shift = bn.affine()
    np.testing.assert_allclose((_t(x) * scale + shift).detach().numpy(),
                               np.asarray(want), atol=ATOL)


def test_prelu(rng):
    x = _r(rng, 4, 9)
    want = JPReLU().apply({"params": {"weight": np.float32(0.3)}}, x)
    act = PReLU()
    act.load_state_dict({"weight": torch.tensor([0.3])})
    np.testing.assert_allclose(act(_t(x)).detach().numpy(), np.asarray(want),
                               atol=0)


def test_complex_dense(rng):
    re, im = _r(rng, 2, 6, 24), _r(rng, 2, 6, 24)
    kr, ki = _r(rng, 24, 10, scale=0.2), _r(rng, 24, 10, scale=0.2)
    br, bi = _r(rng, 10), _r(rng, 10)
    want = JComplexDense(10).apply(
        {"params": {"linear_real": {"kernel": kr, "bias": br},
                    "linear_imag": {"kernel": ki, "bias": bi}}}, re, im)
    cd = ComplexDense(24, 10)
    cd.load_state_dict({"real_linear.weight": _t(kr.T),
                        "real_linear.bias": _t(br),
                        "imag_linear.weight": _t(ki.T),
                        "imag_linear.bias": _t(bi)})
    got = cd(_t(re), _t(im))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=ATOL)


def test_interleave_helpers(rng):
    kr, ki = _r(rng, 2, 5, 3, 4), _r(rng, 2, 5, 3, 4)
    br, bi = _r(rng, 4), _r(rng, 4)
    np.testing.assert_array_equal(
        interleave_complex_kernel(_t(kr), _t(ki)).numpy(),
        np.asarray(j_ikernel(kr, ki)))
    np.testing.assert_array_equal(interleave_complex_bias(_t(br), _t(bi))
                                  .numpy(), np.asarray(j_ibias(br, bi)))


@pytest.mark.parametrize("cin,cout", [(1, 8), (16, 32)])
def test_stride2_conv_matches_jax(rng, cin, cout):
    """The encoder's conv: (2, 5) kernel, strides (1, 2), causal T."""
    x = _r(rng, 2, 11, 16, cin)
    holder = ConvParams(cin, cout, (2, 5))
    holder.reset_parameters(torch.Generator().manual_seed(0))
    kernel = holder.hwio().detach()
    bias = holder.bias.detach()
    want = JConv2d(cout, (2, 5), (1, 2), padding=((1, 0), (2, 2))).apply(
        {"params": {"kernel": kernel.numpy(), "bias": bias.numpy()}}, x)
    got = conv2d_nhwc(_t(x), kernel, strides=(1, 2),
                      padding=((1, 0), (2, 2))) + bias
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("cin,cout", [(4, 3), (32, 8)])
def test_phase_split_tconv_matches_jax(rng, cin, cout):
    """The decoder's transposed conv: (2, 5), strides (1, 2), padding
    (0, 2), output_padding (0, 1), output T trimmed to the input's, as the
    decoder twin runs it (`split_phase_weights` + `_tconv_phase_split`),
    against se_tpu's ConvTranspose2d, its phase split, and torch's own
    conv_transpose2d geometry."""
    x = _r(rng, 2, 9, 8, cin)
    t = x.shape[1]
    holder = ConvParams(cin, cout, (2, 5), transpose=True)
    holder.reset_parameters(torch.Generator().manual_seed(1))
    kernel = holder.hwio().detach()
    bias = holder.bias.detach()
    want = JConvTranspose2d(cout, (2, 5), (1, 2), padding=(0, 2),
                            output_padding=(0, 1)).apply(
        {"params": {"kernel": kernel.numpy(), "bias": bias.numpy()}}, x)
    got = _tconv_phase_split(_t(x), *split_phase_weights(kernel), bias)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :t],
                               atol=ATOL)
    np.testing.assert_allclose(
        got.numpy(),
        np.asarray(j_phase_split(jnp.asarray(x), jnp.asarray(kernel.numpy()),
                                 0, 2, 0, 1))[:, :t] + bias.numpy(),
        atol=ATOL)
    # torch's ConvTranspose2d on (B, C, T, F) with the stored weight
    ref = F.conv_transpose2d(_t(x).permute(0, 3, 1, 2),
                             holder.weight.detach().transpose(2, 3),
                             bias, stride=(1, 2), padding=(0, 2),
                             output_padding=(0, 1)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref.numpy()[:, :t], atol=ATOL)
