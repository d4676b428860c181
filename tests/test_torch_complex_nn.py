"""The primitives this slice adds to se_tpu_torch.nn against their se_tpu
(Flax) counterparts on the CPU: NHWC Conv2d / ConvTranspose2d with torch's
geometry and parameter layouts, the GLU pairs, the complex convs and the
naive complex LSTM, LayerNorm over two axes and the complex concat. Flax
variables are drawn from a numpy seed and carried over with the
`models.jax_tree` helpers the models' `from_jax_variables` use. Tolerance
1e-5: fp32 sums of O(100) terms in another order."""

import jax
import numpy as np
import pytest
import torch

from se_tpu import nn as jnn
from se_tpu.nn import complex_ops as jco
from se_tpu_torch import nn as tnn
from se_tpu_torch.models import jax_tree as jt
from se_tpu_torch.nn import complex_ops as tco
from torch_kernel_inputs import fill_tree

ATOL = 1e-5


def _flax(module, x, seed=0):
    """Variables from a numpy seed and the Flax output on x."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *x)
    variables = fill_tree(shapes, seed)
    return variables, np.asarray(module.apply(variables, *x))


def _run(port, state_dict, *x):
    port.load_state_dict(state_dict)
    with torch.no_grad():
        out = port(*(torch.from_numpy(a) for a in x))
    return out


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("kernel,stride,padding", [
    ((2, 3), (1, 2), ((1, 0), (0, 0))),   # CRN / DPCRN encoders
    ((1, 3), (1, 2), "VALID"),            # GCRN encoder
    ((2, 5), (1, 1), ((0, 1), (2, 1))),
])
def test_conv2d_matches_jax(rng, kernel, stride, padding):
    x = _x(rng, 2, 7, 21, 3)
    variables, want = _flax(jnn.Conv2d(5, kernel, stride, padding), (x,))
    sd: dict = {}
    jt.put_conv(sd, "c", variables["params"])
    pad = ((0, 0), (0, 0)) if padding == "VALID" else padding
    got = _run(tnn.Conv2d(3, 5, kernel, stride, pad),
               {k[2:]: v for k, v in sd.items()}, x)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("kernel,output_padding", [
    ((2, 3), (0, 0)), ((1, 3), (0, 1)), ((2, 5), (0, 1))])
def test_conv_transpose2d_matches_jax(rng, kernel, output_padding):
    """torch's geometry: (in - 1) * stride - 2 * pad + kernel + opad."""
    x = _x(rng, 2, 6, 9, 4)
    variables, want = _flax(jnn.ConvTranspose2d(
        3, kernel, (1, 2), output_padding=output_padding), (x,))
    sd: dict = {}
    jt.put_conv(sd, "c", variables["params"], transpose=True)
    port = tnn.ConvTranspose2d(4, 3, kernel, (1, 2),
                               output_padding=output_padding)
    got = _run(port, {k[2:]: v for k, v in sd.items()}, x)
    assert got.shape[2] == (9 - 1) * 2 + kernel[1] + output_padding[1]
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("transpose", [False, True])
def test_glu_convs_match_jax(rng, transpose):
    x = _x(rng, 2, 5, 19, 6)
    if transpose:
        module = jnn.GluConvTranspose2d(4, (1, 3), (1, 2),
                                        output_padding=(0, 1))
        port = tnn.GluConvTranspose2d(6, 4, (1, 3), (1, 2),
                                      output_padding=(0, 1))
    else:
        module = jnn.GluConv2d(4, (1, 3), (1, 2))
        port = tnn.GluConv2d(6, 4, (1, 3), (1, 2))
    variables, want = _flax(module, (x,))
    sd: dict = {}
    for part in ("conv1", "conv2"):
        jt.put_conv(sd, part, variables["params"][part], transpose)
    np.testing.assert_allclose(_run(port, sd, x).numpy(), want, atol=ATOL)


@pytest.mark.parametrize("cin", [2, 16])
def test_complex_conv2d_matches_jax(rng, cin):
    """DCCRN's encoder conv: (2, 5), stride 2 over F, causal time pad,
    reference weights (O, I, kf, kt)."""
    x = _x(rng, 2, 6, 32, cin)
    variables, want = _flax(jco.ComplexConv2d(
        8, (2, 5), strides=(1, 2), padding_tf=((1, 0), (2, 2))), (x,))
    sd: dict = {}
    for part in ("real_conv", "imag_conv"):
        jt.put_conv(sd, part, variables["params"][part], freq_first=True)
    port = tco.ComplexConv2d(cin, 8, (2, 5), stride=(1, 2),
                             padding=((1, 0), (2, 2)))
    assert port.real_conv.weight.shape == (4, cin // 2, 5, 2)
    np.testing.assert_allclose(_run(port, sd, x).numpy(), want, atol=ATOL)


def test_complex_conv_transpose2d_matches_jax(rng):
    """DCCRN's decoder deconv: (2, 5), stride 2 over F, padding (0, 2),
    output_padding (0, 1)."""
    x = _x(rng, 2, 6, 8, 12)
    variables, want = _flax(jco.ComplexConvTranspose2d(
        4, (2, 5), strides=(1, 2), padding=(0, 2), output_padding=(0, 1)),
        (x,))
    sd: dict = {}
    for part in ("real_conv", "imag_conv"):
        jt.put_conv(sd, part, variables["params"][part], transpose=True,
                    freq_first=True)
    port = tco.ComplexConvTranspose2d(12, 4, (2, 5), stride=(1, 2),
                                      padding=(0, 2), output_padding=(0, 1))
    got = _run(port, sd, x)
    assert got.shape == (2, 7, 16, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("projection", [None, 12])
def test_naive_complex_lstm_matches_jax(rng, projection):
    re, im = _x(rng, 3, 9, 10), _x(rng, 3, 9, 10)
    variables, _ = _flax(jco.NaiveComplexLSTM(8, projection), (re, im))
    want = jco.NaiveComplexLSTM(8, projection).apply(variables, re, im)
    sd: dict = {}
    prm = variables["params"]
    for name in ("real_lstm", "imag_lstm"):
        jt.put_lstm(sd, name, prm[name])
    for name in ("r_trans", "i_trans"):
        if name in prm:
            jt.put_dense(sd, name, prm[name])
    got = _run(tco.NaiveComplexLSTM(10, 8, projection), sd, re, im)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_layernorm_over_two_axes_matches_jax(rng):
    x = _x(rng, 2, 5, 4, 16)
    variables, want = _flax(jnn.LayerNorm(ndims=2), (x,))
    sd: dict = {}
    jt.put_layernorm(sd, "ln", variables["params"])
    port = tnn.LayerNorm((4, 16))
    got = _run(port, {k[3:]: v for k, v in sd.items()}, x)
    assert port.weight.shape == (4, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_complex_cat_and_split_match_jax(rng):
    a, b = _x(rng, 2, 3, 4, 6), _x(rng, 2, 3, 4, 10)
    got = tco.complex_cat([torch.from_numpy(a), torch.from_numpy(b)])
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jco.complex_cat([a, b])))
    re, im = tco.split_complex(got)
    np.testing.assert_array_equal(tco.merge_complex(re, im).numpy(),
                                  got.numpy())
