"""Gradients through the kernel wrappers of se_tpu_torch on the CPU.

- `ops._autograd.kernel_call` under torch.autograd.gradcheck in float64,
  with each wrapper's plain twin standing in for its kernel (the kernels
  run only on the card: tests/test_torch_cuda.py holds them against the
  twins' autograd there). Packed weights and integer arguments are closed
  over, not inputs: no gradient flows through a pack built with grad.
- The LSTM layer's backward twin `_chunked_reference` (se_tpu's
  `_scan_forward_chunked` with `reverse` and a carry) against jax.vjp of
  `se_tpu.ops.pallas_lstm._scan_forward_chunked`, forward and reverse, at
  T = 70 (not a multiple of the chunk): within 1e-5 absolute on outputs in
  (-1, 1) and on gradients of O(1), fp32 on both sides. What its graph
  saves does not grow with T * 4H.
- `stft_fused` raises on an input that requires grad.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_tpu.ops.pallas_lstm import _scan_forward_chunked
from se_tpu_torch.ops import attention, decoder, dsconv, encoder, lstm
from se_tpu_torch.ops import stft as plain_stft
from se_tpu_torch.ops import stft_fused
from se_tpu_torch.ops._autograd import kernel_call
from torch_kernel_inputs import (
    att_inputs, dec_params, dsconv_params, enc_params, lstm_inputs, rand,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tensors are small: torch's intra-op threads would only contend
    with the other test workers' processes for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _f64(arrs):
    return tuple(torch.from_numpy(np.array(a, np.float64)).requires_grad_()
                 for a in arrs)


def _gradcheck(twin, *inputs):
    """kernel_call(twin, twin, ...) against finite differences in every
    tensor of `inputs` (a nest of tuples)."""
    flat = [t for item in inputs
            for t in (item if isinstance(item, tuple) else (item,))]
    sizes = [len(item) if isinstance(item, tuple) else None
             for item in inputs]

    def fn(*ts):
        it = iter(ts)
        nest = [tuple(next(it) for _ in range(n)) if n is not None
                else next(it) for n in sizes]
        return kernel_call(twin, twin, *nest)

    assert torch.autograd.gradcheck(fn, flat, atol=1e-6, rtol=1e-4)


def test_attention_function_gradcheck(rng):
    q, k, v = _f64(att_inputs(rng, 1, 2, 5))
    _gradcheck(lambda q, k, v: attention._reference(q, k, v, 0.25), q, k, v)


def test_encoder_level_function_gradcheck(rng):
    (xc, xm), params = _f64((rand(rng, 1, 3, 8, 4), rand(rng, 1, 3, 8, 2))), \
        _f64(enc_params(rng, 2, 3))
    _gradcheck(encoder._reference, xc, xm, params)


@pytest.mark.parametrize("has_bn", [True, False])
def test_decoder_level_function_gradcheck(rng, has_bn):
    xc, xm = _f64((rand(rng, 1, 3, 4, 6), rand(rng, 1, 3, 4, 3)))
    params = _f64(dec_params(rng, 3, 2))
    _gradcheck(lambda xc, xm, p: decoder._reference(xc, xm, p, has_bn),
               xc, xm, params)


@pytest.mark.parametrize("ncomp", [1, 2])
def test_dsconv_block_function_gradcheck(rng, ncomp):
    (x,) = _f64((rand(rng, 1, 5, 3, 4 * ncomp, scale=0.5),))
    params = _f64(dsconv_params(rng, 4 * ncomp, 2, ncomp))
    _gradcheck(lambda x, p: dsconv._reference(x, p, 1, 2, ncomp), x, params)


def test_dsconv_pair_function_gradcheck(rng):
    xc, xm = _f64((rand(rng, 1, 5, 3, 8, scale=0.5),
                   rand(rng, 1, 5, 3, 4, scale=0.5)))
    pc, pm = _f64(dsconv_params(rng, 8, 2, 2)), _f64(dsconv_params(rng, 4, 2,
                                                                    1))
    _gradcheck(lambda xc, xm, pc, pm: dsconv._pair_reference(xc, xm, pc, pm,
                                                             2, 1),
               xc, xm, pc, pm)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_layer_function_gradcheck(rng, reverse):
    """The layer's Function: the plain twin as the kernel, the chunked twin
    (chunks of 3 over T = 7) as the backward, the carry differentiated;
    (h_T, c_T) carry no gradient."""
    x, wx, wh, b = _f64(lstm_inputs(rng, 2, 7, 3, 2))
    h0, c0 = _f64((rand(rng, 2, 2, scale=0.5), rand(rng, 2, 2, scale=0.5)))

    def fn(x, wx, wh, b, h0, c0):
        ys, (h, c) = kernel_call(
            lambda *a: lstm._reference(*a[:4], reverse, *a[4:]),
            lambda *a: lstm._chunked_reference(*a[:4], reverse, *a[4:],
                                               chunk=3),
            x, wx, wh, b, h0, c0, no_grad_outputs=(1, 2))
        assert not h.requires_grad and not c.requires_grad
        return ys

    assert torch.autograd.gradcheck(fn, (x, wx, wh, b, h0, c0), atol=1e-6,
                                     rtol=1e-4)


def test_packed_and_integer_arguments_get_no_gradient(rng):
    """What the kernel closes over (a pack built with grad, a dilation) is
    no input of the Function: it gets no gradient, while the inputs do."""
    x = torch.from_numpy(rand(rng, 1, 4, 2, 4)).requires_grad_()
    params = tuple(torch.from_numpy(p).requires_grad_()
                   for p in dsconv_params(rng, 4, 4, 1))
    packed = params[2] * 2.0  # a pack with a graph to the weights

    def kernel(x, p):
        assert not torch.is_grad_enabled()
        return dsconv._reference(x, p, 2, 1, 1) + packed.sum()

    out = kernel_call(kernel, lambda x, p: dsconv._reference(x, p, 2, 1, 1),
                      x, params)
    assert out.grad_fn is not None
    g = torch.from_numpy(rand(rng, *out.shape))
    out.backward(g)
    want = torch.autograd.grad(dsconv._reference(x, params, 2, 1, 1),
                               (x, params[2]), g)
    torch.testing.assert_close(x.grad, want[0])
    # the kernel's use of the pack adds nothing: w1's gradient is the
    # twin's alone (through the pack it would gain 2 * sum(g))
    torch.testing.assert_close(params[2].grad, want[1])


def test_kernel_call_without_grad_is_the_kernel(rng):
    q, k, v = (torch.from_numpy(a) for a in att_inputs(rng, 1, 2, 3))
    calls = []

    def kernel(*a):
        calls.append(1)
        return attention._reference(*a, 0.5)

    out = kernel_call(kernel, None, q, k, v)
    assert out.grad_fn is None and calls == [1]
    with torch.no_grad():
        out = kernel_call(kernel, None, q.requires_grad_(), k, v)
    assert out.grad_fn is None and calls == [1, 1]


@pytest.mark.parametrize("reverse", [False, True])
def test_chunked_lstm_twin_matches_jax_vjp(rng, reverse):
    """T = 70, chunk 32: two full chunks and a ragged one. se_tpu's
    `_scan_forward_chunked` runs forward only: reverse is its run on x
    flipped in time, its output flipped back."""
    x, wx, wh, b = lstm_inputs(rng, 5, 70, 6, 8)
    g = rand(rng, 5, 70, 8)

    def jfn(x, wx, wh, b):
        if reverse:
            return _scan_forward_chunked(x[:, ::-1], wx, wh, b, 32)[:, ::-1]
        return _scan_forward_chunked(x, wx, wh, b, 32)

    want, vjp = jax.vjp(jfn, *map(jnp.asarray, (x, wx, wh, b)))
    jgrads = vjp(jnp.asarray(g))
    tx, twx, twh, tb = (torch.from_numpy(a).requires_grad_()
                        for a in (x, wx, wh, b))
    got, _ = lstm._chunked_reference(tx, twx, twh, tb, reverse)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    for t, jg in zip((tx, twx, twh, tb), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg),
                                   atol=1e-5)


def _saved_bytes(fn, *args) -> int:
    """The bytes of the storages autograd keeps for the backward of
    `fn(*args)`, each storage once (a checkpointed region keeps its
    inputs, views of x among them, not what it computes)."""
    storages = {}

    def pack(t):
        st = t.untyped_storage()
        storages[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(*args)
    return sum(storages.values())


def test_chunked_lstm_twin_saves_no_t_by_4h_gates(rng):
    """From T = 70 to 140 the plain twin's graph grows by more than the
    added frames' gates (Bf x 70 x 4H floats); the chunked twin's by less
    than a quarter of that (the added frames of x, In = 6 a frame, and
    the chunks' boundary carries)."""
    bf, in_dim, h = 4, 6, 16
    plain, chunked = [], []
    for t_len in (70, 140):
        args = [torch.from_numpy(a).requires_grad_()
                for a in lstm_inputs(rng, bf, t_len, in_dim, h)]
        plain.append(_saved_bytes(lstm._reference, *args))
        chunked.append(_saved_bytes(lstm._chunked_reference, *args))
    gates = 4 * bf * 70 * 4 * h
    assert plain[1] - plain[0] > gates
    assert chunked[1] - chunked[0] < gates / 4


def test_stft_fused_refuses_an_input_that_requires_grad():
    x = torch.zeros(1, 1600, requires_grad=True)
    with pytest.raises(ValueError, match="no gradient"):
        stft_fused.stft_fused(x, plain_stft.PRESET_320)
    with torch.no_grad():
        re, _ = stft_fused.stft_fused(x, plain_stft.PRESET_320)
    assert re.shape == (1, 11, 161)
