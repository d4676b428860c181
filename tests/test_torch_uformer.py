"""se_tpu_torch's Uformer against se_tpu's on the CPU.

JAX variables are drawn from a seed (numpy, on the tree `Uformer.init`
would make, with BN statistics and LN/PReLU parameters moved off their
defaults), carried into the port by `from_jax_variables`, and the same
waveforms go through both. All four outputs are compared, with
`compressed` False and True, at T = 26 and T = 66 frames. Tolerance
1e-4 absolute and relative on outputs of magnitude up to ~5: the two sides
run the same fp32 math with sums in another order (measured max error
~4e-6), well inside the reference-parity test's 2e-3 / 1e-2
(tests/test_long_sequence_parity.py).
"""

import jax
import numpy as np
import pytest
import torch

from se_tpu.eval.enhance import enhance_waveform as j_enhance_waveform
from se_tpu.models.uformer import Uformer as JUformer
from se_tpu.models.uformer import from_reference_state_dict
from se_tpu_torch.eval.enhance import enhance_waveform
from se_tpu_torch.models.uformer import Uformer, from_jax_variables

TOL = dict(atol=1e-4, rtol=1e-4)


def jax_variables(seed: int) -> dict:
    """se_tpu Uformer variables from a numpy seed: conv/dense kernels
    U(+-1/sqrt(fan_in)), biases U(+-0.1), LN/BN scales 1 + N(0, 0.1),
    PReLU slopes 0.25 + N(0, 0.05), BN means N(0, 0.1), vars U(0.5, 1.5)."""
    x = np.zeros((1, 1600), np.float32)
    shapes = jax.eval_shape(JUformer().init, jax.random.PRNGKey(0), x, x)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
            arr = rng.uniform(-bound, bound, shape)
        elif name == "bias":
            arr = rng.uniform(-0.1, 0.1, shape)
        elif name == "scale":
            arr = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "weight":
            arr = 0.25 + 0.05 * rng.standard_normal(shape)
        elif name == "mean":
            arr = 0.1 * rng.standard_normal(shape)
        elif name == "var":
            arr = rng.uniform(0.5, 1.5, shape)
        else:
            raise KeyError(name)
        return np.asarray(arr, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def weights():
    variables = jax_variables(0)
    return variables, from_jax_variables(variables)


def _port(state_dict, compressed=False):
    model = Uformer(compressed=compressed, device="cpu")
    model.load_state_dict(state_dict)
    return model.eval()


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("n", [4000, 10400])
def test_uformer_matches_jax(weights, n, compressed):
    variables, sd = weights
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((1, n)) * 0.1).astype(np.float32)
    s = (rng.standard_normal((1, n)) * 0.1).astype(np.float32)
    est, src_rt, (o_re, o_im), (s_re, s_im) = jax.jit(
        JUformer(compressed=compressed).apply)(variables, x, s)
    with torch.no_grad():
        got = _port(sd, compressed)(torch.from_numpy(x), torch.from_numpy(s))
    want = (est, src_rt, o_re, o_im, s_re, s_im)
    got = (got[0], got[1], *got[2], *got[3])
    assert got[0].shape == (1, (n // 160) * 160)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_reference_state_dict_round_trip(weights):
    """se_tpu's loader of reference PyTorch checkpoints reads the port's
    state_dict back into exactly the JAX tree it came from."""
    variables, sd = weights
    port_sd = _port(sd).state_dict()
    back = from_reference_state_dict(
        {k: v.numpy() for k, v in port_sd.items()})
    want = dict(jax.tree_util.tree_leaves_with_path(variables))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]),
                                      np.asarray(leaf))


def test_enhance_waveform_matches_jax(weights):
    variables, sd = weights
    rng = np.random.default_rng(7)
    wav = (rng.standard_normal((2, 4000)) * 0.05).astype(np.float32)
    want = j_enhance_waveform("uformer", variables, wav, model=JUformer())
    got = enhance_waveform("uformer", _port(sd), wav, device="cpu")
    assert got.shape == wav.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    one = enhance_waveform("uformer", _port(sd), wav[0], device="cpu")
    np.testing.assert_allclose(one, got[0], **TOL)
