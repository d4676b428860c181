"""se_tpu_torch's FullSubNet and its cirm decode branch against se_tpu's on
the CPU.

JAX variables at narrow widths (fb_hidden 32, sb_hidden 24, all 257 bins)
are drawn from a numpy seed, carried into the port by `from_jax_variables`,
and the same inputs go through both. The port's state_dict also goes back
through se_tpu's reference loader. Tolerance 1e-4 absolute and relative:
the two sides run the same fp32 math with sums in another order.
"""

import jax
import numpy as np
import pytest
import torch

from se_tpu.eval.enhance import enhance_waveform as j_enhance_waveform
from se_tpu.models import fullsubnet as jfs
from se_tpu_torch.eval.enhance import enhance_waveform
from se_tpu_torch.models import fullsubnet as fs
from se_tpu_torch.models import get_model

TOL = dict(atol=1e-4, rtol=1e-4)
WIDTHS = dict(fb_hidden=32, sb_hidden=24)


def jax_variables(seed: int) -> dict:
    """se_tpu FullSubNet variables from a numpy seed: LSTM weights and
    biases U(+-1/sqrt(H)), dense kernels U(+-1/sqrt(fan_in)), biases
    U(+-0.1)."""
    mag = np.zeros((1, 4, 257), np.float32)
    shapes = jax.eval_shape(jfs.FullSubNet(**WIDTHS).init,
                            jax.random.PRNGKey(0), mag)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name.endswith(("_wx", "_wh", "_b")):
            h = shape[-1] // 4
            arr = rng.uniform(-h ** -0.5, h ** -0.5, shape)
        elif name == "kernel":
            arr = rng.uniform(-shape[0] ** -0.5, shape[0] ** -0.5, shape)
        elif name == "bias":
            arr = rng.uniform(-0.1, 0.1, shape)
        else:
            raise KeyError(name)
        return np.asarray(arr, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def weights():
    variables = jax_variables(0)
    return variables, fs.from_jax_variables(variables)


def _port(state_dict):
    model = fs.FullSubNet(**WIDTHS, device="cpu")
    model.load_state_dict(state_dict)
    return model.eval()


@pytest.mark.parametrize("t", [5, 21])
def test_fullsubnet_matches_jax(weights, t):
    variables, sd = weights
    rng = np.random.default_rng(t)
    mag = np.abs(rng.standard_normal((2, t, 257))).astype(np.float32)
    want = jax.jit(jfs.FullSubNet(**WIDTHS).apply)(variables, mag)
    with torch.no_grad():
        got = _port(sd)(torch.from_numpy(mag))
    assert got.shape == (2, t, 257, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_reference_state_dict_round_trip(weights):
    """se_tpu's loader of reference checkpoints reads the port's
    state_dict into the JAX tree it came from (the bias split into
    bias_ih + zero bias_hh sums back to se_tpu's combined bias)."""
    variables, sd = weights
    port_sd = {k: v.numpy() for k, v in _port(sd).state_dict().items()}
    back = jfs.from_reference_state_dict(port_sd)
    want = dict(jax.tree_util.tree_leaves_with_path(variables))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf))


@pytest.mark.parametrize("n", [1, 15])
def test_unfold_subband_matches_jax(rng, n):
    x = rng.standard_normal((2, 3, 33)).astype(np.float32)
    got = fs.unfold_subband(torch.from_numpy(x), n)
    assert got.shape == (2, 3, 33, 2 * n + 1)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jfs.unfold_subband(x, n)))


@pytest.mark.parametrize("groups", [1, 2, 3])
def test_drop_band_matches_jax(rng, groups):
    x = rng.standard_normal((6, 3, 11, 4)).astype(np.float32)
    got = fs.drop_band(torch.from_numpy(x), groups)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jfs.drop_band(x, groups)))


def test_laplace_norms_match_jax(rng):
    x = np.abs(rng.standard_normal((2, 7, 9))).astype(np.float32)
    tx = torch.from_numpy(x)
    np.testing.assert_allclose(fs.offline_laplace_norm(tx).numpy(),
                               np.asarray(jfs.offline_laplace_norm(x)), **TOL)
    np.testing.assert_allclose(fs.cumulative_laplace_norm(tx).numpy(),
                               np.asarray(jfs.cumulative_laplace_norm(x)),
                               **TOL)


@pytest.mark.parametrize("compressed", [True, False])
def test_enhance_waveform_matches_jax(weights, compressed):
    variables, sd = weights
    rng = np.random.default_rng(3)
    wav = (rng.standard_normal((2, 4000)) * 0.05).astype(np.float32)
    want = j_enhance_waveform("fullsubnet", variables, wav,
                              compressed=compressed,
                              model=jfs.FullSubNet(**WIDTHS))
    got = enhance_waveform("fullsubnet", _port(sd), wav,
                           compressed=compressed, device="cpu")
    assert got.shape == wav.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    one = enhance_waveform("fullsubnet", _port(sd), wav[1],
                           compressed=compressed, device="cpu")
    np.testing.assert_allclose(one, got[1], **TOL)


def test_registry_entry():
    entry = get_model("fullsubnet")
    assert entry.make is fs.FullSubNet and entry.io_kind == "cirm"
    assert (entry.stft.win_length, entry.stft.hop) == (512, 256)
    assert entry.from_jax_variables is fs.from_jax_variables
