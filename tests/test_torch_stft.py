"""se_tpu_torch.ops.stft against se_tpu.ops.stft on the CPU: the same
numpy inputs through both, all five presets, all three conventions, both
synthesis norms, odd lengths and the round trip."""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_tpu.ops import windows as jwin
from se_tpu_torch.ops import stft as tst
from se_tpu_torch.ops import windows as twin

# se_tpu.ops re-exports the function `stft` under the module's name
jst = importlib.import_module("se_tpu.ops.stft")

PRESETS = ["PRESET_320", "PRESET_512_256", "PRESET_512_128",
           "PRESET_UFORMER", "PRESET_DEEPXI"]

# Both sides sum the same fp32 products in the same matmul formulation, but
# in different BLAS kernels: spectra of O(10) magnitude agree to ~1e-5.
ATOL = 5e-5


def _cfgs(name):
    jc, tc = getattr(jst, name), getattr(tst, name)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("n", [4000, 4321])
def test_stft_matches_jax(name, n):
    jc, tc = _cfgs(name)
    x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    want = jst.stft(jnp.asarray(x), jc)
    got = tst.stft(torch.from_numpy(x), tc)
    assert got[0].shape == want[0].shape
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


@pytest.mark.parametrize("name", PRESETS)
def test_istft_matches_jax_and_round_trips(name):
    jc, tc = _cfgs(name)
    n = 4321
    x = np.random.default_rng(1).standard_normal((2, n)).astype(np.float32)
    re, im = jst.stft(jnp.asarray(x), jc)
    want = np.asarray(jst.istft(re, im, jc, length=n))
    got = tst.istft(torch.from_numpy(np.array(re)),
                    torch.from_numpy(np.array(im)), tc, length=n).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    # round trip away from the edges the framing cannot reconstruct
    rt = tst.istft(*tst.stft(torch.from_numpy(x), tc), tc, length=n).numpy()
    lo, hi = tc.frame_len, n - tc.frame_len
    np.testing.assert_allclose(rt[:, lo:hi], x[:, lo:hi], atol=1e-4)


@pytest.mark.parametrize("convention", ["center", "pad_end", "valid"])
@pytest.mark.parametrize("norm", ["ola", "periodized"])
def test_conventions_and_synthesis_norms(convention, norm):
    jc = jst.StftConfig(win_length=400, hop=160, n_fft=512,
                        convention=convention, synthesis_norm=norm)
    tc = tst.StftConfig(win_length=400, hop=160, n_fft=512,
                        convention=convention, synthesis_norm=norm)
    n = 3999
    assert tst.num_frames(n, tc) == jst.num_frames(n, jc)
    x = np.random.default_rng(2).standard_normal((3, n)).astype(np.float32)
    np.testing.assert_array_equal(
        tst.frame_signal(torch.from_numpy(x), tc).numpy(),
        np.asarray(jst.frame_signal(jnp.asarray(x), jc)))
    re, im = jst.stft(jnp.asarray(x), jc)
    got = tst.istft(torch.from_numpy(np.array(re)),
                    torch.from_numpy(np.array(im)), tc, length=n).numpy()
    want = np.asarray(jst.istft(re, im, jc, length=n))
    # `valid` keeps the first and last hop, where the OLA envelope is the
    # window's squared tail (down to ~1e-9) and magnifies the ~1e-7
    # sum-order differences; compare the interior, where it is O(1)
    h = tc.hop
    np.testing.assert_allclose(got[:, h:-h], want[:, h:-h], atol=1e-5)


@pytest.mark.parametrize("name", ["hann", "hamming", "blackman", "sqrthann",
                                  "bartlett", "rect"])
@pytest.mark.parametrize("periodic", [True, False])
def test_windows_copy(name, periodic):
    np.testing.assert_array_equal(twin.get_window(name, 400, periodic),
                                  jwin.get_window(name, 400, periodic))


def test_overlap_add_matches_jax():
    frames = np.random.default_rng(3).standard_normal(
        (2, 7, 400)).astype(np.float32)
    np.testing.assert_allclose(
        tst.overlap_add(torch.from_numpy(frames), 160).numpy(),
        np.asarray(jst.overlap_add(jnp.asarray(frames), 160)), atol=1e-6)
