"""se_tpu_torch's features, STFT helpers, mel filterbanks,
ChannelWiseLayerNorm and native wav reader against se_tpu's, on the CPU
(as tests/test_ops_extra.py and tests/test_data_enhance.py test
se_tpu's own).

- The five torch feature functions (mag_phase, pre_emphasis,
  splice_feature in both ops, compute_ipd, compute_lps), overlap_cat and
  the three STFT helpers (stft_magphase at three presets, compress_mag,
  decompress_mag): within 1e-5 of se_tpu's, relative and absolute; the
  phase (cos, sin) of stft_magphase times the magnitude within 1e-5 of
  the largest magnitude: a bin's phase is as uncertain as the two STFTs'
  round-off over its magnitude (3e-5 apart at 2e-3 of the largest).
- The numpy copies (norm_amplitude, tailor_db_fs, is_clipped, subsample,
  aligned_subsample, activity_detector, speed_perturb_filter) and ops/mel.py:
  equal to se_tpu's, bit for bit.
- ChannelWiseLayerNorm with weights off their defaults, the port's weight
  as se_tpu's scale: 1e-5.
- The native reader built from the port's copy of wavio.cc: wav_decode
  equal to the port's pure-Python parser and to se_tpu's (both paths) at
  16-bit, 24-bit and float32; rms_gain within 1e-5 of the Python gain and
  of se_tpu's native one; resample's native path within 1e-5 of scipy's
  and equal to se_tpu's native one; `data.wav.PATHS` counts the path each
  call took, and a missing g++ sends every call down the Python path.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_tpu.data import wav as jwav
from se_tpu.nn.norms import ChannelWiseLayerNorm as JChannelWiseLayerNorm
from se_tpu.ops import features as JF
from se_tpu.ops import mel as jmel
from se_tpu.runtime import native as jnative
from se_tpu_torch.data import wav
from se_tpu_torch.nn import ChannelWiseLayerNorm
from se_tpu_torch.ops import features as F
from se_tpu_torch.ops import mel
from se_tpu_torch.ops import stft as tstft
from se_tpu_torch.runtime import native

j_stft = importlib.import_module("se_tpu.ops.stft")


def _close(got, want, tol=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _both(x: np.ndarray):
    return torch.from_numpy(x), jnp.asarray(x)


def test_mag_phase_and_lps(rng):
    re, im = (rng.standard_normal((2, 7, 9)).astype(np.float32)
              for _ in range(2))
    (t_re, j_re), (t_im, j_im) = _both(re), _both(im)
    for got, want in zip(F.mag_phase(t_re, t_im), JF.mag_phase(j_re, j_im)):
        _close(got, want)
    mag = np.abs(re)
    _close(F.compute_lps(torch.from_numpy(mag)),
           JF.compute_lps(jnp.asarray(mag)))


@pytest.mark.parametrize("coeff", [0.97, 0.5])
def test_pre_emphasis(rng, coeff):
    t, j = _both(rng.standard_normal((3, 101)).astype(np.float32))
    _close(F.pre_emphasis(t, coeff), JF.pre_emphasis(j, coeff))


@pytest.mark.parametrize("lctx, rctx, sub, op", [
    (1, 1, 1, "cat"), (2, 0, 1, "stack"), (0, 3, 2, "cat"), (0, 0, 1, "cat")])
def test_splice_feature(rng, lctx, rctx, sub, op):
    t, j = _both(rng.standard_normal((2, 11, 4)).astype(np.float32))
    got = F.splice_feature(t, lctx, rctx, sub, op)
    want = JF.splice_feature(j, lctx, rctx, sub, op)
    assert tuple(got.shape) == want.shape
    _close(got, want)


def test_overlap_cat(rng):
    chunks = [rng.standard_normal((2, 8)).astype(np.float32) for _ in
              range(3)]
    _close(F.overlap_cat([torch.from_numpy(c) for c in chunks]),
           JF.overlap_cat([jnp.asarray(c) for c in chunks]))


def test_compute_ipd(rng):
    t, j = _both(rng.uniform(-np.pi, np.pi, (2, 4, 5, 6)).astype(np.float32))
    pairs = [(0, 1), (0, 2), (1, 3)]
    for got, want in zip(F.compute_ipd(t, pairs), JF.compute_ipd(j, pairs)):
        _close(got, want)


@pytest.mark.parametrize("preset", ["PRESET_320", "PRESET_512_256",
                                    "PRESET_UFORMER"])
def test_stft_magphase(rng, preset):
    x = (rng.standard_normal((2, 4000)) * 0.1).astype(np.float32)
    mag, cos, sin = (t.numpy() for t in tstft.stft_magphase(
        torch.from_numpy(x), getattr(tstft, preset)))
    j_mag, j_cos, j_sin = (np.asarray(t) for t in j_stft.stft_magphase(
        jnp.asarray(x), getattr(j_stft, preset)))
    _close(mag, j_mag)
    top = float(j_mag.max())
    for got, want in ((cos, j_cos), (sin, j_sin)):  # the phase, by magnitude
        np.testing.assert_allclose(mag * got, j_mag * want, rtol=0,
                                   atol=1e-5 * top)


@pytest.mark.parametrize("power", [0.5, 0.3])
def test_compress_decompress(rng, power):
    m = rng.standard_normal((3, 8)).astype(np.float32)  # negatives clamp
    t, j = _both(m)
    _close(tstft.compress_mag(t, power), j_stft.compress_mag(j, power))
    t, j = _both(np.abs(m))
    _close(tstft.decompress_mag(t, power), j_stft.decompress_mag(j, power))


def test_numpy_copies_equal_se_tpu(rng):
    y = (rng.standard_normal(16000) * 0.1).astype(np.float32)
    for got, want in ((F.norm_amplitude(y), JF.norm_amplitude(y)),
                      (F.norm_amplitude(y, 0.5), JF.norm_amplitude(y, 0.5)),
                      (F.tailor_db_fs(y, -30.0), JF.tailor_db_fs(y, -30.0))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert F.is_clipped(y * 20) == JF.is_clipped(y * 20) is True
    assert F.is_clipped(y) == JF.is_clipped(y) is False
    for n in (4000, 20000):
        np.testing.assert_array_equal(
            F.subsample(y, n, rng=np.random.default_rng(1)),
            JF.subsample(y, n, rng=np.random.default_rng(1)))
        got = F.aligned_subsample(y, 2 * y, n, rng=np.random.default_rng(2))
        want = JF.aligned_subsample(y, 2 * y, n,
                                    rng=np.random.default_rng(2))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert F.activity_detector(y) == JF.activity_detector(y)
    np.testing.assert_array_equal(F.speed_perturb_filter(16000, 17600),
                                  JF.speed_perturb_filter(16000, 17600))


@pytest.mark.parametrize("args, kw", [
    ((512,), dict(num_mels=80, num_bins=257)),
    ((960,), dict(num_mels=128, sr=48000)),
    ((400,), dict(round_pow_of_two=False, num_mels=40, fmin=20.0))])
def test_mel_equals_se_tpu(rng, args, kw):
    filt, inv = mel.mel_filter(*args, **kw), mel.inv_mel_filter(*args, **kw)
    np.testing.assert_array_equal(filt, jmel.mel_filter(*args, **kw))
    np.testing.assert_array_equal(inv, jmel.inv_mel_filter(*args, **kw))
    spec = np.abs(rng.standard_normal((2, 5, filt.shape[1]))).astype(
        np.float32)
    fbank = mel.apply_mel(spec, filt)
    np.testing.assert_array_equal(fbank, jmel.apply_mel(spec, filt))
    np.testing.assert_array_equal(mel.apply_inv_mel(fbank, inv),
                                  jmel.apply_inv_mel(fbank, inv))
    np.testing.assert_array_equal(mel.hz_to_mel([0.0, 700.0, 8000.0]),
                                  jmel.hz_to_mel([0.0, 700.0, 8000.0]))


def test_channel_wise_layer_norm(rng):
    x = (rng.standard_normal((2, 7, 12)) * 3 + 1).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(12)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(12)).astype(np.float32)
    norm = ChannelWiseLayerNorm(12)
    norm.load_state_dict({"weight": torch.from_numpy(scale),
                          "bias": torch.from_numpy(bias)})
    want = JChannelWiseLayerNorm().apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x))
    _close(norm(torch.from_numpy(x)).detach(), want)


def _write_pcm24(path, x: np.ndarray, sr: int) -> None:
    """A mono 24-bit PCM wav (the writers take 16 and 32 bits)."""
    import struct

    v = np.clip(np.round(x * (1 << 23)), -(1 << 23), (1 << 23) - 1)
    b = v.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(b)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 3, 3, 24)
    hdr += b"data" + struct.pack("<I", len(b))
    with open(path, "wb") as f:
        f.write(hdr + b)


@pytest.mark.parametrize("bits", [16, 24, 32])
def test_native_wav_decode(tmp_path, rng, bits):
    assert native.available(), native.status()
    assert native.status().startswith("native: ")
    x = (rng.standard_normal(8000) * 0.1).astype(np.float32)
    path = str(tmp_path / "n.wav")
    if bits == 24:
        _write_pcm24(path, x, 16000)
    else:
        wav.write_wav(path, x, 16000, bits=bits)
    wav.PATHS.clear()
    got, sr = wav.read_wav(path)
    plain, sr2 = wav.read_wav(path, prefer_native=False)
    assert wav.PATHS == {"read_wav native": 1, "read_wav python": 1}
    assert sr == sr2 == 16000
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, jwav.read_wav(path,
                                                     prefer_native=False)[0])
    if jnative.available():
        np.testing.assert_array_equal(got, jnative.wav_decode_native(path)[0])


def test_native_rms_gain_and_resample(rng):
    from se_tpu_torch.data import rms_gain

    x = (rng.standard_normal(12345) * 0.1).astype(np.float32)
    g = native.rms_gain_native(x)
    np.testing.assert_allclose(g, rms_gain(x), rtol=1e-5)
    wav.PATHS.clear()
    got = wav.resample(x, 22050, 16000)
    want = wav.resample(x, 22050, 16000, prefer_native=False)
    assert wav.PATHS == {"resample native": 1, "resample python": 1}
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        want, jwav.resample(x, 22050, 16000, prefer_native=False), rtol=0,
        atol=1e-6)
    if jnative.available():
        np.testing.assert_allclose(g, jnative.rms_gain_native(x), rtol=1e-6)
        np.testing.assert_array_equal(
            got, jnative.resample_poly_native(x, 320, 441))


def test_without_gxx_every_call_takes_python(tmp_path, monkeypatch, rng):
    """No g++ and no library built: the build fails, `status` says why,
    and read_wav / resample take their Python paths."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "empty_build")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    x = (rng.standard_normal(4000) * 0.1).astype(np.float32)
    path = str(tmp_path / "p.wav")
    wav.write_wav(path, x, 16000)
    wav.PATHS.clear()
    got, _ = wav.read_wav(path)
    wav.resample(x, 16000, 8000)
    assert not native.available()
    assert native.status() == ("python: the native library is unavailable "
                               "(g++ not found)")
    assert wav.PATHS == {"read_wav python": 1, "resample python": 1}
    np.testing.assert_array_equal(got, jwav.read_wav(path,
                                                     prefer_native=False)[0])
