"""Objective metrics: SI-SDR, SNR/SDR, segmental SNR, LSD, STOI and eSTOI.
A copy of se_tpu/eval/metrics.py (numpy only), its resampling from the
port's data/wav.py.

The reference scores with MATLAB scripts plus the pesq/pystoi packages
(ref DeepXi/deepxi/model.py:342-460, deepxi/*.m); neither is available in
this image, so STOI/eSTOI are implemented here from the published algorithm
(Taal et al. 2011 / Jensen & Taal 2016) in numpy:

- resample to 10 kHz, 512-point frames with 256 hop (50%), hann;
- drop silent frames (energy 40 dB below the loudest frame);
- 15 one-third-octave bands starting at 150 Hz;
- STOI: per-band/segment (N=30) correlation of clipped, normalized
  envelopes; eSTOI: spectral-normalized segment correlations.
"""

from __future__ import annotations

import functools

import numpy as np

from se_tpu_torch.data.wav import resample

EPS = np.finfo(np.float64).eps


# ----------------------------------------------------------------- waveform

def si_sdr(est: np.ndarray, ref: np.ndarray) -> float:
    """Scale-invariant SDR (zero-mean), dB."""
    est = est - est.mean()
    ref = ref - ref.mean()
    alpha = np.dot(est, ref) / (np.dot(ref, ref) + EPS)
    target = alpha * ref
    noise = est - target
    return float(10 * np.log10((np.sum(target**2) + EPS) / (np.sum(noise**2) + EPS)))


def snr(est: np.ndarray, ref: np.ndarray) -> float:
    """Plain SNR (a.k.a. SDR without projection), dB."""
    noise = est - ref
    return float(10 * np.log10((np.sum(ref**2) + EPS) / (np.sum(noise**2) + EPS)))


def seg_snr(est: np.ndarray, ref: np.ndarray, frame: int = 256,
            hop: int = 128, min_db: float = -10.0, max_db: float = 35.0) -> float:
    """Segmental SNR with the usual [-10, 35] dB clamp."""
    n_frames = (len(ref) - frame) // hop + 1
    vals = []
    for i in range(n_frames):
        s = ref[i * hop : i * hop + frame]
        e = est[i * hop : i * hop + frame] - s
        val = 10 * np.log10((np.sum(s**2) + EPS) / (np.sum(e**2) + EPS))
        vals.append(np.clip(val, min_db, max_db))
    return float(np.mean(vals)) if vals else 0.0


def spectral_distortion(ref: np.ndarray, est: np.ndarray) -> np.ndarray:
    """Spectral Distortion (SD) in dB per frame over a-priori/posteriori SNR
    estimates of shape (frames, bins) (ref DeepXi/deepxi/spectral_distortion.m:8-23:
    floor at 1e-12, dB, RMS over the bin axis)."""
    ref = 10.0 * np.log10(np.maximum(ref, 1e-12))
    est = 10.0 * np.log10(np.maximum(est, 1e-12))
    return np.sqrt(np.mean((ref - est) ** 2, axis=-1))


def lsd(est: np.ndarray, ref: np.ndarray, n_fft: int = 512, hop: int = 256) -> float:
    """Log-spectral distance, dB."""
    def spec(x):
        n_frames = (len(x) - n_fft) // hop + 1
        idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
        frames = x[idx] * np.hanning(n_fft)
        return np.abs(np.fft.rfft(frames, axis=-1)) ** 2

    p_e, p_r = spec(est) + EPS, spec(ref) + EPS
    d = (10 * np.log10(p_e / p_r)) ** 2
    return float(np.mean(np.sqrt(np.mean(d, axis=-1))))


# --------------------------------------------------------------- STOI/eSTOI
#
# Conventions match the reference exactly (cross-validated against a literal
# transliteration of DeepXi/deepxi/stoi.m in tests/matlab_stoi.py):
# 256-sample frames, 128 hop, zero-padded 512-point FFT, MATLAB hanning
# (symmetric, no zero endpoints), frame starts 1:K:(len-N) (the frame ending
# exactly at the signal end is NOT taken), thirdoct trailing-band trim.
# eSTOI follows pystoi's extended path (the reference's eSTOI dependency,
# DeepXi/deepxi/model.py:415): row-then-column mean/variance normalization
# of (J, N) segments.

_FS = 10000
_N_FFT = 512
_FRAME = 256
_HOP = 128  # 50% of the 256 frame
_N_BANDS = 15
_MIN_FREQ = 150.0
_SEG = 30  # analysis segment length (frames)
_BETA_DB = -15.0
_DYN_RANGE = 40.0


def _hanning_matlab(n: int) -> np.ndarray:
    """MATLAB hanning(N): symmetric Hann without the zero endpoints."""
    k = np.arange(1, n + 1, dtype=np.float64)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * k / (n + 1)))


def _frame_starts(n_samples: int) -> np.ndarray:
    """0-based starts of MATLAB's frames = 1:K:(length(x)-N)."""
    last = n_samples - _FRAME
    if last < 1:
        return np.zeros((0,), np.int64)
    return np.arange(0, last, _HOP, dtype=np.int64)


@functools.lru_cache(maxsize=1)
def _third_octave_bands() -> np.ndarray:
    """(J, 257) one-third-octave band matrix at 10 kHz / 512-point FFT,
    including stoi.m:118-121's trailing-band trim (no-op at these params)."""
    f = np.linspace(0, _FS, _N_FFT + 1)[: _N_FFT // 2 + 1]
    k = np.arange(_N_BANDS)
    cf = _MIN_FREQ * np.power(2.0, k / 3.0)
    lo = cf * 2 ** (-1.0 / 6.0)
    hi = cf * 2 ** (1.0 / 6.0)
    bands = np.zeros((_N_BANDS, len(f)))
    for i in range(_N_BANDS):
        lo_idx = np.argmin((f - lo[i]) ** 2)
        hi_idx = np.argmin((f - hi[i]) ** 2)
        bands[i, lo_idx:hi_idx] = 1.0
    rnk = bands.sum(axis=1)
    cond = (rnk[1:] >= rnk[:-1]) & (rnk[1:] != 0)
    idx = np.nonzero(cond)[0]
    nb = (idx[-1] + 2) if len(idx) else 1
    return bands[:nb]


def _stft_frames(x: np.ndarray) -> np.ndarray:
    starts = _frame_starts(len(x))
    if len(starts) == 0:
        return np.zeros((0, _N_FFT // 2 + 1))
    idx = starts[:, None] + np.arange(_FRAME)[None, :]
    frames = x[idx] * _hanning_matlab(_FRAME)
    return np.abs(np.fft.rfft(frames, n=_N_FFT, axis=-1))


def _remove_silent_frames(x: np.ndarray, y: np.ndarray):
    starts = _frame_starts(len(x))
    if len(starts) == 0:
        return x, y
    idx = starts[:, None] + np.arange(_FRAME)[None, :]
    w = _hanning_matlab(_FRAME)
    energies = 20 * np.log10(
        np.linalg.norm(x[idx] * w, axis=1) / np.sqrt(_FRAME) + EPS)
    mask = (energies - energies.max() + _DYN_RANGE) > 0
    if not mask.any():
        return x, y
    xf = (x[idx] * w)[mask]
    yf = (y[idx] * w)[mask]
    count = int(mask.sum())
    n_out = (count - 1) * _HOP + _FRAME
    xs = np.zeros(n_out)
    ys = np.zeros(n_out)
    out_idx = (np.arange(count)[:, None] * _HOP
               + np.arange(_FRAME)[None, :]).ravel()
    np.add.at(xs, out_idx, xf.ravel())
    np.add.at(ys, out_idx, yf.ravel())
    return xs, ys


def _band_envelopes(x: np.ndarray) -> np.ndarray:
    spec = _stft_frames(x)  # (T, 257)
    bands = _third_octave_bands()
    return np.sqrt((spec**2) @ bands.T)  # (T, J)


def _segments(x: np.ndarray) -> np.ndarray:
    """(T, J) envelopes -> (n_seg, J, N) sliding segments of length N."""
    t = x.shape[0]
    n_seg = t - _SEG + 1
    return np.lib.stride_tricks.sliding_window_view(
        x, _SEG, axis=0)  # (n_seg, J, N)


def stoi(est: np.ndarray, ref: np.ndarray, fs: int = 16000,
         extended: bool = False) -> float:
    """Short-time objective intelligibility in [0, 1]. ref = clean."""
    if fs != _FS:
        est = resample(est.astype(np.float64), fs, _FS)
        ref = resample(ref.astype(np.float64), fs, _FS)
    ref, est = _remove_silent_frames(np.asarray(ref, np.float64),
                                     np.asarray(est, np.float64))
    x = _band_envelopes(ref)  # clean (T, J)
    y = _band_envelopes(est)  # degraded
    t = x.shape[0]
    if t < _SEG:
        return float("nan")
    xs = _segments(x)  # (n_seg, J, N)
    ys = _segments(y)

    if extended:
        def norm_rows_cols(a):
            a = a - a.mean(axis=-1, keepdims=True)
            a = a / (np.sqrt(np.sum(a**2, axis=-1, keepdims=True)) + EPS)
            a = a - a.mean(axis=1, keepdims=True)
            a = a / (np.sqrt(np.sum(a**2, axis=1, keepdims=True)) + EPS)
            return a

        xn = norm_rows_cols(xs)
        yn = norm_rows_cols(ys)
        return float(np.sum(xn * yn) / _SEG / xs.shape[0])

    alpha = np.sqrt(np.sum(xs**2, axis=-1, keepdims=True)
                    / (np.sum(ys**2, axis=-1, keepdims=True) + EPS))
    ysa = np.minimum(ys * alpha, xs * (1.0 + 10.0 ** (-_BETA_DB / 20.0)))
    xm = xs - xs.mean(axis=-1, keepdims=True)
    ym = ysa - ysa.mean(axis=-1, keepdims=True)
    corr = np.sum(xm * ym, axis=-1) / (
        np.linalg.norm(xm, axis=-1) * np.linalg.norm(ym, axis=-1) + EPS)
    return float(corr.mean())


def estoi(est: np.ndarray, ref: np.ndarray, fs: int = 16000) -> float:
    return stoi(est, ref, fs, extended=True)
