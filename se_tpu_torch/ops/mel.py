"""Mel filterbanks and inverse (ref: Uformer/trans.py:98-183, 611-743): a
copy of se_tpu/ops/mel.py (numpy only; the port imports nothing of
se_tpu).

Reproduces librosa.filters.mel(htk=True) numerics (the reference's init) in
plain numpy: HTK mel scale, triangular weights, optional slaney area norm.
The transforms themselves are single matmuls over the frequency axis.
"""

from __future__ import annotations

import functools

import numpy as np


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (np.power(10.0, np.asarray(m, np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def mel_filter(
    frame_len: int,
    round_pow_of_two: bool = True,
    num_bins: int | None = None,
    sr: int = 16000,
    num_mels: int = 80,
    fmin: float = 0.0,
    fmax: float | None = None,
    norm: bool = False,
) -> np.ndarray:
    """(num_mels, N//2+1) filterbank matching trans.py:98-139 semantics."""
    if num_bins is None:
        n = 2 ** int(np.ceil(np.log2(frame_len))) if round_pow_of_two else frame_len
    else:
        n = (num_bins - 1) * 2
    upper = sr // 2
    fmax = upper if fmax is None else min(fmax + upper if fmax < 0 else fmax, upper)
    fmin = max(0.0, fmin)

    fftfreqs = np.linspace(0, sr / 2.0, n // 2 + 1)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), num_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    weights = np.zeros((num_mels, len(fftfreqs)))
    for i in range(num_mels):
        lower = -ramps[i] / fdiff[i]
        upper_r = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0.0, np.minimum(lower, upper_r))
    if norm:  # slaney area normalization
        enorm = 2.0 / (hz_pts[2 : num_mels + 2] - hz_pts[:num_mels])
        weights *= enorm[:, None]
    return weights.astype(np.float32)


def inv_mel_filter(*args, **kwargs) -> np.ndarray:
    """Pseudo-inverse filterbank (ref trans.py:141-183)."""
    return np.linalg.pinv(mel_filter(*args, **kwargs)).astype(np.float32)


def apply_mel(linear, filters):
    """(..., T, F) linear spectrogram -> (..., T, M) fbank (matmul)."""
    return linear @ filters.T


def apply_inv_mel(fbank, inv_filters):
    """(..., T, M) -> (..., T, F) via the (F, M) pinv filterbank."""
    return fbank @ inv_filters.T
