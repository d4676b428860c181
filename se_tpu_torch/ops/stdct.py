"""Short-time discrete cosine transform, the front end of DeepXi's
STDCTXiCD input/target: the port of se_tpu/ops/stdct.py (ref
DeepXi/deepxi/dct.py:18-117).

DCT-II and DCT-III as matmuls with scipy's norm=None scaling (the forward
carries the factor 2, idct(dct(x)) == 2 N x), a hann or hamming window,
optional pad_end framing (`ops.stft.frame_signal`) and the overlap-add
inverse (`ops.stft.overlap_add`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from se_tpu_torch.ops.stft import StftConfig, frame_signal, overlap_add
from se_tpu_torch.ops.windows import get_window


@functools.lru_cache(maxsize=None)
def _dct2_matrix(n: int) -> np.ndarray:
    """(N, N) with y = x @ C: y[k] = 2 sum_n x[n] cos(pi k (2n+1) / 2N)."""
    k = np.arange(n)
    c = 2.0 * np.cos(np.pi * np.outer(2 * k + 1, k) / (2.0 * n))
    return c.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dct3_matrix(n: int) -> np.ndarray:
    """(N, N) with x = y @ C: x[n] = y[0] + 2 sum_{k>=1} y[k] cos(...)."""
    k = np.arange(n)
    c = 2.0 * np.cos(np.pi * np.outer(k, 2 * k + 1) / (2.0 * n))
    c[0] *= 0.5
    return c.astype(np.float32)


def _const(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(arr).to(device=like.device, dtype=like.dtype)


def stdct(x: torch.Tensor, frame_length: int, frame_step: int,
          fft_length: int | None = None, window: str | None = "hann",
          pad_end: bool = False) -> torch.Tensor:
    """(..., n) -> (..., T, fft_length) short-time DCT-II coefficients."""
    n_fft = fft_length or frame_length
    cfg = StftConfig(frame_length, frame_step, n_fft,
                     convention="pad_end" if pad_end else "valid")
    frames = frame_signal(x, cfg)[..., :frame_length]
    if window is not None:
        frames = frames * _const(get_window(window, frame_length), frames)
    if n_fft > frame_length:
        frames = F.pad(frames, (0, n_fft - frame_length))
    return frames @ _const(_dct2_matrix(n_fft), frames)


def inverse_stdct(coeffs: torch.Tensor, frame_length: int, frame_step: int,
                  fft_length: int | None = None,
                  window: str | None = "hann",
                  length: int | None = None) -> torch.Tensor:
    """(..., T, fft_length) -> (..., n): DCT-III, window, overlap-add."""
    n_fft = fft_length or coeffs.shape[-1]
    frames = (coeffs @ _const(_dct3_matrix(n_fft), coeffs))[..., :frame_length]
    if frames.shape[-1] < frame_length:
        frames = F.pad(frames, (0, frame_length - frames.shape[-1]))
    if window is not None:
        frames = frames * _const(get_window(window, frame_length), frames)
    out = overlap_add(frames, frame_step)
    return out if length is None else out[..., :length]
