"""Analysis windows.

Covers the window registry the reference zoo draws from
(ref: Uformer/trans.py:21-48 — bartlett/hann/hamming/blackman/rect/sqrthann;
torch.hann_window / tf.signal.hamming_window are periodic by default, which is
what every in-graph model uses; the librosa decode paths use periodic hann via
get_window('hann', fftbins=True)).

All windows are computed in float64 on host and returned as float32 numpy —
they are tiny constants folded into the DFT basis matrices.
"""

from __future__ import annotations

import numpy as np


def _cos_window(n: int, coeffs, periodic: bool) -> np.ndarray:
    """Generalized cosine window: sum_k coeffs[k] * cos(2*pi*k*t/denom)."""
    denom = n if periodic else n - 1
    t = np.arange(n, dtype=np.float64)
    w = np.zeros(n, dtype=np.float64)
    for k, c in enumerate(coeffs):
        w += c * np.cos(2.0 * np.pi * k * t / denom)
    return w


def get_window(name: str, n: int, periodic: bool = True) -> np.ndarray:
    """Return a window of length `n` as float32 numpy.

    `periodic=True` matches torch.hann_window / tf.signal windows /
    librosa fftbins=True; `periodic=False` gives the symmetric variant.
    """
    name = name.lower()
    if name in ("hann", "hanning"):
        w = _cos_window(n, [0.5, -0.5], periodic)
    elif name in ("hamm", "hamming"):
        w = _cos_window(n, [0.54, -0.46], periodic)
    elif name == "blackman":
        w = _cos_window(n, [0.42, -0.5, 0.08], periodic)
    elif name == "sqrthann":
        w = np.sqrt(_cos_window(n, [0.5, -0.5], periodic))
    elif name == "bartlett":
        denom = n if periodic else n - 1
        t = np.arange(n, dtype=np.float64)
        w = 1.0 - np.abs(2.0 * t / denom - 1.0)
    elif name in ("rect", "rectangular", "ones", "boxcar"):
        w = np.ones(n, dtype=np.float64)
    else:
        raise ValueError(f"unknown window: {name!r}")
    return w.astype(np.float32)
