"""Composite objective measures: LLR, WSS, segmental SNR, CSIG/CBAK/COVL.
A copy of se_tpu/eval/composite.py (numpy and scipy only).

Fresh numpy implementation of the measures defined in the reference's
MATLAB scorer (ref DeepXi/deepxi/composite.m — the Hu & Loizou composite
measures): per-frame LLR via Levinson-Durbin LPC, Klatt's weighted
spectral slope over 25 Gaussian critical bands, clamped segmental SNR, and
the linear regressions

    CSIG = 3.093 - 1.029*LLR  + 0.603*PESQ - 0.009*WSS
    CBAK = 1.634 + 0.478*PESQ - 0.007*WSS  + 0.063*segSNR
    COVL = 1.594 + 0.805*PESQ - 0.512*LLR  - 0.007*WSS

clipped to [1, 5]. PESQ itself is not re-implemented here; pass `pesq_mos`
from the `pesq` package when available (`composite(..., pesq_mos=...)`), or
use `llr_wss_segsnr` directly.
"""

from __future__ import annotations

import numpy as np

_CENT_FREQ = np.array([
    50.0, 120.0, 190.0, 260.0, 330.0, 400.0, 470.0, 540.0, 617.372,
    703.378, 798.717, 904.128, 1020.38, 1148.30, 1288.72, 1442.54,
    1610.70, 1794.16, 1993.93, 2211.08, 2446.71, 2701.97, 2978.04,
    3276.17, 3597.63,
])
_BANDWIDTH = np.array([
    70.0, 70.0, 70.0, 70.0, 70.0, 70.0, 70.0, 77.3724, 86.0056, 95.3398,
    105.411, 116.256, 127.914, 140.423, 153.823, 168.154, 183.457,
    199.776, 217.153, 235.631, 255.255, 276.072, 298.126, 321.465,
    346.136,
])


def _frames(x, winlength, skiprate):
    num = int(len(x) / skiprate - winlength / skiprate)
    # MATLAB's 1-based "window" is 0.5*(1-cos(2*pi*(1:N)/(N+1)))
    idx = np.arange(1, winlength + 1)
    window = 0.5 * (1 - np.cos(2 * np.pi * idx / (winlength + 1)))
    return num, window


def _lpc(frame, order):
    """Autocorrelation + Levinson-Durbin, matching composite.m:384-414."""
    n = len(frame)
    r = np.array([np.sum(frame[: n - k] * frame[k:]) for k in range(order + 1)])
    a = np.zeros(order)
    e = r[0]
    for i in range(order):
        if i == 0:
            sum_term = 0.0
        else:
            sum_term = np.sum(a[:i] * r[i:0:-1])
        rc = (r[i + 1] - sum_term) / e if e != 0 else 0.0
        a_past = a[:i].copy()
        a[i] = rc
        if i > 0:
            a[:i] = a_past - rc * a_past[::-1]
        e = (1 - rc * rc) * e
    return r, np.concatenate(([1.0], -a))


def llr(clean, processed, fs: int) -> np.ndarray:
    """Per-frame log-likelihood ratio (composite.m:315-382)."""
    order = 10 if fs < 10000 else 16
    winlength = round(30 * fs / 1000)
    skiprate = winlength // 4
    num, window = _frames(clean, winlength, skiprate)
    out = np.empty(num)
    start = 0
    for i in range(num):
        cf = clean[start : start + winlength] * window
        pf = processed[start : start + winlength] * window
        r_c, a_c = _lpc(cf, order)
        _, a_p = _lpc(pf, order)
        from scipy.linalg import toeplitz

        rmat = toeplitz(r_c)
        num_ = a_p @ rmat @ a_p
        den_ = a_c @ rmat @ a_c
        out[i] = np.log(num_ / den_)
        start += skiprate
    return out


def wss(clean, processed, fs: int) -> np.ndarray:
    """Per-frame weighted spectral slope (composite.m:85-313)."""
    winlength = round(30 * fs / 1000)
    skiprate = winlength // 4
    max_freq = fs / 2
    num_crit = 25
    n_fft = 2 ** int(np.ceil(np.log2(2 * winlength)))
    n_half = n_fft // 2
    kmax, klocmax = 20.0, 1.0

    min_factor = np.exp(-30.0 / (2.0 * 2.303))
    j = np.arange(n_half)
    crit = np.zeros((num_crit, n_half))
    bw_min = _BANDWIDTH[0]
    for i in range(num_crit):
        f0 = np.floor((_CENT_FREQ[i] / max_freq) * n_half)
        bw = (_BANDWIDTH[i] / max_freq) * n_half
        norm = np.log(bw_min) - np.log(_BANDWIDTH[i])
        filt = np.exp(-11 * ((j - f0) / bw) ** 2 + norm)
        crit[i] = filt * (filt > min_factor)

    num, window = _frames(clean, winlength, skiprate)
    out = np.empty(num)
    start = 0
    for fidx in range(num):
        cf = clean[start : start + winlength] * window
        pf = processed[start : start + winlength] * window
        c_spec = np.abs(np.fft.fft(cf, n_fft)) ** 2
        p_spec = np.abs(np.fft.fft(pf, n_fft)) ** 2
        c_e = np.array([max(c_spec[:n_half] @ crit[i], 1e-10)
                        for i in range(num_crit)])
        p_e = np.array([max(p_spec[:n_half] @ crit[i], 1e-10)
                        for i in range(num_crit)])
        c_e = 10 * np.log10(c_e)
        p_e = 10 * np.log10(p_e)
        c_slope = np.diff(c_e)
        p_slope = np.diff(p_e)

        def loc_peaks(energy, slope):
            # composite.m:235-268. NOTE the right search records
            # energy[n-1], one band short of the actual local max — a
            # reference quirk preserved for parity (cross-validated
            # against tests/matlab_composite.py).
            peaks = np.empty(num_crit - 1)
            for i in range(num_crit - 1):
                if slope[i] > 0:
                    n = i
                    while n < num_crit - 1 and slope[n] > 0:
                        n += 1
                    peaks[i] = energy[n - 1]
                else:
                    n = i
                    while n >= 0 and slope[n] <= 0:
                        n -= 1
                    peaks[i] = energy[n + 1]
            return peaks

        c_peak = loc_peaks(c_e, c_slope)
        p_peak = loc_peaks(p_e, p_slope)
        w_c = (kmax / (kmax + c_e.max() - c_e[:-1])) * (
            klocmax / (klocmax + c_peak - c_e[:-1]))
        w_p = (kmax / (kmax + p_e.max() - p_e[:-1])) * (
            klocmax / (klocmax + p_peak - p_e[:-1]))
        w = (w_c + w_p) / 2.0
        out[fidx] = np.sum(w * (c_slope - p_slope) ** 2) / np.sum(w)
        start += skiprate
    return out


def seg_snr_composite(clean, processed, fs: int) -> np.ndarray:
    """Frame SNR clamped to [-10, 35] dB (composite.m:420-485)."""
    winlength = round(30 * fs / 1000)
    skiprate = winlength // 4
    num, window = _frames(clean, winlength, skiprate)
    out = np.empty(num)
    start = 0
    for i in range(num):
        cf = clean[start : start + winlength] * window
        pf = processed[start : start + winlength] * window
        sig = np.sum(cf**2)
        noise = np.sum((cf - pf) ** 2)
        eps = np.finfo(np.float64).eps
        out[i] = np.clip(10 * np.log10(sig / (noise + eps) + eps),
                         -10.0, 35.0)
        start += skiprate
    return out


def llr_wss_segsnr(clean, processed, fs: int = 16000, alpha: float = 0.95):
    """Trimmed means as composite.m:43-64 computes them (incl. the +eps on
    both inputs and min-length truncation)."""
    eps = np.finfo(np.float64).eps
    n = min(len(clean), len(processed))
    clean = np.asarray(clean[:n], np.float64) + eps
    processed = np.asarray(processed[:n], np.float64) + eps
    w = np.sort(wss(clean, processed, fs))
    wss_mean = float(np.mean(w[: round(len(w) * alpha)]))
    l = np.sort(llr(clean, processed, fs))
    llr_mean = float(np.mean(l[: round(len(l) * alpha)]))
    seg = float(np.mean(seg_snr_composite(clean, processed, fs)))
    return llr_mean, wss_mean, seg


def composite(clean, processed, fs: int = 16000, pesq_mos: float | None = None):
    """Returns (CSIG, CBAK, COVL). If `pesq_mos` is None, tries the `pesq`
    package; raises if no PESQ source is available."""
    if pesq_mos is None:
        try:  # prefer the reference binary's python wrapper when present
            from pesq import pesq as _pesq

            pesq_mos = _pesq(fs, np.asarray(clean), np.asarray(processed),
                             "wb" if fs >= 16000 else "nb")
        except ImportError:
            from se_tpu_torch.eval.pesq import pesq as _our_pesq

            out = _our_pesq(np.asarray(clean), np.asarray(processed), fs)
            pesq_mos = out if fs >= 16000 else out[1]
    llr_mean, wss_mean, seg = llr_wss_segsnr(clean, processed, fs)
    csig = np.clip(3.093 - 1.029 * llr_mean + 0.603 * pesq_mos
                   - 0.009 * wss_mean, 1, 5)
    cbak = np.clip(1.634 + 0.478 * pesq_mos - 0.007 * wss_mean
                   + 0.063 * seg, 1, 5)
    covl = np.clip(1.594 + 0.805 * pesq_mos - 0.512 * llr_mean
                   - 0.007 * wss_mean, 1, 5)
    return float(csig), float(cbak), float(covl)
