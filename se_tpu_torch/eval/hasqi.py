"""HASQI v2 and HASPI v1 objective measures (numpy).
A copy of se_tpu/eval/hasqi.py (numpy only), its resampling from the
port's data/wav.py.

The reference publishes HASQI/HASPI result tables (README.md:42, Figure/t13)
but ships no code for them — the metrics come from Kates & Arehart's MATLAB
distribution, which is not redistributable and not present in this image.
This module implements the published algorithm structure:

- J. Kates & K. Arehart, "The Hearing-Aid Speech Quality Index (HASQI)
  Version 2", J. Audio Eng. Soc. 62(3), 2014.
- J. Kates & K. Arehart, "The Hearing-Aid Speech Perception Index (HASPI)",
  Speech Communication 65, 2014.

Shared auditory front end (the papers' `eb_EarModel`):
  resample to 24 kHz -> input alignment -> middle-ear bandpass ->
  32-channel 4th-order gammatone filterbank on an ERB scale (80-8000 Hz),
  with a control path (broadened bandwidth) driving level-dependent
  signal-path bandwidth and OHC dynamic-range compression (ratio 1.25->3.5
  across bands), IHC/OHC attenuation from the audiogram (zero for the
  normal-hearing scoring used in the survey tables), envelopes in dB SL and
  basilar-membrane (BM) vibration.

HASQI v2 = Nonlinear x Linear with
  Nonlinear = (cepstral correlation)^2 x high-level BM vibration correlation,
  Linear    = 1 - 0.579 |dLoud| - 0.421 |dSlope|  (long-term spectra).
HASPI v1 = logistic( -9.047 + 14.817 c + 0.0 a_low + 0.0 a_mid
                     + 4.616 a_high ) over cepstral correlation c and
three-level auditory coherence.

Fidelity vs the Kates & Arehart MATLAB distribution (round 2 upgrade):
- OHC compression gain is INSTANTANEOUS, computed per sample from the
  control-path envelope (clipped to the [knee, upper] range) and smoothed
  with a 1st-order 800 Hz lowpass, then applied multiplicatively to both
  the envelope and BM paths — the eb_EnvCompressBasic structure. (The
  MATLAB model applies the same smoothed gain to both paths; "shared gain"
  is the reference behavior, not a shortcut.)
- signal-path bandwidth broadening uses the control envelope's utterance
  RMS level, as eb_BWadjust does (bandwidth adjustment IS utterance-level
  in the reference model).
- input alignment is a single full-utterance lag — also the reference
  behavior (eb_EarModel aligns once).
- IHC firing-rate adaptation (eb_IHCadapt, round 3): the published
  two-capacitor RC equivalent circuit with rapid (2 ms) and short-term
  (60 ms) time constants and onset overshoot delta=2, applied to the dB-SL
  envelope with the matching gain applied to the BM path. The per-sample
  2-state recurrence is vectorized by eigen-decomposing the state matrix
  into two independent one-pole scans.
No numeric oracle exists in this image (the Kates code is not
redistributable); validation is behavioral, including hearing-loss
audiogram cases and the onset-overshoot property (tests/test_hasqi.py).
"""

from __future__ import annotations

import numpy as np

from se_tpu_torch.data.wav import resample

_FS = 24000.0
_NCHAN = 32
_SEG_MS = 16.0


# ------------------------------------------------------------- ear model

def _align(ref: np.ndarray, proc: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Coarse cross-correlation delay compensation, then equal lengths."""
    n = min(len(ref), len(proc))
    ref, proc = ref[:n], proc[:n]
    m = min(n, int(2.0 * _FS))  # align on the first 2 s
    f = np.fft.rfft(ref[:m], 2 * m)
    g = np.fft.rfft(proc[:m], 2 * m)
    xc = np.fft.irfft(f * np.conj(g), 2 * m)
    # irfft(F conj(G))[k] = sum_n ref[n+k] proc[n]: a proc delayed by d
    # peaks at k = -d (wrapped), so lag = d means "proc is d samples late"
    lag = -(int(np.argmax(np.concatenate([xc[-m // 2:], xc[:m // 2]])))
            - m // 2)
    if lag > 0:  # proc late -> advance it
        proc = np.concatenate([proc[lag:], np.zeros(lag)])
    elif lag < 0:  # proc early -> delay it
        proc = np.concatenate([np.zeros(-lag), proc[:lag]])
    return ref, proc


def _middle_ear(x: np.ndarray) -> np.ndarray:
    """1st-order LP at 5 kHz + 2nd-order HP at 350 Hz (bilinear IIR)."""
    from math import pi, tan

    # 1-pole lowpass y[n] = b0*(x[n]+x[n-1]) - a*y[n-1], applied by
    # convolution with its (truncated-at-1e-6) impulse response
    wc = tan(pi * 5000.0 / _FS)
    a = (wc - 1) / (wc + 1)
    b0 = wc / (1 + wc)
    n_ir = int(np.ceil(np.log(1e-6) / np.log(max(abs(a), 1e-9))))
    k = np.arange(n_ir)
    ir_lp = b0 * ((-a) ** k)
    ir_lp[1:] += b0 * ((-a) ** k[:-1])  # b0*(x[n]+x[n-1]) feedforward
    y = np.convolve(x, ir_lp)[: len(x)]

    # 2nd-order butterworth highpass at 350 Hz via bilinear transform
    w0 = tan(pi * 350.0 / _FS)
    q = 1.0 / np.sqrt(2.0)
    norm = w0 * w0 + w0 / q + 1.0
    b = np.array([1.0, -2.0, 1.0]) / norm
    a2 = np.array([1.0,
                   2.0 * (w0 * w0 - 1.0) / norm,
                   (w0 * w0 - w0 / q + 1.0) / norm])
    # recursive part: impulse response by polynomial division
    n_ir = 2048
    imp = np.zeros(n_ir)
    imp[0] = 1.0
    ir_hp = np.empty(n_ir)
    z1 = z2 = 0.0
    for i in range(n_ir):  # tiny fixed loop, fs-independent
        w = imp[i] - a2[1] * z1 - a2[2] * z2
        ir_hp[i] = b[0] * w + b[1] * z1 + b[2] * z2
        z2, z1 = z1, w
    return np.convolve(y, ir_hp)[: len(x)]


def _center_freqs(nchan: int = _NCHAN, low: float = 80.0,
                  high: float = 8000.0) -> np.ndarray:
    """ERB-spaced center frequencies (Moore & Glasberg)."""
    ear_q, min_bw = 9.26449, 24.7
    i = np.arange(1, nchan)
    cf = -(ear_q * min_bw) + np.exp(
        i * (-np.log(high + ear_q * min_bw)
             + np.log(low + ear_q * min_bw)) / (nchan - 1)
    ) * (high + ear_q * min_bw)
    cf = np.concatenate([[high], cf])
    return np.sort(cf)


def _erb(cf: np.ndarray) -> np.ndarray:
    return 24.7 * (4.37e-3 * cf + 1.0)


def _gammatone(x: np.ndarray, cf: float, bw_factor: float):
    """4th-order gammatone via a 4x cascaded complex one-pole filter.

    Returns (envelope, bm) — magnitude and real part of the analytic band
    signal, gain-normalized to unity at cf.
    """
    b = 2.0 * np.pi * 1.019 * _erb(np.array(cf)) * bw_factor / _FS
    theta = 2.0 * np.pi * cf / _FS
    a = np.exp(-b + 1j * theta)
    g = (1.0 - np.abs(a)) ** 4  # DC gain of the 4-pole cascade at cf
    # demodulate -> 4x real one-pole -> remodulate (O(n) per stage, numpy
    # cumulative form: y[n] = a*y[n-1] + x[n]  ==  cumsum in log domain).
    n = len(x)
    t = np.arange(n)
    xd = x * np.exp(-1j * theta * t)
    r = np.exp(-b)
    for _ in range(4):
        xd = _one_pole(xd, r)
    z = g * xd * np.exp(1j * theta * t)
    return np.abs(z), np.real(z)


def _one_pole(x: np.ndarray, r: float) -> np.ndarray:
    """y[n] = x[n] + r*y[n-1] without a Python loop: block-doubling scan."""
    y = x.astype(np.complex128, copy=True)
    shift = 1
    n = len(y)
    rs = r
    while shift < n:
        y[shift:] += rs * y[:-shift]
        rs = rs * rs
        shift *= 2
    return y


def _lp1(x: np.ndarray, fc: float) -> np.ndarray:
    """1st-order butterworth lowpass (bilinear) — the gain smoother of
    eb_EnvCompressBasic (800 Hz)."""
    from math import pi, tan

    wc = tan(pi * fc / _FS)
    b0 = wc / (1.0 + wc)
    a1 = (wc - 1.0) / (wc + 1.0)
    ff = b0 * (x + np.concatenate([[0.0], x[:-1]]))
    return np.real(_one_pole(ff, -a1))


def _ihc_adapt(xdb: np.ndarray, xbm: np.ndarray, delta: float = 2.0):
    """IHC firing-rate adaptation (eb_IHCadapt): rapid (2 ms) +
    short-term (60 ms) adaptation modeled as the published two-capacitor
    RC equivalent circuit with onset overshoot factor `delta`. The
    envelope (dB SL) drives the circuit; the BM path gets the same
    instantaneous gain (ydb+eps)/(xdb+eps).

    The per-sample state update is linear: V[n] = M V[n-1] + d x[n] with
    a constant 2x2 M — diagonalizing M turns it into two independent
    one-pole recursions, each computed with the O(n log n) block-doubling
    scan (no Python per-sample loop)."""
    delta = max(float(delta), 1.0001)
    tau1, tau2 = 0.002, 0.060
    t_s = 1.0 / _FS
    r1 = 1.0 / delta
    r2 = 0.5 * (1.0 - r1)
    r3 = r2
    c1 = tau1 * (r1 + r2) / (r1 * r2)
    c2 = tau2 / (r1 + r2)
    a11 = r1 + r2 + r1 * r2 * (c1 / t_s)
    a12 = -r1
    a21 = -r3
    a22 = r2 + r3 + r2 * r3 * (c2 / t_s)
    denom = 1.0 / (a11 * a22 - a21 * a12)
    r12c1 = r1 * r2 * (c1 / t_s)
    r23c2 = r2 * r3 * (c2 / t_s)
    m = np.array([[denom * a22 * r12c1, -denom * a12 * r23c2],
                  [-denom * a21 * r12c1, denom * a11 * r23c2]])
    d = np.array([denom * a22 * r2, -denom * a21 * r2])
    evals, p = np.linalg.eig(m)
    u = np.linalg.solve(p, d)  # input weights in modal coordinates
    x = xdb.astype(np.complex128)
    w = np.stack([_one_pole(u[i] * x, evals[i]) for i in range(2)])
    v1 = np.real(p[0] @ w)
    ydb = np.maximum((xdb - v1) / r1, 0.0)
    small = 1e-30
    gain = (ydb + small) / (xdb + small)
    return ydb, gain * xbm


def _env_db(env: np.ndarray, level1: float) -> np.ndarray:
    """Envelope magnitude -> dB re the level1 calibration (65 dB SPL ~ RMS 1)."""
    small = 1e-30
    return np.maximum(0.0, level1 + 20.0 * np.log10(env + small))


def _segment(env: np.ndarray, nseg_len: int) -> np.ndarray:
    """Hann-weighted 50%-overlap segment average -> (nchan, nseg)."""
    nchan, n = env.shape
    hop = nseg_len // 2
    nseg = max(1, (n - nseg_len) // hop + 1)
    w = np.hanning(nseg_len)
    w /= w.sum()
    out = np.empty((nchan, nseg))
    for s in range(nseg):
        out[:, s] = env[:, s * hop: s * hop + nseg_len] @ w
    return out


def ear_model(ref: np.ndarray, proc: np.ndarray, fs: int,
              hl: np.ndarray | None = None, level1: float = 65.0):
    """Run both signals through the auditory model.

    Returns (ref_db, proc_db, ref_bm, proc_bm, cfs): segment envelopes in dB
    SL (nchan, nseg), BM vibration segments (nchan, nseg, seg_len), and the
    band center frequencies.
    """
    if hl is None:
        hl = np.zeros(6)
    if fs != _FS:
        ref = resample(ref.astype(np.float64), fs, int(_FS))
        proc = resample(proc.astype(np.float64), fs, int(_FS))
    ref, proc = _align(np.asarray(ref, np.float64),
                       np.asarray(proc, np.float64))
    ref = _middle_ear(ref)
    proc = _middle_ear(proc)

    cfs = _center_freqs()
    # audiogram (250,500,1000,2000,4000,6000 Hz) -> per-band loss
    aud_f = np.array([250.0, 500.0, 1000.0, 2000.0, 4000.0, 6000.0])
    loss = np.interp(cfs, aud_f, hl)
    # OHC handles up to 80% of loss capped at ~ the compression headroom
    attn_ohc = 0.8 * loss
    attn_ihc = 0.2 * loss
    # compression ratio 1.25 (low) -> 3.5 (high band), reduced toward 1
    # as OHC loss grows (loss linearizes the cochlea)
    cr = 1.25 + 2.25 * np.arange(_NCHAN) / (_NCHAN - 1)
    cr = 1.0 + (cr - 1.0) * np.maximum(0.0, 1.0 - loss / 80.0)

    knee = 30.0  # compression knee, dB SL
    upper = 100.0
    seg_len = int(_SEG_MS * 1e-3 * _FS)

    env_db = {"ref": [], "proc": []}
    bm_seg = {"ref": [], "proc": []}
    for k in range(_NCHAN):
        for name, sig in (("ref", ref), ("proc", proc)):
            # control path: maximally broadened filter estimates the level
            c_env, _ = _gammatone(sig, cfs[k], bw_factor=4.0)
            # signal-path bandwidth from the control RMS level
            # (eb_BWadjust: utterance-level by construction)
            c_rms = float(np.sqrt(np.mean(c_env**2)))
            c_rms_db = level1 + 20.0 * np.log10(max(c_rms, 1e-30))
            bw = 1.0 + np.clip((c_rms_db - 50.0) / 50.0, 0.0, 1.0)
            s_env, s_bm = _gammatone(sig, cfs[k], bw_factor=bw)
            # OHC compression: INSTANTANEOUS gain from the control
            # envelope, clipped to [knee, upper], smoothed at 800 Hz and
            # applied to both paths (eb_EnvCompressBasic structure)
            c_db = np.clip(_env_db(c_env, level1), knee, upper)
            gain_db = -attn_ohc[k] - (1.0 - 1.0 / cr[k]) * (c_db - knee)
            gain = _lp1(10.0 ** (gain_db / 20.0), 800.0)
            env_c = gain * s_env
            out_db = np.maximum(
                0.0, _env_db(env_c, level1) - attn_ihc[k])
            # IHC firing-rate adaptation on the dB-SL envelope, matching
            # gain on the BM path (eb_IHCadapt, delta=2)
            out_db, bm_adapted = _ihc_adapt(out_db, gain * s_bm)
            env_db[name].append(out_db)
            bm_seg[name].append(bm_adapted)

    ref_env = np.stack(env_db["ref"])
    proc_env = np.stack(env_db["proc"])
    ref_db = _segment(ref_env, seg_len)
    proc_db = _segment(proc_env, seg_len)

    def bm_segments(bm):
        bm = np.stack(bm)
        hop = seg_len // 2
        nseg = max(1, (bm.shape[1] - seg_len) // hop + 1)
        segs = np.stack([bm[:, s * hop: s * hop + seg_len]
                         for s in range(nseg)], axis=1)
        return segs

    return ref_db, proc_db, bm_segments(bm_seg["ref"]), \
        bm_segments(bm_seg["proc"]), cfs


# ----------------------------------------------------- component measures

def _cepstral_corr(ref_db: np.ndarray, proc_db: np.ndarray,
                   thresh_db: float = 2.5) -> float:
    """Mel-cepstral correlation over active segments, basis 2..6."""
    nchan, nseg = ref_db.shape
    active = ref_db.mean(axis=0) > thresh_db
    if active.sum() < 2:
        return 0.0
    r = ref_db[:, active]
    p = proc_db[:, active]
    k = np.arange(nchan)
    n_basis = 6
    basis = np.stack([np.cos(j * np.pi * k / (nchan - 1))
                      for j in range(n_basis)])  # (6, nchan)
    cr = basis @ r  # (6, nseg_act)
    cp = basis @ p
    corrs = []
    for j in range(1, n_basis):  # skip the DC basis
        a = cr[j] - cr[j].mean()
        b = cp[j] - cp[j].mean()
        d = np.sqrt((a @ a) * (b @ b))
        corrs.append((a @ b) / d if d > 1e-12 else 0.0)
    return float(np.clip(np.mean(corrs), 0.0, 1.0))


def _bm_coherence(ref_bm: np.ndarray, proc_bm: np.ndarray,
                  ref_db: np.ndarray) -> tuple[float, float, float]:
    """Per-segment BM vibration cross-covariance averaged within the
    low/mid/high thirds of the reference level distribution."""
    nchan, nseg, _ = ref_bm.shape
    seg_cov = np.zeros(nseg)
    seg_lvl = ref_db.mean(axis=0)[:nseg]
    for s in range(nseg):
        a = ref_bm[:, s, :].ravel()
        b = proc_bm[:, s, :].ravel()
        a = a - a.mean()
        b = b - b.mean()
        d = np.sqrt((a @ a) * (b @ b))
        seg_cov[s] = (a @ b) / d if d > 1e-12 else 0.0
    active = seg_lvl > 2.5
    if active.sum() < 3:
        return 0.0, 0.0, 0.0
    lv = seg_lvl[active]
    cv = np.clip(seg_cov[active], 0.0, 1.0)
    q1, q2 = np.quantile(lv, [1 / 3, 2 / 3])
    low = cv[lv <= q1]
    mid = cv[(lv > q1) & (lv <= q2)]
    high = cv[lv > q2]
    m = lambda v: float(v.mean()) if len(v) else 0.0
    return m(low), m(mid), m(high)


def _spectral_terms(ref_db: np.ndarray, proc_db: np.ndarray) -> tuple[float, float]:
    """Long-term average spectrum differences: loudness and slope (std of
    the band difference / of the band-to-band slope difference, normalized)."""
    active = ref_db.mean(axis=0) > 2.5
    if active.sum() < 2:
        return 1.0, 1.0
    r = ref_db[:, active].mean(axis=1)
    p = proc_db[:, active].mean(axis=1)
    r = r / max(r.mean(), 1e-6)
    p = p / max(p.mean(), 1e-6)
    d = p - r
    dloud = float(np.std(d))
    dslope = float(np.std(np.diff(p) - np.diff(r)))
    return dloud, dslope


# ----------------------------------------------------------- public scores

def hasqi_v2(ref: np.ndarray, proc: np.ndarray, fs: int,
             hl: np.ndarray | None = None, level1: float = 65.0) -> float:
    """HASQI v2 quality in [0, 1] (Kates & Arehart 2014, eq. 9-11)."""
    ref_db, proc_db, ref_bm, proc_bm, _ = ear_model(ref, proc, fs, hl, level1)
    cep = _cepstral_corr(ref_db, proc_db)
    _, _, sync_high = _bm_coherence(ref_bm, proc_bm, ref_db)
    nonlin = (cep ** 2) * sync_high
    dloud, dslope = _spectral_terms(ref_db, proc_db)
    linear = float(np.clip(1.0 - 0.579 * abs(dloud) - 0.421 * abs(dslope),
                           0.0, 1.0))
    return float(np.clip(nonlin * linear, 0.0, 1.0))


def haspi_v1(ref: np.ndarray, proc: np.ndarray, fs: int,
             hl: np.ndarray | None = None, level1: float = 65.0) -> float:
    """HASPI v1 intelligibility in [0, 1] (Kates & Arehart 2014, eq. 1)."""
    ref_db, proc_db, ref_bm, proc_bm, _ = ear_model(ref, proc, fs, hl, level1)
    cep = _cepstral_corr(ref_db, proc_db)
    a_low, a_mid, a_high = _bm_coherence(ref_bm, proc_bm, ref_db)
    p = -9.047 + 14.817 * cep + 0.0 * a_low + 0.0 * a_mid + 4.616 * a_high
    return float(1.0 / (1.0 + np.exp(-p)))
