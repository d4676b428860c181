"""PESQ — ITU-T P.862 (narrowband) / P.862.2 (wideband) in numpy.
A copy of se_tpu/eval/pesq.py (numpy and scipy only).

A from-scratch implementation of the algorithm the reference scores with
(ref DeepXi/deepxi/pesq.m, the Loizou MATLAB edition of the ITU method):
level alignment, input filtering (IRS receive / wideband biquad), the
energy-threshold VAD, envelope-based crude alignment, per-utterance fine
alignment with recursive utterance splitting, the Bark-spectrum/loudness
psychoacoustic model with bad-interval realignment, and the P.862.1 /
P.862.2 MOS-LQO mappings.

Validation: cross-validated against a literal numpy transliteration of the
reference pesq.m (tests/matlab_pesq.py) over a condition matrix — SNR
sweeps, constant delay, clipping, lowpass, gain mismatch, both 8 k and
16 k modes — agreeing to ~1e-9 MOS (tests/test_pesq_oracle.py). Behavioral
tests (identity maximum wb ~4.64, monotonicity, delay realignment) live in
tests/test_pesq.py.

Usage:
    from se_tpu_torch.eval.pesq import pesq
    mos_lqo = pesq(ref_wav, deg_wav, 16000)          # wideband
    pesq_mos, mos_lqo = pesq(ref_wav, deg_wav, 8000)  # narrowband
"""

from __future__ import annotations

import numpy as np
from scipy.signal import sosfilt

DATAPADDING_MSECS = 320
SEARCHBUFFER = 75
MINSPEECHLGTH = 4
JOINSPEECHLGTH = 50
MINUTTLENGTH = 50
MAXNUTTERANCES = 50
TARGET_AVG_POWER = 1e7

_IIR_SOS_16K = np.array([
    [0.325631521, -0.086782860, -0.238848661, -1.079416490, 0.434583902],
    [0.403961804, -0.556985881, 0.153024077, -0.415115835, 0.696590244],
    [4.736162769, 3.287251046, 1.753289019, -1.859599046, 0.876284034],
    [0.365373469, 0.000000000, 0.000000000, -0.634626531, 0.000000000],
    [0.884811506, 0.000000000, 0.000000000, -0.256725271, 0.141536777],
    [0.723593055, -1.447186099, 0.723593044, -1.129587469, 0.657232737],
    [1.644910855, -1.817280902, 1.249658063, -1.778403899, 0.801724355],
    [0.633692689, -0.284644314, -0.319789663, 0.000000000, 0.000000000],
    [1.032763031, 0.268428979, 0.602913323, 0.000000000, 0.000000000],
    [1.001616361, -0.823749013, 0.439731942, -0.885778255, 0.000000000],
    [0.752472096, -0.375388990, 0.188977609, -0.077258216, 0.247230734],
    [1.023700575, 0.001661628, 0.521284240, -0.183867259, 0.354324187],
])
_IIR_SOS_8K = np.array([
    [0.885535424, -0.885535424, 0.000000000, -0.771070709, 0.000000000],
    [0.895092588, 1.292907193, 0.449260174, 1.268869037, 0.442025372],
    [4.049527940, -7.865190042, 3.815662102, -1.746859852, 0.786305963],
    [0.500002353, -0.500002353, 0.000000000, 0.000000000, 0.000000000],
    [0.565002834, -0.241585934, -0.306009671, 0.259688659, 0.249979657],
    [2.115237288, 0.919935084, 1.141240051, -1.587313419, 0.665935315],
    [0.912224584, -0.224397719, -0.641121413, -0.246029464, -0.556720590],
    [0.444617727, -0.307589321, 0.141638062, -0.996391149, 0.502251622],
])
_WB_IIR_SOS = {
    8000: np.array([[2.6657628, -5.3315255, 2.6657628, -1.8890331,
                     0.89487434]]),
    16000: np.array([[2.740826, -5.4816519, 2.740826, -1.9444777,
                      0.94597794]]),
}

_NR_HZ_PER_BARK_16K = np.array([
    1, 1, 1, 1, 1, 1, 1, 1, 2, 1, 1, 1, 1, 1, 2, 1, 1, 2, 2, 2, 2, 2, 2,
    2, 2, 3, 3, 3, 3, 4, 3, 4, 5, 4, 5, 6, 6, 7, 8, 9, 9, 12, 12, 15, 16,
    18, 21, 25, 20])
_CENTRE_BARK_16K = np.array([
    0.078672, 0.316341, 0.636559, 0.961246, 1.290450, 1.624217, 1.962597,
    2.305636, 2.653383, 3.005889, 3.363201, 3.725371, 4.092449, 4.464486,
    4.841533, 5.223642, 5.610866, 6.003256, 6.400869, 6.803755, 7.211971,
    7.625571, 8.044611, 8.469146, 8.899232, 9.334927, 9.776288, 10.223374,
    10.676242, 11.134952, 11.599563, 12.070135, 12.546731, 13.029408,
    13.518232, 14.013264, 14.514566, 15.022202, 15.536238, 16.056736,
    16.583761, 17.117382, 17.657663, 18.204674, 18.758478, 19.319147,
    19.886751, 20.461355, 21.043034])
_WIDTH_BARK_16K = np.array([
    0.157344, 0.317994, 0.322441, 0.326934, 0.331474, 0.336061, 0.340697,
    0.345381, 0.350114, 0.354897, 0.359729, 0.364611, 0.369544, 0.374529,
    0.379565, 0.384653, 0.389794, 0.394989, 0.400236, 0.405538, 0.410894,
    0.416306, 0.421773, 0.427297, 0.432877, 0.438514, 0.444209, 0.449962,
    0.455774, 0.461645, 0.467577, 0.473569, 0.479621, 0.485736, 0.491912,
    0.498151, 0.504454, 0.510819, 0.517250, 0.523745, 0.530308, 0.536934,
    0.543629, 0.550390, 0.557220, 0.564119, 0.571085, 0.578125, 0.585232])
_POW_CORR_16K = np.array([
    100.000000, 99.999992, 100.000000, 100.000008, 100.000008, 100.000015,
    99.999992, 99.999969, 50.000027, 100.000000, 99.999969, 100.000015,
    99.999947, 100.000061, 53.047077, 110.000046, 117.991989, 65.000000,
    68.760147, 69.999931, 71.428818, 75.000038, 76.843384, 80.968781,
    88.646126, 63.864388, 68.155350, 72.547775, 75.584831, 58.379192,
    80.950836, 64.135651, 54.384785, 73.821884, 64.437073, 59.176456,
    65.521278, 61.399822, 58.144047, 57.004543, 64.126297, 54.311001,
    61.114979, 55.077751, 56.849335, 55.628868, 53.137054, 54.985844,
    79.546974])
_ABS_THRESH_16K = np.array([
    51286152.00, 2454709.500, 70794.593750, 4897.788574, 1174.897705,
    389.045166, 104.712860, 45.708820, 17.782795, 9.772372, 4.897789,
    3.090296, 1.905461, 1.258925, 0.977237, 0.724436, 0.562341, 0.457088,
    0.389045, 0.331131, 0.295121, 0.269153, 0.257040, 0.251189, 0.251189,
    0.251189, 0.251189, 0.263027, 0.288403, 0.309030, 0.338844, 0.371535,
    0.398107, 0.436516, 0.467735, 0.489779, 0.501187, 0.501187, 0.512861,
    0.524807, 0.524807, 0.524807, 0.512861, 0.478630, 0.426580, 0.371535,
    0.363078, 0.416869, 0.537032])

_NR_HZ_PER_BARK_8K = np.array([
    1, 1, 1, 1, 1, 1, 1, 1, 2, 1, 1, 1, 1, 1, 2, 1, 1, 2, 2, 2, 2, 2, 2,
    2, 2, 3, 3, 3, 3, 4, 3, 4, 5, 4, 5, 6, 6, 7, 8, 9, 9, 11])
_CENTRE_BARK_8K = _CENTRE_BARK_16K[:42]
_WIDTH_BARK_8K = _WIDTH_BARK_16K[:42]
_POW_CORR_8K = np.array([
    100.000000, 99.999992, 100.000000, 100.000008, 100.000008, 100.000015,
    99.999992, 99.999969, 50.000027, 100.000000, 99.999969, 100.000015,
    99.999947, 100.000061, 53.047077, 110.000046, 117.991989, 65.000000,
    68.760147, 69.999931, 71.428818, 75.000038, 76.843384, 80.968781,
    88.646126, 63.864388, 68.155350, 72.547775, 75.584831, 58.379192,
    80.950836, 64.135651, 54.384785, 73.821884, 64.437073, 59.176456,
    65.521278, 61.399822, 58.144047, 57.004543, 64.126297, 59.248363])
_ABS_THRESH_8K = _ABS_THRESH_16K[:42].copy()

_IRS_FILTER_DB = np.array([
    [0, -200], [50, -40], [100, -20], [125, -12], [160, -6], [200, 0],
    [250, 4], [300, 6], [350, 8], [400, 10], [500, 11], [600, 12],
    [700, 12], [800, 12], [1000, 12], [1300, 12], [1600, 12], [2000, 12],
    [2500, 12], [3000, 12], [3250, 12], [3500, 4], [4000, -200],
    [5000, -200], [6300, -200], [8000, -200]], dtype=np.float64)
_LEVEL_FILTER_DB = np.array([
    [0, -500], [50, -500], [100, -500], [125, -500], [160, -500],
    [200, -500], [250, -500], [300, -500], [350, 0], [400, 0], [500, 0],
    [600, 0], [630, 0], [800, 0], [1000, 0], [1250, 0], [1600, 0],
    [2000, 0], [2500, 0], [3000, 0], [3250, 0], [3500, -500],
    [4000, -500], [5000, -500], [6300, -500], [8000, -500]],
    dtype=np.float64)


class _Cfg:
    def __init__(self, fs: int):
        self.fs = fs
        if fs == 16000:
            self.downsample = 64
            self.align_nfft = 1024
            self.iir_sos = _IIR_SOS_16K
            self.nb = 49
            self.sp = 6.910853e-6
            self.sl = 1.866055e-1
            self.nr_hz = _NR_HZ_PER_BARK_16K
            self.centre_bark = _CENTRE_BARK_16K
            self.width_bark = _WIDTH_BARK_16K
            self.pow_corr = _POW_CORR_16K
            self.abs_thresh = _ABS_THRESH_16K
        elif fs == 8000:
            self.downsample = 32
            self.align_nfft = 512
            self.iir_sos = _IIR_SOS_8K
            self.nb = 42
            self.sp = 2.764344e-5
            self.sl = 1.866055e-1
            self.nr_hz = _NR_HZ_PER_BARK_8K
            self.centre_bark = _CENTRE_BARK_8K
            self.width_bark = _WIDTH_BARK_8K
            self.pow_corr = _POW_CORR_8K
            self.abs_thresh = _ABS_THRESH_8K
        else:
            raise ValueError("PESQ supports 8000 or 16000 Hz only")
        self.padding = DATAPADDING_MSECS * (fs // 1000)
        self.window = 0.5 * (1.0 - np.cos(
            2.0 * np.pi * np.arange(self.align_nfft) / self.align_nfft))


def _pow_of(data, start1, end1, divisor):
    """MATLAB pow_of with 1-based inclusive indices."""
    return float(np.sum(data[start1 - 1 : end1] ** 2)) / divisor


def _apply_fft_filter(data, n_used, filter_db, cfg):
    """FFT-domain dB equalization over the active region (apply_filter)."""
    out = data.copy()
    ofs = SEARCHBUFFER * cfg.downsample
    n = n_used - 2 * SEARCHBUFFER * cfg.downsample + cfg.padding
    pow2 = 1 << int(np.ceil(np.log2(n)))
    gain_1khz = np.interp(1000.0, filter_db[:, 0], filter_db[:, 1])
    x = np.zeros(pow2)
    x[:n] = data[ofs : ofs + n]
    x_fft = np.fft.fft(x)
    freqs = np.arange(pow2 // 2 + 1) * (cfg.fs / pow2)
    factor_db = np.interp(freqs, filter_db[:, 0], filter_db[:, 1]) - gain_1khz
    factor = 10.0 ** (factor_db / 20.0)
    factor = np.concatenate([factor, factor[1 : pow2 // 2][::-1]])
    y = np.fft.ifft(x_fft * factor).real
    out[ofs : ofs + n] = y[:n]
    return out


def _fix_power_level(data, n_used, max_n, cfg):
    filtered = _apply_fft_filter(data, n_used, _LEVEL_FILTER_DB, cfg)
    power = _pow_of(filtered, SEARCHBUFFER * cfg.downsample + 1,
                    n_used - SEARCHBUFFER * cfg.downsample + cfg.padding,
                    max_n - 2 * SEARCHBUFFER * cfg.downsample + cfg.padding)
    return data * np.sqrt(TARGET_AVG_POWER / max(power, 1e-20))


def _dc_block(data, n_used, cfg):
    ofs = SEARCHBUFFER * cfg.downsample
    out = data.copy()
    facc = np.sum(data[ofs : n_used - ofs]) / n_used
    out[ofs : n_used - ofs] = data[ofs : n_used - ofs] - facc
    ramp = (0.5 + np.arange(cfg.downsample)) / cfg.downsample
    out[ofs : ofs + cfg.downsample] *= ramp
    out[n_used - ofs - cfg.downsample : n_used - ofs] *= ramp[::-1]
    return out


def _apply_iir(data, sos5):
    sos = np.zeros((len(sos5), 6))
    sos[:, :3] = sos5[:, :3]
    sos[:, 3] = 1.0
    sos[:, 4:] = sos5[:, 3:]
    return sosfilt(sos, data)


def _apply_vad(data, n_used, cfg):
    ds = cfg.downsample
    nwin = n_used // ds
    vad = np.array([
        np.sum(data[i * ds : (i + 1) * ds] ** 2) / ds for i in range(nwin)])
    level_thresh = np.sum(vad) / nwin
    level_min = np.max(vad)
    level_min = level_min * 1.0e-4 if level_min > 0 else 1.0
    vad[vad < level_min] = level_min

    for _ in range(12):
        below = vad[vad <= level_thresh]
        if len(below) > 0:
            noise = np.mean(below)
            std_noise = np.sqrt(np.mean((below - noise) ** 2))
        else:
            noise, std_noise = 0.0, 0.0
        level_thresh = 1.001 * (noise + 2 * std_noise)

    above = vad[vad > level_thresh]
    level_sig = np.mean(above) if len(above) > 0 else 0.0
    if len(above) == 0:
        level_thresh = -1.0
    below = vad[vad <= level_thresh]
    level_noise = (np.sum(below) / (nwin - len(above))
                   if len(above) < nwin else 1.0)

    vad = np.where(vad <= level_thresh, -vad, vad)
    vad[0] = -level_min
    vad[nwin - 1] = -level_min

    # drop too-short speech bursts (1-based loop translated to 0-based)
    start = finish = 0
    for count in range(1, nwin):
        if vad[count] > 0.0 and vad[count - 1] <= 0.0:
            start = count
        if vad[count] <= 0.0 and vad[count - 1] > 0.0:
            finish = count
            if finish - start <= MINSPEECHLGTH:
                vad[start:finish] = -vad[start:finish]

    if level_sig >= level_noise * 1000.0:
        for count in range(1, nwin):
            if vad[count] > 0 and vad[count - 1] <= 0:
                start = count
            if vad[count] <= 0 and vad[count - 1] > 0:
                finish = count
                g = np.sum(vad[start:finish])
                if g < 3.0 * level_thresh * (finish - start):
                    vad[start:finish] = -vad[start:finish]

    # join close bursts
    start = finish = 0
    for count in range(1, nwin):
        if vad[count] > 0.0 and vad[count - 1] <= 0.0:
            start = count
            if finish > 0 and (start - finish) <= JOINSPEECHLGTH:
                vad[finish:start] = level_min
        if vad[count] <= 0.0 and vad[count - 1] > 0.0:
            finish = count

    start = 0
    for count in range(1, nwin):
        if vad[count] > 0 and vad[count - 1] <= 0:
            start = count
    if start == 0:
        vad = np.abs(vad)
        vad[0] = -level_min
        vad[nwin - 1] = -level_min

    count = 3
    while count < nwin - 1:
        if vad[count] > 0 and vad[count - 2] <= 0:
            vad[count - 2] = vad[count] * 0.1
            vad[count - 1] = vad[count] * 0.3
            count += 1
        if vad[count] <= 0 and vad[count - 1] > 0:
            vad[count] = vad[count - 1] * 0.3
            if count + 1 < nwin:
                vad[count + 1] = vad[count - 1] * 0.1
            count += 3
        count += 1

    vad[vad < 0] = 0
    if level_thresh <= 0:
        level_thresh = level_min
    log_vad = np.zeros(nwin)
    mask = vad > level_thresh
    log_vad[mask] = np.log(vad[mask] / level_thresh)
    return vad, log_vad


def _fftnxcorr(ref, startr1, nr, deg, startd1, nd):
    nx = 1 << int(np.ceil(np.log2(max(nr, nd))))
    x1 = np.zeros(2 * nx)
    x2 = np.zeros(2 * nx)
    startr1 = max(1, startr1)
    startd1 = max(1, startd1)
    x1[:nr] = ref[startr1 - 1 : startr1 - 1 + nr][::-1]
    x2[:nd] = deg[startd1 - 1 : startd1 - 1 + nd]
    y = np.fft.ifft(np.fft.fft(x1) * np.fft.fft(x2)).real
    return y[: nr + nd - 1]


class _State:
    """Per-call alignment state (the MATLAB globals)."""

    def __init__(self, cfg):
        self.cfg = cfg
        z = np.zeros(MAXNUTTERANCES + 1, dtype=np.int64)
        self.nutterances = 0
        self.crude_delay = 0
        self.search_start = z.copy()  # 1-based window indices
        self.search_end = z.copy()
        self.utt_delay_est = z.copy()
        self.utt_delay = z.copy()
        self.utt_delay_conf = np.zeros(MAXNUTTERANCES + 1)
        self.utt_start = z.copy()
        self.utt_end = z.copy()


def _crude_align(st, ref_log_vad, ref_n, deg_log_vad, deg_n, utt_id):
    cfg = st.cfg
    ds = cfg.downsample
    if utt_id == -1:  # whole signal
        nr = ref_n // ds
        nd = deg_n // ds
        startr = startd = 1
    elif utt_id == MAXNUTTERANCES:
        startr = st.search_start[MAXNUTTERANCES]
        startd = startr + st.utt_delay_est[MAXNUTTERANCES] // ds
        if startd < 0:
            startr = 1 - st.utt_delay_est[MAXNUTTERANCES] // ds
            startd = 1
        nr = st.search_end[MAXNUTTERANCES] - startr
        nd = nr
        if startd + nd > deg_n // ds:
            nd = deg_n // ds - startd
    else:
        startr = st.search_start[utt_id]
        startd = startr + st.crude_delay // ds
        if startd < 0:
            startr = 1 - st.crude_delay // ds
            startd = 1
        nr = st.search_end[utt_id] - startr
        nd = nr
        if startd + nd > deg_n // ds + 1:
            nd = deg_n // ds - startd + 1
    startr = max(1, startr)
    startd = max(1, startd)

    max_y = 0.0
    i_max = nr
    if nr > 1 and nd > 1:
        y = _fftnxcorr(ref_log_vad, startr, int(nr), deg_log_vad, startd,
                       int(nd))
        i = int(np.argmax(y))
        if y[i] > 0:
            max_y = y[i]
            i_max = i + 1  # 1-based
        else:
            i_max = nr
    if utt_id == -1:
        st.crude_delay = (i_max - nr) * ds
    elif utt_id == MAXNUTTERANCES:
        st.utt_delay[MAXNUTTERANCES] = ((i_max - nr) * ds
                                        + st.utt_delay_est[MAXNUTTERANCES])
    else:
        st.utt_delay_est[utt_id] = (i_max - nr) * ds + st.crude_delay


def _id_searchwindows(st, ref_vad, ref_n, deg_n):
    cfg = st.cfg
    ds = cfg.downsample
    utt_num = 1
    speech_flag = 0
    vad_len = ref_n // ds
    del_deg_start = MINUTTLENGTH - st.crude_delay // ds
    del_deg_end = (deg_n - st.crude_delay) // ds - MINUTTLENGTH
    this_start = 0
    for count in range(1, vad_len + 1):
        v = ref_vad[count - 1]
        if v > 0 and speech_flag == 0:
            speech_flag = 1
            this_start = count
            st.search_start[utt_num] = max(1, count - SEARCHBUFFER)
        if (v == 0 or count == vad_len - 1) and speech_flag == 1:
            speech_flag = 0
            st.search_end[utt_num] = min(vad_len, count + SEARCHBUFFER)
            if ((count - this_start) >= MINUTTLENGTH
                    and this_start < del_deg_end and count > del_deg_start):
                utt_num += 1
                if utt_num > MAXNUTTERANCES - 1:
                    break
    st.nutterances = utt_num - 1


def _time_align(st, ref_data, ref_n, deg_data, deg_n, utt_id):
    cfg = st.cfg
    ds = cfg.downsample
    nfft = cfg.align_nfft
    window = cfg.window
    estdelay = int(st.utt_delay_est[utt_id])
    h = np.zeros(nfft)

    startr = (st.search_start[utt_id] - 1) * ds + 1
    startd = startr + estdelay
    if startd < 0:
        startr = 1 - estdelay
        startd = 1

    while (startd + nfft <= deg_n and
           startr + nfft <= (st.search_end[utt_id] - 1) * ds):
        x1 = ref_data[startr - 1 : startr - 1 + nfft] * window
        x2 = deg_data[startd - 1 : startd - 1 + nfft] * window
        xc = np.abs(np.fft.ifft(np.conj(np.fft.fft(x1)) * np.fft.fft(x2)))
        v_max = xc.max() * 0.99
        h[xc > v_max] += v_max ** 0.125
        startr += nfft // 4
        startd += nfft // 4

    hsum = float(np.sum(h))
    kernel = nfft // 64
    x2 = np.zeros(nfft)
    x2[0] = 1.0
    for count in range(2, kernel + 1):
        x2[count - 1] = 1 - (count - 1) / kernel
        x2[nfft - count + 1] = 1 - (count - 1) / kernel
    hh = np.fft.ifft(np.fft.fft(h) * np.fft.fft(x2)).real
    hh = np.abs(hh) / hsum if hsum > 0 else np.zeros(nfft)
    i_max = int(np.argmax(hh)) + 1
    v_max = hh[i_max - 1]
    if i_max - 1 >= nfft // 2:
        i_max -= nfft
    st.utt_delay[utt_id] = estdelay + i_max - 1
    st.utt_delay_conf[utt_id] = v_max


def _id_utterances(st, ref_n, ref_vad, deg_n):
    cfg = st.cfg
    ds = cfg.downsample
    utt_num = 1
    speech_flag = 0
    vad_len = ref_n // ds
    del_deg_start = MINUTTLENGTH - st.crude_delay // ds
    del_deg_end = (deg_n - st.crude_delay) // ds - MINUTTLENGTH
    this_start = 0
    for count in range(1, vad_len + 1):
        v = ref_vad[count - 1]
        if v > 0 and speech_flag == 0:
            speech_flag = 1
            this_start = count
            st.utt_start[utt_num] = count
        if (v == 0 or count == vad_len) and speech_flag == 1:
            speech_flag = 0
            st.utt_end[utt_num] = count
            if ((count - this_start) >= MINUTTLENGTH
                    and this_start < del_deg_end and count > del_deg_start):
                utt_num += 1
                if utt_num > MAXNUTTERANCES - 1:
                    break

    st.utt_start[1] = SEARCHBUFFER + 1
    st.nutterances = max(1, st.nutterances)
    nutt = st.nutterances
    st.utt_end[nutt] = vad_len - SEARCHBUFFER + 1

    for u in range(2, nutt + 1):
        this_start = st.utt_start[u] - 1
        last_end = st.utt_end[u - 1] - 1
        count = (this_start + last_end) // 2
        st.utt_start[u] = count + 1
        st.utt_end[u - 1] = count + 1

    this_start = (st.utt_start[1] - 1) * ds + st.utt_delay[1]
    if this_start < SEARCHBUFFER * ds:
        count = SEARCHBUFFER + (ds - 1 - st.utt_delay[1]) // ds
        st.utt_start[1] = count + 1

    last_end = (st.utt_end[nutt] - 1) * ds + 1 + st.utt_delay[nutt]
    if last_end > deg_n - SEARCHBUFFER * ds + 1:
        count = (deg_n - st.utt_delay[nutt]) // ds - SEARCHBUFFER
        st.utt_end[nutt] = count + 1

    for u in range(2, nutt + 1):
        this_start = (st.utt_start[u] - 1) * ds + st.utt_delay[u]
        last_end = (st.utt_end[u - 1] - 1) * ds + st.utt_delay[u - 1]
        if this_start < last_end:
            count = (this_start + last_end) // 2
            st.utt_start[u] = (ds - 1 + count - st.utt_delay[u]) // ds + 1
            st.utt_end[u - 1] = (count - st.utt_delay[u - 1]) // ds + 1


def _histogram_align(st, ref_data, deg_data, deg_n, estdelay, startr, startd,
                     limit, forward, h, hsum):
    """One pass of windowed cross-correlation histogram accumulation used by
    split_align (pesq.m:2185-2260)."""
    cfg = st.cfg
    nfft = cfg.align_nfft
    window = cfg.window
    kernel = nfft // 64
    while True:
        if forward:
            if not (startd + nfft <= 1 + deg_n and startr + nfft <= limit):
                break
        else:
            if not (startd >= 1 and startr >= limit):
                break
        x1 = ref_data[startr - 1 : startr - 1 + nfft] * window
        x2 = deg_data[startd - 1 : startd - 1 + nfft] * window
        xc = np.abs(np.fft.ifft(np.conj(np.fft.fft(x1)) * np.fft.fft(x2)))
        v_max = xc.max() * 0.99
        n_max = (v_max ** 0.125) / kernel
        hits = np.where(xc > v_max)[0]
        for count in hits:
            hsum += n_max * kernel
            idx = (count + np.arange(1 - kernel, kernel)) % nfft
            h[idx] += n_max * (kernel - np.abs(np.arange(1 - kernel, kernel)))
        if forward:
            startr += nfft // 4
            startd += nfft // 4
        else:
            startr -= nfft // 4
            startd -= nfft // 4
    return startr, startd, hsum


def _split_align(st, ref_data, ref_n, ref_log_vad, deg_data, deg_n,
                 deg_log_vad, utt_start, speech_start, speech_end, utt_end,
                 delay_est, delay_conf):
    cfg = st.cfg
    ds = cfg.downsample
    nfft = cfg.align_nfft
    utt_len = speech_end - speech_start
    utt_test = MAXNUTTERANCES
    best = {"dc1": 0.0, "dc2": 0.0, "ed1": 0, "d1": 0, "ed2": 0, "d2": 0,
            "bp": 0}
    delta = nfft // (4 * ds)
    step = ((0.801 * utt_len + 40 * delta - 1) // (40 * delta)) * delta
    pad = max(75, utt_len // 10)

    bps = [speech_start + pad]
    while True:
        nxt = bps[-1] + step
        if not (nxt <= speech_end - pad and len(bps) < 40):
            break
        bps.append(int(nxt))
    n_bps = len(bps)
    if n_bps < 1 or (speech_start + pad > speech_end - pad):
        return best

    ed1 = np.zeros(n_bps, dtype=np.int64)
    ed2 = np.zeros(n_bps, dtype=np.int64)
    d1 = np.zeros(n_bps, dtype=np.int64)
    d2 = np.zeros(n_bps, dtype=np.int64)
    dc1 = np.full(n_bps, -2.0)
    dc2 = np.zeros(n_bps)

    for i, bp in enumerate(bps):
        st.utt_delay_est[utt_test] = delay_est
        st.search_start[utt_test] = utt_start
        st.search_end[utt_test] = bp
        _crude_align(st, ref_log_vad, ref_n, deg_log_vad, deg_n, utt_test)
        ed1[i] = st.utt_delay[utt_test]

        st.utt_delay_est[utt_test] = delay_est
        st.search_start[utt_test] = bp
        st.search_end[utt_test] = utt_end
        _crude_align(st, ref_log_vad, ref_n, deg_log_vad, deg_n, utt_test)
        ed2[i] = st.utt_delay[utt_test]

    # first-half fine alignment per distinct estimated delay
    while True:
        bp = 0
        while bp < n_bps and dc1[bp] > -2.0:
            bp += 1
        if bp >= n_bps:
            break
        estdelay = int(ed1[bp])
        h = np.zeros(nfft)
        hsum = 0.0
        startr = (utt_start - 1) * ds + 1
        startd = startr + estdelay
        if startd < 0:
            startr = -estdelay + 1
            startd = 1
        startr, startd = max(1, startr), max(1, startd)
        startr, startd, hsum = _histogram_align(
            st, ref_data, deg_data, deg_n, estdelay, startr, startd,
            1 + (bps[bp] - 1) * ds, True, h, hsum)
        i_max = int(np.argmax(h)) + 1
        v_max = h[i_max - 1]
        if i_max - 1 >= nfft // 2:
            i_max -= nfft
        d1[bp] = estdelay + i_max - 1
        dc1[bp] = v_max / hsum if hsum > 0 else 0.0
        while bp < n_bps - 1:
            bp += 1
            if ed1[bp] == estdelay and dc1[bp] <= -2.0:
                startr, startd, hsum = _histogram_align(
                    st, ref_data, deg_data, deg_n, estdelay, startr, startd,
                    (bps[bp] - 1) * ds + 1, True, h, hsum)
                i_max = int(np.argmax(h)) + 1
                v_max = h[i_max - 1]
                if i_max - 1 >= nfft // 2:
                    i_max -= nfft
                d1[bp] = estdelay + i_max - 1
                dc1[bp] = v_max / hsum if hsum > 0 else 0.0

    dc2[:] = [(-2.0 if dc1[i] > delay_conf else 0.0) for i in range(n_bps)]

    while True:
        bp = n_bps - 1
        while bp >= 0 and dc2[bp] > -2.0:
            bp -= 1
        if bp < 0:
            break
        estdelay = int(ed2[bp])
        h = np.zeros(nfft)
        hsum = 0.0
        startr = (utt_end - 1) * ds + 1 - nfft
        startd = startr + estdelay
        if startd + nfft > deg_n + 1:
            startd = deg_n - nfft + 1
            startr = startd - estdelay
        startr, startd, hsum = _histogram_align(
            st, ref_data, deg_data, deg_n, estdelay, startr, startd,
            (bps[bp] - 1) * ds + 1, False, h, hsum)
        i_max = int(np.argmax(h)) + 1
        v_max = h[i_max - 1]
        if i_max - 1 >= nfft // 2:
            i_max -= nfft
        d2[bp] = estdelay + i_max - 1
        dc2[bp] = v_max / hsum if hsum > 0 else 0.0
        while bp > 0:
            bp -= 1
            if ed2[bp] == estdelay and dc2[bp] <= -2.0:
                startr, startd, hsum = _histogram_align(
                    st, ref_data, deg_data, deg_n, estdelay, startr, startd,
                    (bps[bp] - 1) * ds + 1, False, h, hsum)
                i_max = int(np.argmax(h)) + 1
                v_max = h[i_max - 1]
                if i_max - 1 >= nfft // 2:
                    i_max -= nfft
                d2[bp] = estdelay + i_max - 1
                dc2[bp] = v_max / hsum if hsum > 0 else 0.0

    for i in range(n_bps):
        if (abs(d2[i] - d1[i]) >= ds
                and dc1[i] + dc2[i] > best["dc1"] + best["dc2"]
                and dc1[i] > delay_conf and dc2[i] > delay_conf):
            best = {"ed1": int(ed1[i]), "d1": int(d1[i]), "dc1": float(dc1[i]),
                    "ed2": int(ed2[i]), "d2": int(d2[i]), "dc2": float(dc2[i]),
                    "bp": int(bps[i])}
    return best


def _utterance_split(st, ref_data, ref_n, ref_vad, ref_log_vad,
                     deg_data, deg_n, deg_log_vad):
    utt_id = 1
    while utt_id <= st.nutterances and st.nutterances <= MAXNUTTERANCES - 2:
        delay_est = int(st.utt_delay_est[utt_id])
        delay_conf = float(st.utt_delay_conf[utt_id])
        u_start = int(st.utt_start[utt_id])
        u_end = int(st.utt_end[utt_id])

        speech_start = max(1, u_start)
        while speech_start < u_end and ref_vad[speech_start - 1] <= 0.0:
            speech_start += 1
        speech_end = u_end
        while speech_end > u_start and ref_vad[speech_end - 1] <= 0:
            speech_end -= 1
        speech_end += 1
        utt_len = speech_end - speech_start

        if utt_len >= 200:
            best = _split_align(
                st, ref_data, ref_n, ref_log_vad, deg_data, deg_n,
                deg_log_vad, u_start, speech_start, speech_end, u_end,
                delay_est, delay_conf)
            if best["dc1"] > delay_conf and best["dc2"] > delay_conf:
                for step in range(st.nutterances, utt_id, -1):
                    st.utt_delay_est[step + 1] = st.utt_delay_est[step]
                    st.utt_delay[step + 1] = st.utt_delay[step]
                    st.utt_delay_conf[step + 1] = st.utt_delay_conf[step]
                    st.utt_start[step + 1] = st.utt_start[step]
                    st.utt_end[step + 1] = st.utt_end[step]
                    st.search_start[step + 1] = st.utt_start[step]
                    st.search_end[step + 1] = st.utt_end[step]
                st.nutterances += 1
                st.utt_delay_est[utt_id] = best["ed1"]
                st.utt_delay[utt_id] = best["d1"]
                st.utt_delay_conf[utt_id] = best["dc1"]
                st.utt_delay_est[utt_id + 1] = best["ed2"]
                st.utt_delay[utt_id + 1] = best["d2"]
                st.utt_delay_conf[utt_id + 1] = best["dc2"]
                st.search_start[utt_id + 1] = st.search_start[utt_id]
                st.search_end[utt_id + 1] = st.search_end[utt_id]
                ds = st.cfg.downsample
                if best["d2"] < best["d1"]:
                    st.utt_start[utt_id] = u_start
                    st.utt_end[utt_id] = best["bp"]
                    st.utt_start[utt_id + 1] = best["bp"]
                    st.utt_end[utt_id + 1] = u_end
                else:
                    st.utt_start[utt_id] = u_start
                    st.utt_end[utt_id] = best["bp"] + (
                        best["d2"] - best["d1"]) // (2 * ds)
                    st.utt_start[utt_id + 1] = best["bp"] - (
                        best["d2"] - best["d1"]) // (2 * ds)
                    st.utt_end[utt_id + 1] = u_end
                if ((st.utt_start[utt_id] - SEARCHBUFFER - 1) * ds + 1
                        + best["d1"] < 0):
                    st.utt_start[utt_id] = SEARCHBUFFER + 1 + (
                        ds - 1 - best["d1"]) // ds
                if ((st.utt_end[utt_id + 1] - 1) * ds + 1 + best["d2"]
                        > deg_n - SEARCHBUFFER * ds):
                    st.utt_end[utt_id + 1] = (
                        deg_n - best["d2"]) // ds - SEARCHBUFFER + 1
            else:
                utt_id += 1
        else:
            utt_id += 1


# --------------------------------------------------- psychoacoustic model

def _freq_warping(hz_spectrum, cfg):
    out = np.zeros(cfg.nb)
    hz = 0
    for band in range(cfg.nb):
        n = cfg.nr_hz[band]
        out[band] = np.sum(hz_spectrum[hz : hz + n]) * cfg.pow_corr[band] \
            * cfg.sp
        hz += n
    return out


def _total_audible(ppd_frame, cfg, factor):
    h = ppd_frame[1:]
    thresh = factor * cfg.abs_thresh[1:]
    return float(np.sum(h[h > thresh]))


def _intensity_warping(ppd_frame, cfg):
    zwicker = 0.23
    h = np.where(cfg.centre_bark < 4, 6.0 / (cfg.centre_bark + 2.0), 1.0)
    h = np.minimum(h, 2.0) ** 0.15
    mod_zwicker = zwicker * h
    thresh = cfg.abs_thresh
    loud = ((thresh / 0.5) ** mod_zwicker) * (
        (0.5 + 0.5 * ppd_frame / thresh) ** mod_zwicker - 1.0)
    loud = np.where(ppd_frame > thresh, loud, 0.0)
    return loud * cfg.sl


def _pseudo_lp(x, p, cfg):
    h = np.abs(x[1:])
    w = cfg.width_bark[1:]
    total_w = np.sum(w)
    result = (np.sum((h * w) ** p) / total_w) ** (1.0 / p)
    return result * total_w


def _multiply_with_asymmetry(dist, ppd_ref, ppd_deg):
    ratio = (ppd_deg + 50.0) / (ppd_ref + 50.0)
    h = ratio ** 1.2
    h = np.where(h > 12.0, 12.0, h)
    h = np.where(h < 3.0, 0.0, h)
    return dist * h


def _lpq_weight(start_frame, stop_frame, power_syllable, power_time,
                frame_disturbance, time_weight):
    n_syl = 20
    result_time = 0.0
    total_w = 0.0
    for s0 in range(start_frame, stop_frame + 1, n_syl // 2):
        result_syl = 0.0
        count = 0
        for frame in range(s0, s0 + n_syl):
            if frame <= stop_frame:
                result_syl += frame_disturbance[frame] ** power_syllable
            count += 1
        result_syl = (result_syl / count) ** (1.0 / power_syllable)
        w = time_weight[s0 - start_frame]
        result_time += (w * result_syl) ** power_time
        total_w += w ** power_time
    return (result_time / total_w) ** (1.0 / power_time)


def _compute_delay(start1, stop1, search_range, ts1, ts2):
    n = stop1 - start1 + 1
    pow2 = 1 << int(np.ceil(np.log2(2 * n)))
    power1 = _pow_of(ts1, start1, stop1, n) * n / pow2
    power2 = _pow_of(ts2, start1, stop1, n) * n / pow2
    normalization = np.sqrt(power1 * power2)
    if power1 <= 1e-6 or power2 <= 1e-6:
        return 0, 0.0
    x1 = np.zeros(pow2)
    x2 = np.zeros(pow2)
    x1[:n] = np.abs(ts1[start1 - 1 : stop1])
    x2[:n] = np.abs(ts2[start1 - 1 : stop1])
    y = np.fft.ifft(np.conj(np.fft.fft(x1) / pow2) * np.fft.fft(x2)).real
    best_delay = 0
    max_corr = 0.0
    for i in range(-search_range, 0):
        hval = abs(y[i + pow2]) / normalization
        if hval > max_corr:
            max_corr = hval
            best_delay = i
    for i in range(0, search_range):
        hval = abs(y[i]) / normalization
        if hval > max_corr:
            max_corr = hval
            best_delay = i
    return best_delay - 1, max_corr


def _psychoacoustic_model(st, ref_data, ref_n, deg_data, deg_n):
    cfg = st.cfg
    ds = cfg.downsample
    nf = ds * 8
    nb = cfg.nb
    max_n = max(ref_n, deg_n)
    window = 0.5 * (1.0 - np.cos(2 * np.pi * np.arange(nf) / nf))

    def short_term_fft(data, start1):
        x1 = data[start1 - 1 : start1 - 1 + nf] * window
        spec = np.abs(np.fft.fft(x1)[: nf // 2]) ** 2
        spec[0] = 0.0
        return spec

    d_pow_f, d_pow_s, d_pow_t = 2, 6, 2
    a_pow_f, a_pow_s, a_pow_t = 1, 6, 2
    d_weight, a_weight = 0.1, 0.0309

    crit_silence = 500
    skip_start = 0
    while skip_start < max_n / 2:
        s = np.sum(np.abs(ref_data[
            skip_start + SEARCHBUFFER * ds : skip_start + SEARCHBUFFER * ds + 5]))
        if s >= crit_silence:
            break
        skip_start += 1
    skip_end = 0
    end_base = max_n - SEARCHBUFFER * ds + cfg.padding
    while skip_end < max_n / 2:
        s = np.sum(np.abs(ref_data[
            end_base - skip_end - 5 : end_base - skip_end]))
        if s >= crit_silence:
            break
        skip_end += 1

    start_frame = skip_start // (nf // 2)
    stop_frame = (max_n - 2 * SEARCHBUFFER * ds + cfg.padding
                  - skip_end) // (nf // 2) - 1
    n_frames = stop_frame + 1

    ppd_ref = np.zeros((n_frames, nb))
    ppd_deg = np.zeros((n_frames, nb))
    silent = np.zeros(n_frames, bool)
    total_power_ref = np.zeros(n_frames)

    for frame in range(n_frames):
        start_ref = 1 + SEARCHBUFFER * ds + frame * (nf // 2)
        spec_ref = short_term_fft(ref_data, start_ref)

        utt = st.nutterances
        while utt >= 1 and (st.utt_start[utt] - 1) * ds + 1 > start_ref:
            utt -= 1
        delay = int(st.utt_delay[utt if utt >= 1 else 1])
        start_deg = start_ref + delay
        if start_deg > 0 and start_deg + nf - 1 < max_n + cfg.padding:
            spec_deg = short_term_fft(deg_data, start_deg)
        else:
            spec_deg = np.zeros(nf // 2)

        ppd_ref[frame] = _freq_warping(spec_ref, cfg)
        ppd_deg[frame] = _freq_warping(spec_deg, cfg)
        silent[frame] = _total_audible(ppd_ref[frame], cfg, 1e2) < 1e7

    total_frames = (max_n - 2 * SEARCHBUFFER * ds + cfg.padding) // (nf // 2) - 1

    def time_avg_audible(ppd):
        avg = np.zeros(nb)
        for band in range(nb):
            vals = ppd[~silent, band]
            avg[band] = np.sum(
                vals[vals > 100 * cfg.abs_thresh[band]]) / total_frames
        return avg

    avg_ref = time_avg_audible(ppd_ref)
    avg_deg = time_avg_audible(ppd_deg)

    # frequency response compensation of the reference
    x = np.clip((avg_deg + 1000.0) / (avg_ref + 1000.0), 0.01, 100.0)
    ppd_ref = ppd_ref * x[None, :]

    max_scale, min_scale = 5.0, 3e-4
    threshold_bad = 30
    frame_disturbance = np.zeros(n_frames)
    frame_disturbance_asym = np.zeros(n_frames)
    there_is_bad = False
    old_scale = 1.0
    for frame in range(n_frames):
        tap_ref = _total_audible(ppd_ref[frame], cfg, 1)
        tap_deg = _total_audible(ppd_deg[frame], cfg, 1)
        total_power_ref[frame] = tap_ref
        scale = (tap_ref + 5e3) / (tap_deg + 5e3)
        if frame > 0:
            scale = 0.2 * old_scale + 0.8 * scale
        old_scale = scale
        scale = np.clip(scale, min_scale, max_scale)
        ppd_deg[frame] *= scale

        loud_ref = _intensity_warping(ppd_ref[frame], cfg)
        loud_deg = _intensity_warping(ppd_deg[frame], cfg)
        dist = loud_deg - loud_ref
        deadzone = 0.25 * np.minimum(loud_deg, loud_ref)
        dist = np.where(dist > deadzone, dist - deadzone,
                        np.where(dist < -deadzone, dist + deadzone, 0.0))
        frame_disturbance[frame] = _pseudo_lp(dist, d_pow_f, cfg)
        if frame_disturbance[frame] > threshold_bad:
            there_is_bad = True
        dist_asym = _multiply_with_asymmetry(dist, ppd_ref[frame],
                                             ppd_deg[frame])
        frame_disturbance_asym[frame] = _pseudo_lp(dist_asym, a_pow_f, cfg)

    # frames skipped across big negative delay jumps between utterances
    for utt in range(2, st.nutterances + 1):
        frame1 = int(((st.utt_start[utt] - 1 - SEARCHBUFFER) * ds + 1
                      + st.utt_delay[utt]) // (nf // 2))
        j = int(((st.utt_end[utt - 1] - 1 - SEARCHBUFFER) * ds + 1
                 + st.utt_delay[utt - 1]) // (nf // 2))
        delay_jump = st.utt_delay[utt] - st.utt_delay[utt - 1]
        frame1 = max(0, min(frame1, j))
        if delay_jump < -(nf // 2):
            frame2 = int(((st.utt_start[utt] - 1 - SEARCHBUFFER) * ds + 1
                          + max(0, abs(delay_jump))) // (nf // 2)) + 1
            for frame in range(frame1, frame2 + 1):
                if frame < stop_frame:
                    frame_disturbance[frame] = 0.0
                    frame_disturbance_asym[frame] = 0.0

    # bad-interval realignment
    if there_is_bad:
        nn_len = cfg.padding + max_n
        tweaked = np.zeros(nn_len)
        for i in range(SEARCHBUFFER * ds + 1, nn_len - SEARCHBUFFER * ds + 1):
            utt = st.nutterances
            while utt >= 1 and (st.utt_start[utt] - 1) * ds > i:
                utt -= 1
            delay = int(st.utt_delay[utt if utt >= 1 else 1])
            j = np.clip(i + delay, SEARCHBUFFER * ds + 1,
                        nn_len - SEARCHBUFFER * ds)
            tweaked[i - 1] = deg_data[j - 1]

        frame_is_bad = frame_disturbance > threshold_bad
        frame_is_bad[0] = False
        smeared = np.zeros(n_frames, bool)
        smear = 2
        for frame in range(smear, stop_frame - smear):
            left = frame_is_bad[frame - smear : frame + 1].max()
            right = frame_is_bad[frame : frame + smear + 1].max()
            smeared[frame] = min(left, right)

        intervals = []
        frame = 0
        while frame <= stop_frame:
            while frame <= stop_frame and not smeared[frame]:
                frame += 1
            if frame <= stop_frame:
                s = frame
                while frame <= stop_frame and smeared[frame]:
                    frame += 1
                if frame <= stop_frame and frame - s >= 5:
                    intervals.append((s + 1, frame + 1))  # 1-based frames

        search_range = 4 * nf
        doubly = tweaked[: max_n + cfg.padding].copy()
        for (sf, ef) in intervals:
            s_samp = (sf - 1) * (nf // 2) + SEARCHBUFFER * ds + 1
            e_samp = (ef - 1) * (nf // 2) + nf + SEARCHBUFFER * ds
            n_samp = e_samp - s_samp + 1
            ref_seg = np.zeros(2 * search_range + n_samp)
            ref_seg[search_range : search_range + n_samp] = ref_data[
                s_samp : s_samp + n_samp]
            deg_seg = np.zeros(2 * search_range + n_samp)
            nn2 = max_n - SEARCHBUFFER * ds + cfg.padding
            for i in range(2 * search_range + n_samp):
                j = np.clip(s_samp - search_range + i,
                            SEARCHBUFFER * ds + 1, nn2)
                deg_seg[i] = tweaked[j - 1]
            delay_samp, corr = _compute_delay(
                1, 2 * search_range + n_samp, search_range, ref_seg, deg_seg)
            if corr < 0.5:
                delay_samp = 0
            for i in range(s_samp, e_samp + 1):
                j = np.clip(i + delay_samp, 1, max_n)
                doubly[i - 1] = tweaked[j - 1]

        if intervals:
            for (sf, ef) in intervals:
                old_scale = 1.0
                for fr1 in range(sf, ef):
                    frame = fr1 - 1 - 1  # matlab: frame= frame- 1 then 0-base
                    if frame < 0:
                        continue
                    start_s = SEARCHBUFFER * ds + frame * (nf // 2) + 1
                    spec_deg = short_term_fft(doubly, start_s)
                    ppd_deg_f = _freq_warping(spec_deg, cfg)
                    tap_ref = _total_audible(ppd_ref[frame], cfg, 1)
                    tap_deg = _total_audible(ppd_deg_f, cfg, 1)
                    scale = (tap_ref + 5e3) / (tap_deg + 5e3)
                    if frame > 0:
                        scale = 0.2 * old_scale + 0.8 * scale
                    old_scale = scale
                    scale = np.clip(scale, min_scale, max_scale)
                    ppd_deg_f = ppd_deg_f * scale
                    loud_ref = _intensity_warping(ppd_ref[frame], cfg)
                    loud_deg = _intensity_warping(ppd_deg_f, cfg)
                    dist = loud_deg - loud_ref
                    deadzone = 0.25 * np.minimum(loud_deg, loud_ref)
                    dist = np.where(
                        dist > deadzone, dist - deadzone,
                        np.where(dist < -deadzone, dist + deadzone, 0.0))
                    frame_disturbance[frame] = min(
                        frame_disturbance[frame],
                        _pseudo_lp(dist, d_pow_f, cfg))
                    dist_asym = _multiply_with_asymmetry(
                        dist, ppd_ref[frame], ppd_deg_f)
                    frame_disturbance_asym[frame] = min(
                        frame_disturbance_asym[frame],
                        _pseudo_lp(dist_asym, a_pow_f, cfg))

    time_weight = np.ones(n_frames)
    if n_frames > 1000:
        n = (max_n - 2 * SEARCHBUFFER * ds) // (nf // 2) - 1
        twf = min(0.5, (n - 1000) / 5500)
        time_weight = (1.0 - twf) + twf * np.arange(n_frames) / n

    h = ((total_power_ref + 1e5) / 1e7) ** 0.04
    frame_disturbance = np.minimum(frame_disturbance / h, 45.0)
    frame_disturbance_asym = np.minimum(frame_disturbance_asym / h, 45.0)

    d_ind = _lpq_weight(start_frame, stop_frame, d_pow_s, d_pow_t,
                        frame_disturbance, time_weight)
    a_ind = _lpq_weight(start_frame, stop_frame, a_pow_s, a_pow_t,
                        frame_disturbance_asym, time_weight)
    return 4.5 - d_weight * d_ind - a_weight * a_ind


# --------------------------------------------------------------- entrypoint

def pesq(ref: np.ndarray, deg: np.ndarray, fs: int = 16000):
    """Returns MOS-LQO (wideband, fs=16000) or (pesq_mos, mos_lqo)
    (narrowband, fs=8000). Inputs: float waveforms in [-1, 1]."""
    cfg = _Cfg(fs)
    ds = cfg.downsample

    def prepare(x):
        x = np.asarray(x, np.float64).ravel() * 32768.0
        n_used = len(x) + 2 * SEARCHBUFFER * ds
        x = np.concatenate([
            np.zeros(SEARCHBUFFER * ds), x,
            np.zeros(cfg.padding + SEARCHBUFFER * ds)])
        return x, n_used

    ref_data, ref_n = prepare(ref)
    deg_data, deg_n = prepare(deg)
    max_n = max(ref_n, deg_n)
    ref_data = _fix_power_level(ref_data, ref_n, max_n, cfg)
    deg_data = _fix_power_level(deg_data, deg_n, max_n, cfg)

    if fs == 8000:
        ref_data = _apply_fft_filter(ref_data, ref_n, _IRS_FILTER_DB, cfg)
        deg_data = _apply_fft_filter(deg_data, deg_n, _IRS_FILTER_DB, cfg)
    else:
        ref_data = _apply_iir(ref_data, _WB_IIR_SOS[fs])
        deg_data = _apply_iir(deg_data, _WB_IIR_SOS[fs])

    model_ref = ref_data.copy()
    model_deg = deg_data.copy()

    ref_f = _apply_iir(_dc_block(ref_data, ref_n, cfg), cfg.iir_sos)
    deg_f = _apply_iir(_dc_block(deg_data, deg_n, cfg), cfg.iir_sos)

    ref_vad, ref_log_vad = _apply_vad(ref_f, ref_n, cfg)
    deg_vad, deg_log_vad = _apply_vad(deg_f, deg_n, cfg)

    st = _State(cfg)
    _crude_align(st, ref_log_vad, ref_n, deg_log_vad, deg_n, -1)
    _id_searchwindows(st, ref_vad, ref_n, deg_n)
    for utt in range(1, st.nutterances + 1):
        _crude_align(st, ref_log_vad, ref_n, deg_log_vad, deg_n, utt)
        _time_align(st, ref_f, ref_n, deg_f, deg_n, utt)
    _id_utterances(st, ref_n, ref_vad, deg_n)
    _utterance_split(st, ref_f, ref_n, ref_vad, ref_log_vad,
                     deg_f, deg_n, deg_log_vad)

    # equalize lengths for the model
    newlen = max_n + cfg.padding
    if len(model_ref) < newlen:
        model_ref = np.pad(model_ref, (0, newlen - len(model_ref)))
    if len(model_deg) < newlen:
        model_deg = np.pad(model_deg, (0, newlen - len(model_deg)))

    pesq_mos = _psychoacoustic_model(st, model_ref, ref_n, model_deg, deg_n)

    if fs == 8000:
        mos_lqo = 0.999 + 4.0 / (1.0 + np.exp(-1.4945 * pesq_mos + 4.6607))
        return float(pesq_mos), float(mos_lqo)
    mos_lqo = 0.999 + 4.0 / (1.0 + np.exp(-1.3669 * pesq_mos + 3.8224))
    return float(mos_lqo)
