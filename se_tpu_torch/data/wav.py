"""WAV I/O and resampling: the port of se_tpu/data/wav.py, with its native
fast paths (`runtime/native.py`, the copied wavio.cc built by g++ at first
use) and its pure-Python ones on numpy and scipy (the port imports
nothing of se_tpu).

A small RIFF reader/writer (PCM 8/16/24/32-bit and IEEE float, mono or
multichannel) plus a polyphase resampler. Reference behaviors being
replicated:
- sf.read returns float64 in [-1, 1); we return float32.
- librosa.resample(orig_sr, 16000) in the decode scripts -> resample_poly.

Which path each call took is counted in `PATHS` ("read_wav native",
"read_wav python", "resample native", "resample python");
`runtime.native.status()` says why the native one is unavailable when it
is.
"""

from __future__ import annotations

import collections
import struct

import numpy as np
from scipy.signal import resample_poly

from se_tpu_torch.runtime.native import resample_poly_native, wav_decode_native

PATHS: collections.Counter = collections.Counter()


def read_wav(path: str, prefer_native: bool = True) -> tuple[np.ndarray, int]:
    """Returns (float32 waveform in [-1, 1], sample_rate).

    Uses the C++ decoder when built, as se_tpu's does: it returns the
    FIRST channel only, (n,), which is what the pipeline consumes. The
    pure-Python parser (`prefer_native=False`, no library, or a file the
    decoder declines) returns multichannel data as (n, channels), mono as
    (n,).
    """
    if prefer_native:
        decoded = wav_decode_native(path)
        if decoded is not None:
            PATHS["read_wav native"] += 1
            return decoded
    PATHS["read_wav python"] += 1
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif chunk_id == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, sr, _, _, bits = fmt
    if audio_format == 0xFFFE and len(data) > 0:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = 1 if bits in (16, 24, 32) else 3
    if audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
            vals = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            x = vals.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(raw, "<i4").astype(np.float32) / float(1 << 31)
        elif bits == 8:
            x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        dt = "<f4" if bits == 32 else "<f8"
        x = np.frombuffer(raw, dt).astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported audio format {audio_format}")
    if channels > 1:
        x = x.reshape(-1, channels)
    return x, sr


def write_wav(path: str, x: np.ndarray, sr: int, bits: int = 16) -> None:
    """Write float waveform as PCM16 (default) or float32 WAV."""
    x = np.asarray(x)
    channels = 1 if x.ndim == 1 else x.shape[1]
    if bits == 16:
        data = (np.clip(x, -1.0, 1.0 - 1.0 / 32768) * 32768.0).astype("<i2").tobytes()
        audio_format, bps = 1, 2
    elif bits == 32:
        data = x.astype("<f4").tobytes()
        audio_format, bps = 3, 4
    else:
        raise ValueError("bits must be 16 or 32")
    byte_rate = sr * channels * bps
    block_align = channels * bps
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, audio_format, channels, sr,
                                 byte_rate, block_align, bps * 8)
    hdr += b"data" + struct.pack("<I", len(data))
    with open(path, "wb") as f:
        f.write(hdr + data)


def resample(x: np.ndarray, orig_sr: int, target_sr: int,
             prefer_native: bool = True) -> np.ndarray:
    """Polyphase resampling (the decode scripts' librosa.resample role,
    e.g. LSTM/lstm_decode_vb.py:34): the C++ kaiser-windowed polyphase
    kernel when built (matches scipy to ~2e-7), scipy otherwise."""
    if orig_sr == target_sr:
        return x.astype(np.float32)
    g = np.gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    if prefer_native and x.ndim == 1:
        out = resample_poly_native(x, up, down)
        if out is not None:
            PATHS["resample native"] += 1
            return out
    PATHS["resample python"] += 1
    return resample_poly(x, up, down).astype(np.float32)
