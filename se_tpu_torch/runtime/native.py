"""ctypes bindings for the native data-loader library (wavio.cc, a copy of
se_tpu/runtime/wavio.cc): the port of se_tpu/runtime/native.py.

Built by g++ at first use into `se_tpu_torch/_build/`, named by a hash of
the source and flags, so a changed source builds anew. Where g++ is
missing or the build fails, every function here returns None and its
callers (`data/wav.py`) take their pure-Python paths, as se_tpu's do;
`status()` says which it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "wavio.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O3", "-shared", "-fPIC")

_LIB = None
_TRIED = False
_STATUS = "not tried"


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libse_tpu_torch_wavio_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run([gxx, *FLAGS, "-o", str(tmp), str(SOURCE)], check=True,
                   capture_output=True, timeout=120)
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing


def _load():
    global _LIB, _TRIED, _STATUS
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    try:
        if not path.is_file():
            _build(path)
        lib = ctypes.CDLL(str(path))
    except (OSError, RuntimeError, subprocess.SubprocessError) as err:
        _STATUS = f"python: the native library is unavailable ({err})"
        return None
    lib.wav_decode.restype = ctypes.c_int64
    lib.wav_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.rms_gain.restype = ctypes.c_float
    lib.rms_gain.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.resample_poly.restype = ctypes.c_int64
    lib.resample_poly.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
    ]
    _LIB = lib
    _STATUS = f"native: {path.name}"
    return lib


def available() -> bool:
    return _load() is not None


def status() -> str:
    """"native: <library>" when the library loaded, else "python: ..."
    with the reason (after a first use)."""
    _load()
    return _STATUS


def _ptr(x: np.ndarray):
    return x.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def wav_decode_native(path: str) -> tuple[np.ndarray, int] | None:
    """Decode a wav (the first channel) via the C++ library; None if the
    library is unavailable or the file unsupported."""
    lib = _load()
    if lib is None:
        return None
    with open(path, "rb") as f:
        data = f.read()
    cap = max(len(data) // 2, 16)
    out = np.empty(cap, np.float32)
    sr = ctypes.c_int32(0)
    n = lib.wav_decode(data, len(data), _ptr(out), cap, ctypes.byref(sr))
    if n < 0:
        return None
    return out[:n].copy(), int(sr.value)


def rms_gain_native(x: np.ndarray) -> float | None:
    """c = sqrt(N / sum(x^2)) in C++; None if the library is
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    return float(lib.rms_gain(_ptr(x), len(x)))


def resample_poly_native(x: np.ndarray, up: int, down: int
                         ) -> np.ndarray | None:
    """Kaiser-windowed polyphase resampling in C++ (scipy.resample_poly
    semantics); None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    n_out = -(-len(x) * up // down)
    out = np.empty(max(n_out, 1), np.float32)
    got = lib.resample_poly(_ptr(x), len(x), up, down, _ptr(out), len(out))
    if got < 0:
        return None
    return out[:got]
