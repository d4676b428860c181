"""Build, load and launch the port's CUDA kernels.

`se_tpu_torch/csrc/*.cu` are compiled with nvcc for `sm_90a` at first use,
one nvcc process per source, all started together, and linked into one
shared library with a plain C interface, loaded with ctypes. The library
lands in `se_tpu_torch/_build/`, named by a hash of the sources and flags,
so a changed source builds anew and an unchanged one is loaded as it is.

Every C entry takes its pointers, sizes and the CUDA stream, enqueues its
kernel(s) on that stream and returns `cudaGetLastError()`; `launch` raises
on a non-zero code. `LAUNCHES` counts the wrapper calls that launched a
kernel, by kernel name.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: collections.Counter = collections.Counter()

_lib: ctypes.CDLL | None = None
_declared: set = set()
build_log = ""  # nvcc's output (with -Xptxas -v) of this process's build


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libse_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the kernels unless this exact build exists."""
    global build_log
    lib = _library_path()
    if lib.exists():
        return lib
    nvcc = _nvcc()
    work = BUILD_DIR / f"{lib.stem}.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in _sources():
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs))
    tmp = work / lib.name
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    shutil.rmtree(work, ignore_errors=True)
    build_log = "\n".join(logs)
    return lib


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
        _lib.se_error_string.restype = ctypes.c_char_p
        _lib.se_error_string.argtypes = [ctypes.c_int]
    return _lib


def check(t: torch.Tensor, shape: tuple, name: str) -> None:
    """Raise unless `t` is a contiguous fp32 CUDA tensor of `shape`."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the kernels take float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def launch(entry: str, *args) -> None:
    """Call C entry `entry` with tensors as pointers, ints as int and floats
    as float, plus the current stream; raise if it reports an error."""
    lib = library()
    fn = getattr(lib, entry)
    conv = []
    for a in args:
        if isinstance(a, torch.Tensor):
            conv.append(ctypes.c_void_p(a.data_ptr()))
        elif isinstance(a, int):  # bool included
            conv.append(ctypes.c_int(int(a)))
        elif isinstance(a, float):
            conv.append(ctypes.c_float(a))
        else:
            raise TypeError(f"{entry}: cannot pass {type(a).__name__}")
    conv.append(ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if entry not in _declared:
        fn.argtypes = [type(c) for c in conv]
        fn.restype = ctypes.c_int
        _declared.add(entry)
    err = fn(*conv)
    if err != 0:
        msg = lib.se_error_string(err).decode()
        raise RuntimeError(f"{entry}: CUDA error {err}: {msg}")
