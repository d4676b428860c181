"""Build, load and launch the port's CUDA kernels.

`se_tpu_torch/csrc/*.cu` are compiled with nvcc for `sm_90a` at first use,
one nvcc process per source, all started together, and linked into one
shared library with a plain C interface, loaded with ctypes. The library
lands in `se_tpu_torch/_build/`, named by a hash of the sources and flags,
so a changed source builds anew and an unchanged one is loaded as it is.

Every C entry takes its pointers, sizes and the CUDA stream, enqueues its
kernel(s) on that stream and returns `cudaGetLastError()`; `launch` raises
on a non-zero code. `launch` runs an entry on the device its tensors lie
on: that device's current stream, and that device made current in the
library (which links its own CUDA runtime, so `torch.cuda.device` does not
reach it) before the call. `LAUNCHES` counts the wrapper calls that
launched a kernel, by kernel name; a bf16 variant counts under its own
name (`variant`: attention_bf16, ...), never under the fp32 kernel's.
`LAUNCHES` counts whether or not the span recorder is on. A launch's host
work is the span `kernel.launch`, a weight pack's (`packs`) the span named
by its pack function.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from se_tpu_torch.utils.profiling import span

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
        _lib.se_set_device.restype = ctypes.c_int
        _lib.se_set_device.argtypes = [ctypes.c_int]
    return _lib


def check(t: torch.Tensor, shape: tuple, name: str,
          dtype: torch.dtype = torch.float32) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and
    `shape`."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: this launch takes {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def launch_dtype(kernel: str, *tensors: torch.Tensor) -> torch.dtype:
    """The one dtype of a launch's activations `tensors` (`kernel` names
    the launch in the message): float32 or bfloat16, each kernel's fp32
    or bf16 variant. Raise TypeError on mixed dtypes and on any other
    dtype: nothing is cast."""
    found = {t.dtype for t in tensors}
    if len(found) != 1:
        raise TypeError(f"{kernel}: a launch's activations share one dtype, "
                        f"got {', '.join(sorted(map(str, found)))}")
    (dtype,) = found
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{kernel}: the kernels take float32 or bfloat16, "
                        f"got {dtype}")
    return dtype


def lstm_dtype(x: torch.Tensor | None, weights, fp32=()) -> torch.dtype:
    """The variant of an LSTM launch, the LSTM's own dtype rule: the
    weights' one dtype, float32 or bfloat16 (se_tpu's bf16 decode casts
    the parameters alone). x (None: no x) is fp32, or fp32 or bf16 at bf16
    weights; the tensors of `fp32` ((name, tensor or None): XP, h0, c0)
    are fp32 at either. Raise TypeError on any other mix: nothing is
    cast."""
    found = {w.dtype for w in weights}
    if len(found) != 1:
        raise TypeError(f"lstm: the weights share one dtype, got "
                        f"{', '.join(sorted(map(str, found)))}")
    (dtype,) = found
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"lstm: the kernels take float32 or bfloat16 "
                        f"weights, got {dtype}")
    xs = (torch.float32, torch.bfloat16) if dtype == torch.bfloat16 \
        else (torch.float32,)
    if x is not None and x.dtype not in xs:
        raise TypeError(f"lstm: x is {x.dtype}; {dtype} weights take x in "
                        f"{' or '.join(map(str, xs))}")
    for name, t in fp32:
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"lstm: {name} is float32 at every variant, "
                            f"got {t.dtype}")
    return dtype


def variant(name: str, dtype: torch.dtype) -> str:
    """`name` of the fp32 entry or counter, `name`_bf16 of the bf16 one."""
    return f"{name}_bf16" if dtype == torch.bfloat16 else name


def launch_device(devices) -> torch.device:
    """The one CUDA device of a launch's tensors; raise if they span
    devices or none lies on a CUDA device."""
    found = set(devices)
    if len(found) != 1:
        raise ValueError("a kernel's tensors must lie on one CUDA device, got "
                         + (", ".join(sorted(map(str, found))) or "none"))
    (dev,) = found
    if dev.type != "cuda" or dev.index is None:
        raise ValueError(f"a kernel's tensors must lie on a CUDA device, "
                         f"got {dev}")
    return dev


def _check(lib, entry: str, err: int) -> None:
    if err != 0:
        msg = lib.se_error_string(err).decode()
        raise RuntimeError(f"{entry}: CUDA error {err}: {msg}")


def packs(fn):
    """Make the weight-pack function `fn` record each pack it makes as a
    span named by the function."""
    name = fn.__name__

    @functools.wraps(fn)
    def pack(*args, **kw):
        with span(name):
            return fn(*args, **kw)

    return pack


def launch(entry: str, *args) -> None:
    """Call C entry `entry` with tensors as pointers (None as NULL), ints
    as int and floats as float, plus the current stream of the tensors'
    device, made current first; raise if it reports an error. The whole
    is the span `kernel.launch`."""
    with span("kernel.launch"):
        dev = launch_device(a.device for a in args
                            if isinstance(a, torch.Tensor))
        lib = library()
        fn = getattr(lib, entry)
        conv = []
        for a in args:
            if isinstance(a, torch.Tensor):
                conv.append(ctypes.c_void_p(a.data_ptr()))
            elif a is None:  # a NULL pointer
                conv.append(ctypes.c_void_p(None))
            elif isinstance(a, int):  # bool included
                conv.append(ctypes.c_int(int(a)))
            elif isinstance(a, float):
                conv.append(ctypes.c_float(a))
            else:
                raise TypeError(f"{entry}: cannot pass {type(a).__name__}")
        stream = torch.cuda.current_stream(dev).cuda_stream
        conv.append(ctypes.c_void_p(stream))
        if entry not in _declared:
            fn.argtypes = [type(c) for c in conv]
            fn.restype = ctypes.c_int
            _declared.add(entry)
        _check(lib, "se_set_device", lib.se_set_device(dev.index))
        _check(lib, entry, fn(*conv))
