#!/usr/bin/env python3
"""Drive se_tpu_torch's main path, Uformer waveform enhancement, on one
NVIDIA GPU, and hold every CUDA kernel of that path against its plain
PyTorch twin.

    python3 chip_smoke.py

Phases, one JSON line per result:
  1. env:    the card (nvidia-smi name and power limit), torch and CUDA;
             TF32 off for matmuls and cuDNN.
  2. build:  nvcc builds se_tpu_torch/csrc/*.cu (timed).
  3. kernel: each kernel at every shape one Uformer forward gives it at
             B = 4 x 4 s (T = 401), against its twin on the same CUDA
             inputs: max abs error within 1e-4 * max(1, max|twin|), kernel
             and twin times (CUDA events, median of 5 runs of 10 launches
             after warm-up), the bound from the shapes, and for attention
             F.scaled_dot_product_attention's time as a yardstick the port
             never calls.
  4. main:   Uformer from a seed (BN statistics moved off their defaults),
             `enhance_waveform` on B = 4 x 4 s on the card with the launch
             counts set to 0 just before and read just after: every kernel
             must have launched, the output must be finite and within
             1e-3 * max|cpu| of the same weights run on the CPU.
  5. speed:  fp32 enhance throughput at B = 32 and B = 256 x 4 s, median
             audio-seconds/s of 5 timed calls, with peak device memory.
  6. profile: torch.profiler over one enhance call at B = 32: device time
             by kernel name and the device's busy share of the wall time.
Then the kernel table as one JSON line and, last, the device line. Any
failure exits non-zero; without a CUDA device, or without the se_tpu_torch
package beside this file, it exits 1 before printing any result.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SR, HOP, SECONDS, B_MAIN = 16000, 160, 4, 4
T_FRAMES = SECONDS * SR // HOP + 1  # 401
KERNELS = (1, 8, 16, 32, 64, 128, 128)
DILATIONS = (1, 2, 4, 8, 16, 32, 64, 128)
# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 10, rounds: int = 5) -> float:
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors) -> int:
    total = 0
    for t in tensors:
        total += sum(x.numel() * 4 for x in t) if isinstance(t, tuple) \
            else t.numel() * 4
    return total


def valid_taps(n: int, positions) -> int:
    """Count the (position, tap) pairs whose input index lies in [0, n);
    `positions` yields (position, [input index of each tap])."""
    return sum(1 for _, idx in positions for i in idx if 0 <= i < n)


# --------------------------------------------------------- the kernel cases

def attention_cases(gen, dev):
    import torch

    b, t, f = B_MAIN, T_FRAMES, 4
    for n, h, l in ((b * f, 8, t), (b * f, 1, t), (b * t, 8, f),
                    (b * t, 1, f)):
        q, k, v = (torch.randn(n, h, l, 16, generator=gen).to(dev) * 0.5
                   for _ in range(3))
        flops = 4.0 * n * h * l * l * 16
        yield f"attention {n}x{h}x{l}x16", (q, k, v, 0.25), flops, \
            nbytes(q, k, v, q)


def dsconv_params(gen, cin, tot, dev):
    import torch

    def r(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(dev)

    return (r(1, cin, scale=0.1, shift=1.0), r(1, cin, scale=0.1),
            r(cin, tot, scale=cin ** -0.5), r(1, tot, scale=0.1),
            torch.full((1, 1), 0.25, device=dev),
            r(9 * tot, tot, scale=(9 * tot) ** -0.5), r(1, tot, scale=0.1),
            r(9 * tot, tot, scale=(9 * tot) ** -0.5), r(1, tot, scale=0.1),
            r(1, tot, scale=0.1, shift=1.0), r(1, tot, scale=0.1),
            r(tot, cin, scale=tot ** -0.5), r(1, cin, scale=0.1))


def dsconv_cases(gen, dev):
    import torch

    b, t, f = B_MAIN, T_FRAMES, 4
    n = len(DILATIONS)
    for ncomp, cin, tot in ((2, 256, 64), (1, 128, 32)):
        params = dsconv_params(gen, cin, tot, dev)
        x = torch.randn(b, t, f, cin, generator=gen).to(dev)
        # the two 1x1 convs on every row; the dilated 3x3 convs only on the
        # taps that land inside (T, F), zero padding being no work
        f_taps = valid_taps(f, ((ff, [ff - 1, ff, ff + 1])
                                for ff in range(f)))
        for i, d1 in enumerate(DILATIONS):
            d2 = DILATIONS[n - i - 1]
            t_taps = sum(valid_taps(t, ((tt, [tt - d, tt, tt + d])
                                        for tt in range(t)))
                         for d in (d1, d2))
            flops = 2.0 * b * (t * f * 2 * cin * tot
                               + t_taps * f_taps * tot * tot)
            yield (f"dsconv ncomp={ncomp} {b}x{t}x{f}x{cin} d=({d1},{d2})",
                   (x, params, d1, d2, ncomp), flops,
                   nbytes(x, params, x))


def level_params(gen, shapes, dev):
    import torch

    out = []
    for shape in shapes:
        if shape == (1, 1):
            out.append(torch.full((1, 1), 0.2, device=dev))
        elif len(shape) > 2:
            fan = shape[-2] * (10 if len(shape) == 4 else 5)
            out.append((torch.randn(*shape, generator=gen) * fan ** -0.5)
                       .to(dev))
        else:
            out.append((torch.randn(*shape, generator=gen) * 0.1 + 1.0)
                       .to(dev))
    return tuple(out)


def encoder_cases(gen, dev):
    import torch

    b, t = B_MAIN, T_FRAMES
    t_taps = 2 * t - 1
    for i in range(6):
        f, cin, cout = 256 >> i, KERNELS[i], KERNELS[i + 1]
        shapes = ((2, 5, 2 * cin, 2 * cout), (1, 2 * cout), (1, 2 * cout),
                  (1, 2 * cout), (1, 1), (2, 5, cin, cout), (1, cout),
                  (1, cout), (1, cout), (1, 1))
        params = level_params(gen, shapes, dev)
        xc = torch.randn(b, t, f, 2 * cin, generator=gen).to(dev)
        xm = torch.randn(b, t, f, cin, generator=gen).to(dev)
        f_taps = valid_taps(f, ((fo, [2 * fo + j - 2 for j in range(5)])
                                for fo in range(f // 2)))
        flops = 2.0 * b * t_taps * f_taps * 5 * cin * cout
        out_bytes = b * t * (f // 2) * 3 * cout * 4
        yield (f"encoder level {i} {b}x{t}x{f}x{cin}->{cout}",
               (xc, xm, params), flops, nbytes(xc, xm, params) + out_bytes)


def decoder_cases(gen, dev):
    import torch

    b, t = B_MAIN, T_FRAMES
    t_taps = 2 * t - 1
    for i in range(6):
        f, cc, cout = 4 << i, 2 * KERNELS[6 - i], KERNELS[5 - i]
        shapes = ((6, 2 * cc, 2 * cout), (4, 2 * cc, 2 * cout),
                  (1, 2 * cout), (1, 2 * cout), (1, 2 * cout), (1, 1),
                  (6, cc, cout), (4, cc, cout), (1, cout), (1, cout),
                  (1, cout), (1, 1))
        params = level_params(gen, shapes, dev)
        xc = torch.randn(b, t, f, 2 * cc, generator=gen).to(dev)
        xm = torch.randn(b, t, f, cc, generator=gen).to(dev)
        f_taps = valid_taps(f, ((q, [q + j - 1 for j in range(3)])
                                for q in range(f)))
        f_taps += valid_taps(f, ((q, [q + j for j in range(2)])
                                 for q in range(f)))
        flops = 2.0 * b * t_taps * f_taps * 5 * cc * cout
        out_bytes = b * t * 2 * f * 3 * cout * 4
        yield (f"decoder level {i} {b}x{t}x{f}x{cc}->{cout}",
               (xc, xm, params, i < 5), flops,
               nbytes(xc, xm, params) + out_bytes)


def check_kernels(dev) -> dict:
    import torch
    import torch.nn.functional as F

    from se_tpu_torch.ops import attention, decoder, dsconv, encoder

    gen = torch.Generator().manual_seed(1)
    kinds = {
        "attention": (attention.sdp_attention, attention._reference,
                      attention_cases, "se_tpu_torch/csrc/attention.cu",
                      "se_tpu/ops/pallas_attention.py:53"),
        "dsconv": (dsconv.dsconv_block, dsconv._reference, dsconv_cases,
                   "se_tpu_torch/csrc/dsconv.cu",
                   "se_tpu/ops/pallas_dsconv.py:113"),
        "encoder": (encoder.encoder_level, encoder._reference,
                    encoder_cases, "se_tpu_torch/csrc/encoder.cu",
                    "se_tpu/ops/pallas_encoder.py:98"),
        "decoder": (decoder.decoder_level, decoder._reference,
                    decoder_cases, "se_tpu_torch/csrc/decoder.cu",
                    "se_tpu/ops/pallas_decoder.py:117"),
    }
    table = {}
    for name, (kernel, twin, cases, source, replaces) in kinds.items():
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
               "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "library_ms": 0.0 if name == "attention" else None}
        t_ops = t_bytes = 0.0
        for label, args, flops, moved in cases(gen, dev):
            got = kernel(*args)
            want = twin(*args)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            scale = max(1.0, max(float(w.abs().max()) for w in want))
            tol = 1e-4 * scale
            ms = cuda_ms(lambda: kernel(*args))
            plain = cuda_ms(lambda: twin(*args))
            b_ms, b_by = bound(flops, moved)
            res = {"phase": "kernel", "kernel": name, "case": label,
                   "max_abs_err": err, "tol": tol, "ms": ms,
                   "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                   "gflop": flops / 1e9, "mbytes": moved / 1e6}
            if name == "attention":
                q, k, v, s = args
                lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, scale=s))
                res["library_ms"] = lib
                row["library_ms"] += lib
            emit(res)
            if not err <= tol:
                fail(f"{label}: kernel and twin differ by {err} > {tol}")
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["ms"] += ms
            row["plain_ms"] += plain
            row["bound_ms"] += b_ms
            t_ops += flops / PEAK_FP32_FLOPS
            t_bytes += moved / PEAK_BYTES
        row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        table[name] = row
    return table


# ------------------------------------------------------------- main path

def seeded_uformer(seed: int):
    """Uformer on the CPU from a seed, BN statistics and affines moved off
    their defaults."""
    import torch

    from se_tpu_torch.models.uformer import Uformer
    from se_tpu_torch.nn import BatchNorm

    gen = torch.Generator().manual_seed(seed)
    model = Uformer(device="cpu", generator=gen)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                c = mod.weight.shape[0]
                mod.weight.copy_(1 + 0.1 * torch.randn(c, generator=gen))
                mod.bias.copy_(0.1 * torch.randn(c, generator=gen))
                mod.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                mod.running_var.copy_(0.5 + torch.rand(c, generator=gen))
    return model.eval()


def main_path(dev, launches):
    import numpy as np
    import torch

    from se_tpu_torch.eval.enhance import enhance_waveform

    cpu_model = seeded_uformer(0)
    model = copy.deepcopy(cpu_model).to(dev)
    wav = (np.random.default_rng(0).standard_normal(
        (B_MAIN, SECONDS * SR)) * 0.1).astype(np.float32)

    launches.clear()
    est = enhance_waveform("uformer", model, wav)
    counts = dict(launches)
    emit({"phase": "main", "launches": counts, "shape": list(est.shape)})
    for name in ("attention", "dsconv", "encoder", "decoder"):
        if counts.get(name, 0) <= 0:
            fail(f"the main path launched no {name} kernel")
    if est.shape != wav.shape or not np.isfinite(est).all():
        fail(f"enhanced output of shape {est.shape} is not finite/complete")
    ref = enhance_waveform("uformer", cpu_model, wav[:1], device="cpu")[0]
    err = float(np.abs(est[0] - ref).max())
    tol = 1e-3 * float(np.abs(ref).max())
    emit({"phase": "main", "check": "card vs cpu, utterance 0",
          "max_abs_err": err, "tol": tol})
    if not err <= tol:
        fail(f"card output differs from the CPU's by {err} > {tol}")
    return model, counts


def throughput(model, dev, card: str) -> None:
    import numpy as np
    import torch

    from se_tpu_torch.eval.enhance import enhance_waveform

    for batch in (32, 256):
        wav = (np.random.default_rng(batch).standard_normal(
            (batch, SECONDS * SR)) * 0.1).astype(np.float32)
        enhance_waveform("uformer", model, wav)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            enhance_waveform("uformer", model, wav)
            times.append(time.perf_counter() - t0)
        rates = [batch * SECONDS / t for t in times]
        emit({"phase": "speed", "metric": "uformer_enhance_fp32",
              "batch": batch, "seconds_audio": SECONDS,
              "audio_s_per_s": statistics.median(rates),
              "min": min(rates), "max": max(rates), "repeats": len(rates),
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "card": card})


def profile(model, card: str) -> None:
    """Device time by kernel over one enhance call at B = 32 x 4 s, and the
    device's busy share of the call's wall time (one stream: kernels do
    not overlap)."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from se_tpu_torch.eval.enhance import enhance_waveform

    wav = (np.random.default_rng(1).standard_normal(
        (32, SECONDS * SR)) * 0.1).astype(np.float32)
    enhance_waveform("uformer", model, wav)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        enhance_waveform("uformer", model, wav)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: the host ops that launched them carry the
    # same device time and would count it twice
    rows = [(evt.device_time_total / 1e3, evt.count, evt.key)
            for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA]
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    emit({"phase": "profile", "batch": 32, "wall_ms": wall_ms,
          "device_ms": device_ms,
          "device_busy_share": device_ms / wall_ms if wall_ms else None,
          "top": [{"ms": ms, "calls": n, "name": name[:90]}
                  for ms, n, name in rows[:12]], "card": card})


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    if not (ROOT / "se_tpu_torch" / "csrc").is_dir():
        fail(f"no se_tpu_torch package beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    from se_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    emit({"phase": "env", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device_name": torch.cuda.get_device_name(0)})

    t0 = time.perf_counter()
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": [ln.strip() for ln in _build.build_log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or ln.startswith("==")]})

    table = check_kernels(dev)
    model, counts = main_path(dev, _build.LAUNCHES)
    for name, row in table.items():
        row["launches"] = counts[name]
    throughput(model, dev, card)
    profile(model, card)

    print(card, flush=True)
    emit({"kernels": list(table.values())})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
