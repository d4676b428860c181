"""The benchmark's general machinery: what `BENCHMARK.json` and the data
files under `port_bench/` name, weights and inputs from the seed, the
closed-loop window, the reduction of a device trace, and the result line.

Whatever belongs to one configuration, traffic mix, per-layer metric or
family sits in a file of its own, found here by its name:
`configs/<config>.json`, `traffic/<traffic>.json`, `limits/<cell>.json`,
`metrics/<metric>.py`, `reference/<family>.py`, `flops/<family>.py` and
`modes/<mode>.py`.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that may not be loaded in a run's process: the
# JAX package and JAX itself (compared whole: the port's name begins with
# the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "se_tpu")
# the port's own kernels (csrc/*.cu), by the start of the kernel's name
PORT_KERNELS = ("lstm_", "att_", "dsconv_", "encoder_level",
                "decoder_level", "stft_")
# build and kernel caches, at fixed paths inside the checkout
CACHE_ENV = {"TRITON_CACHE_DIR": "triton",
             "TORCH_EXTENSIONS_DIR": "torch_extensions"}
CACHE_DIR = ROOT / ".bench_cache"


def set_cache_env() -> None:
    """Point every build and kernel cache into the checkout (before torch
    is imported). The port builds its kernels into `se_tpu_torch/_build/`
    inside the checkout by itself."""
    for var, sub in CACHE_ENV.items():
        os.environ[var] = str(CACHE_DIR / sub)


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def data_file(kind: str, name: str) -> dict:
    """`port_bench/<kind>/<name>.json`."""
    return load_json(HERE / kind / f"{name}.json")


def module(kind: str, name: str):
    """The module `port_bench/<kind>/<name>.py` (a name may hold dots)."""
    path = HERE / kind / f"{name}.py"
    key = f"port_bench.{kind}.{name}".replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One entry of `workloads`, with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def family(self) -> str:
        return self.config["family"]

    def reference(self):
        return module("reference", self.family)

    def flops(self):
        return module("flops", self.family)

    def mode(self):
        return importlib.import_module(f"port_bench.modes.{self.traffic['mode']}")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench or benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    (w,) = found
    return Cell(name=name, chips=w["chips"],
                config=data_file("configs", w["config"]),
                traffic=data_file("traffic", w["traffic"]),
                limits=data_file("limits", name),
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])


# ------------------------------------------------------- seeds and weights

def torch_seed(seed: int) -> int:
    return seed % (2 ** 63)


def generator(seed: int, device):
    import torch

    return torch.Generator(device=device).manual_seed(torch_seed(seed))


def _init_rules(model) -> list:
    """(name, shape, kind, a, b) for every parameter and buffer of a port
    module: "u" draws U(a, b), "n" draws a + b N(0, 1), "z" zeros. The
    published inits (torch's LSTM and Linear, the conv fans), and the
    norms and PReLU slopes moved off their defaults, as chip_smoke.py's
    `seeded` moves them (here also LayerNorms and one-slope PReLUs)."""
    from se_tpu_torch.nn import BatchNorm, LayerNorm, Linear, PReLU
    from se_tpu_torch.nn.conv import ConvParams
    from se_tpu_torch.nn.recurrent import LSTM

    rules = []
    for mname, mod in model.named_modules():
        pre = f"{mname}." if mname else ""
        own = list(mod.named_parameters(recurse=False)) \
            + list(mod.named_buffers(recurse=False))
        if not own:
            continue
        for tname, t in own:
            full, shape = pre + tname, tuple(t.shape)
            if isinstance(mod, LSTM):
                bound = 1.0 / math.sqrt(mod.hidden_size)
                rule = ("z", 0.0, 0.0) if tname.startswith("bias_hh") \
                    else ("u", -bound, bound)
            elif isinstance(mod, Linear):
                bound = 1.0 / math.sqrt(mod.weight.shape[1])
                rule = ("u", -bound, bound)
            elif isinstance(mod, ConvParams):
                w = mod.weight
                cin, cout = (w.shape[0], w.shape[1]) if mod.transpose \
                    else (w.shape[1], w.shape[0])
                k = w.shape[2] * w.shape[3]
                fan = k * cin if tname == "weight" else \
                    k * (cout if mod.transpose else cin)
                bound = 1.0 / math.sqrt(fan)
                rule = ("u", -bound, bound)
            elif isinstance(mod, BatchNorm):
                rule = {"weight": ("n", 1.0, 0.1), "bias": ("n", 0.0, 0.1),
                        "running_mean": ("n", 0.0, 0.1),
                        "running_var": ("u", 0.5, 1.5)}[tname]
            elif isinstance(mod, LayerNorm):
                rule = ("n", 1.0, 0.1) if tname == "weight" else \
                    ("n", 0.0, 0.1)
            elif isinstance(mod, PReLU):
                rule = ("n", 0.25, 0.05)
            else:
                raise TypeError(f"no init rule for {full} "
                                f"({type(mod).__name__})")
            rules.append((full, shape, *rule))
    return rules


def seeded_state(model, gen, device) -> dict:
    """A state_dict for `model` drawn from `gen` on `device`: one uniform
    and one normal draw for all tensors, split by `_init_rules`."""
    import torch

    rules = _init_rules(model)
    sizes = {kind: sum(math.prod(s) for _, s, k, _, _ in rules if k == kind)
             for kind in ("u", "n")}
    draws = {"u": torch.rand(sizes["u"], generator=gen, device=device),
             "n": torch.randn(sizes["n"], generator=gen, device=device)}
    at = {"u": 0, "n": 0}
    sd = {}
    for name, shape, kind, a, b in rules:
        n = math.prod(shape)
        if kind == "z":
            sd[name] = torch.zeros(shape, device=device)
            continue
        part = draws[kind][at[kind]:at[kind] + n].reshape(shape)
        at[kind] += n
        sd[name] = a + (b - a) * part if kind == "u" else a + b * part
    return sd


# ------------------------------------------------------------ the window

@dataclasses.dataclass
class Window:
    """Calls or steps back to back: each span (start, end) in
    perf_counter ns; `wall_offset_ns` turns them into the wall clock of
    the profiler's events."""

    spans: list
    wall_offset_ns: int
    failed: int

    @property
    def seconds(self) -> float:
        return (self.spans[-1][1] - self.spans[0][0]) / 1e9

    def durations_ms(self) -> list:
        return [(b - a) / 1e6 for a, b in self.spans]


def run_window(call, seconds: float) -> Window:
    """`call(i)` for i = 0, 1, ... until `seconds` have passed since the
    first began; a call returns False when its result is not finite."""
    offset = time.time_ns() - time.perf_counter_ns()
    spans, failed = [], 0
    i = 0
    while True:
        a = time.perf_counter_ns()
        ok = call(i)
        b = time.perf_counter_ns()
        spans.append((a, b))
        failed += ok is False
        i += 1
        if b - spans[0][0] >= seconds * 1e9:
            return Window(spans, offset, failed)


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100), linear between order statistics."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


# ------------------------------------------------------------- the trace

def kernel_id(name: str) -> str:
    """A device operation's identifier: a kernel's function name without
    its return type, namespace and template arguments; a copy's name as
    the profiler gives it."""
    s = name.strip().replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    for stop in ("<", "("):
        if stop in s:
            s = s[:s.index(stop)]
    return s.rsplit("::", 1)[-1].strip() or name


def is_port_kernel(name: str) -> bool:
    return kernel_id(name).startswith(PORT_KERNELS)


@dataclasses.dataclass
class Trace:
    """The device's operations in a traced window: (name, start, end) in
    wall-clock ns, clipped to the window."""

    ops: list
    window: tuple

    @classmethod
    def from_profile(cls, prof, window: Window) -> "Trace":
        from torch.autograd import DeviceType

        lo = window.spans[0][0] + window.wall_offset_ns
        hi = window.spans[-1][1] + window.wall_offset_ns
        ops = []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            a = e.start_ns()
            b = a + e.duration_ns()
            if b > lo and a < hi:
                ops.append((e.name(), max(a, lo), min(b, hi)))
        ops.sort(key=lambda o: o[1])
        return cls(ops, (lo, hi))

    def busy(self) -> list:
        """The union of the operations' intervals, merged, in order:
        [start, end, first operation, the operation that ends last]."""
        merged = []
        for name, a, b in self.ops:
            if merged and a <= merged[-1][1]:
                if b > merged[-1][1]:
                    merged[-1][1], merged[-1][3] = b, name
            else:
                merged.append([a, b, name, name])
        return merged

    def busy_s(self) -> float:
        return sum(m[1] - m[0] for m in self.busy()) / 1e9

    def busy_in(self, spans_wall: list) -> list:
        """Device-busy seconds inside each span."""
        merged = self.busy()
        out, j = [], 0
        for a, b in spans_wall:
            while j < len(merged) and merged[j][1] <= a:
                j += 1
            k, busy = j, 0
            while k < len(merged) and merged[k][0] < b:
                busy += min(b, merged[k][1]) - max(a, merged[k][0])
                k += 1
            out.append(busy / 1e9)
        return out

    def device_s(self, match) -> float:
        """Summed device seconds of the operations `match(name)` keeps."""
        return sum(b - a for n, a, b in self.ops if match(n)) / 1e9

    def top_ops(self, n: int = 10) -> list:
        by = {}
        for name, a, b in self.ops:
            k = kernel_id(name)
            by[k] = by.get(k, 0) + (b - a) / 1e9
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle seconds summed by the operations around each gap ("a ->
        b": the device finished a and waited for the host to launch b;
        "window start" and "window end" at the edges)."""
        by, prev, t = {}, "window start", self.window[0]
        for a, b, first, last in self.busy():
            if a > t:
                key = f"{prev} -> {kernel_id(first)}"
                by[key] = by.get(key, 0) + (a - t) / 1e9
            prev, t = kernel_id(last), b
        if self.window[1] > t:
            key = f"{prev} -> window end"
            by[key] = by.get(key, 0) + (self.window[1] - t) / 1e9
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]


@dataclasses.dataclass
class Record:
    """What a per-layer metric's reader reads: the cell, its window, its
    trace and the operations the work needs."""

    cell: Cell
    window: Window
    trace: Trace
    model_flops: float     # the reference's FLOPs a call or step
    rooflines: dict        # layer -> least seconds a call
    peaks: dict

    @property
    def calls(self) -> int:
        return len(self.window.spans)

    def spans_wall(self) -> list:
        o = self.window.wall_offset_ns
        return [(a + o, b + o) for a, b in self.window.spans]

    def host_ms_per_call(self) -> float:
        """ms a call in which the device runs nothing inside the call's
        span: the host's share of the call."""
        spans = self.spans_wall()
        busy = self.trace.busy_in(spans)
        idle = sum((b - a) / 1e9 - s for (a, b), s in zip(spans, busy))
        return idle / self.calls * 1e3

    def device_ms_per_call(self, match) -> float:
        return self.trace.device_s(match) / self.calls * 1e3

    def idle_pct(self) -> float:
        """The share of the traced window in which the device runs
        nothing."""
        lo, hi = self.trace.window
        window = (hi - lo) / 1e9
        return (window - self.trace.busy_s()) / window * 100.0

    def mfu_pct(self) -> float:
        """The reference's FLOPs over the window, a second, over the
        peak of the configuration's operand width."""
        rate = self.model_flops * self.calls / self.window.seconds
        return rate / (self.peaks["tflops"][self.cell.config["dtype"]]
                       * 1e12) * 100.0

    def roofline_pct(self, layer: str, match) -> float | None:
        """The least time of `layer`'s work over the device time of the
        kernels `match` keeps; None where they did not run."""
        device = self.trace.device_s(match)
        if device <= 0:
            return None
        return self.rooflines[layer] * self.calls / device * 100.0


def peaks() -> dict:
    return load_json(HERE / "peaks.json")


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
