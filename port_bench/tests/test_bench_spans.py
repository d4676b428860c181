"""(d) The port's spans in a traced window (port_bench/spans.py): the
device's idle time split by the spans open, and the parts adding up to
the host's share of a call; on synthetic traces and spans, and on a
small CPU run of an enhance cell under torch.profiler."""

import pytest

from port_bench import harness, spans
from port_bench.tests._tiny import tiny_cell

MS = 1_000_000  # ns


def _ms(*xs):
    return tuple(round(x * MS) for x in xs)


def _record(cell, ops, calls):
    window = harness.Window(calls, wall_offset_ns=0, failed=0)
    trace = harness.Trace(sorted(ops, key=lambda o: o[1]),
                          (calls[0][0], calls[-1][1]))
    return harness.Record(harness.cell(cell), window, trace, 0.0, {},
                          harness.peaks())


def _recorded(monkeypatch, rows):
    """`rows` (name, start ms, end ms) as the port's PROFILED spans (the
    parents are not read)."""
    from se_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "PROFILED",
                        [(n, *_ms(a, b), -1) for n, a, b in rows],
                        raising=False)


def _enhance_call(t):
    """One 10-ms call at t ms: its spans and device operations."""
    rows = [("enhance", 0.5, 9.5), ("enhance.gain", 0.5, 1.5),
            ("enhance.h2d", 1.5, 2.0), ("enhance.model", 2.0, 8.0),
            ("pack_weights", 2.2, 2.4), ("kernel.launch", 2.5, 3.0),
            ("kernel.launch", 4.0, 4.5), ("enhance.d2h", 8.0, 9.0),
            ("enhance.ungain", 9.0, 9.5)]
    ops = [("Memcpy HtoD (Pageable -> Device)", 1.8, 2.1),
           ("void lstm_step_tc<1>(float const*)", 3.0, 7.0),
           ("Memcpy DtoH (Device -> Pageable)", 8.2, 8.9)]
    return ([(n, a + t, b + t) for n, a, b in rows],
            [(n, *_ms(a + t, b + t)) for n, a, b in ops])


@pytest.fixture
def enhance(monkeypatch):
    rows, ops = [], []
    for t in (0.0, 10.0):
        r, o = _enhance_call(t)
        rows += r
        ops += o
    _recorded(monkeypatch, rows)
    return _record("fullsubnet-enhance-b32", ops,
                   [_ms(0, 10), _ms(10, 20)])


def _read(name, record):
    return harness.module("metrics", name).read(record)


def test_bench_enhance_split(enhance):
    # idle a call: 0-1.8, 2.1-3, 7-8.2, 8.9-10 ms
    assert enhance.host_ms_per_call() == pytest.approx(5.0)
    entry = _read("entry_idle_ms.enhance", enhance)
    model = _read("model_idle_ms.enhance", enhance)
    assert entry == pytest.approx(2.1) and model == pytest.approx(1.9)
    by = dict(spans.idle_by_span(enhance))
    assert by["none"] == pytest.approx(2 * 1.0e-3)
    assert entry + model + by["none"] * 1e3 / 2 == \
        pytest.approx(enhance.host_ms_per_call())
    assert by["enhance.gain"] == pytest.approx(2 * 1.0e-3)
    assert by["enhance.model"] == pytest.approx(2 * 1.2e-3)
    assert by["kernel.launch"] == pytest.approx(2 * 0.5e-3)
    assert by["pack_weights"] == pytest.approx(2 * 0.2e-3)
    assert sum(by.values()) == pytest.approx(2 * 5.0e-3)
    assert _read("launch_host_ms.enhance", enhance) == pytest.approx(1.0)
    assert _read("kernel_launches_per_call.enhance", enhance) == 2
    assert _read("packs_made_per_call.enhance", enhance) == 1


def test_bench_clock_check(enhance, monkeypatch):
    got = spans.clock(enhance, enhance.trace.ops)
    assert got == {"calls": 2, "inside_share": 1.0,
                   "within_50us_share": 1.0, "worst_outside_us": 0.0}
    rows, ops = _enhance_call(0.0)
    rows[2] = ("enhance.h2d", 1.5, 1.76)  # the copy starts 40 us after
    _recorded(monkeypatch, rows)
    one = _record("fullsubnet-enhance-b32", ops, [_ms(0, 10)])
    got = spans.clock(one, one.trace.ops)
    assert got["inside_share"] == 0.0 and got["within_50us_share"] == 1.0
    assert got["worst_outside_us"] == pytest.approx(40.0)


def test_bench_train_split(monkeypatch):
    _recorded(monkeypatch, [
        ("train.step", 1, 99), ("train.forward", 1, 30),
        ("train.prep", 1, 5), ("train.backward", 30, 80),
        ("autograd.twin", 40, 60), ("kernel.launch", 70, 70),  # no length
        ("train.optimizer", 80, 98)])
    ops = [(n, *_ms(a, b)) for n, a, b in (
        ("elementwise_kernel", 5, 25), ("Kernel2", 35, 40),
        ("elementwise_kernel", 50, 55), ("elementwise_kernel", 85, 90))]
    rec = _record("fullsubnet-train-b32", ops, [_ms(0, 100)])
    parts = {name: _read(name, rec) for name in (
        "forward_idle_ms.train", "twin_idle_ms.train",
        "backward_idle_ms.train", "optimizer_idle_ms.train")}
    assert parts == pytest.approx({
        "forward_idle_ms.train": 9.0, "twin_idle_ms.train": 15.0,
        "backward_idle_ms.train": 25.0, "optimizer_idle_ms.train": 13.0})
    by = dict(spans.idle_by_span(rec))
    assert by["none"] == pytest.approx(2e-3)
    assert by["train.step"] == pytest.approx(1e-3)
    assert sum(parts.values()) + (by["none"] + by["train.step"]) * 1e3 \
        == pytest.approx(rec.host_ms_per_call())


def test_bench_no_spans_reads_nothing(monkeypatch):
    """A port without the recorder (no PROFILED), or a window without
    the cell's outermost span: every span metric is left out."""
    from se_tpu_torch.utils import profiling

    rec = _record("fullsubnet-train-b32", [], [_ms(0, 100)])
    monkeypatch.delattr(profiling, "PROFILED")
    assert _read("twin_idle_ms.train", rec) is None
    assert spans.idle_by_span(rec) is None
    _recorded(monkeypatch, [("train.forward", 1, 30)])
    assert _read("forward_idle_ms.train", rec) is None
    _recorded(monkeypatch, [("enhance", 1, 30)])
    enh = _record("uformer-enhance-b64", [], [_ms(0, 100)])
    assert _read("packs_made_per_call.enhance", enh) == 0
    assert spans.clock(enh, []) == {"calls": 1, "inside_share": 0.0,
                                    "within_50us_share": 0.0,
                                    "worst_outside_us": 0.0}


def test_bench_cpu_run_parts_add_up():
    """The program's own spans, recorded under torch.profiler in a small
    CPU window (no device: every instant idle): the entry's and the
    network's parts and what no span holds add up to the host's share."""
    from torch.profiler import ProfilerActivity, profile

    from se_tpu_torch.utils import profiling

    cell = tiny_cell("fullsubnet-enhance-b32")
    program = cell.mode().Program(cell, 2 ** 31 + 11, "cpu")
    n = len(profiling.PROFILED)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            window = harness.run_window(program.call, 0.3)
        mine = profiling.PROFILED[n:]
        rec = harness.Record(
            cell, window, harness.Trace([], (
                window.spans[0][0] + window.wall_offset_ns,
                window.spans[-1][1] + window.wall_offset_ns)),
            0.0, {}, harness.peaks())
        calls = rec.calls
        assert sum(s[0] == "enhance" for s in mine) == calls
        entry = _read("entry_idle_ms.enhance", rec)
        model = _read("model_idle_ms.enhance", rec)
        none = dict(spans.idle_by_span(rec, n=100)).get("none", 0.0)
        host = rec.host_ms_per_call()
        assert entry + model + none * 1e3 / calls == pytest.approx(host)
        assert model > 0 and entry > 0
        assert sum(window.durations_ms()) / calls == pytest.approx(host)
        assert _read("kernel_launches_per_call.enhance", rec) == 0
    finally:
        del profiling.PROFILED[n:]
