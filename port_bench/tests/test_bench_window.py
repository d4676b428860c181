"""(d) The window's arithmetic on synthetic records: a stall moves the
rate and the tail; the trace's reduction into busy, idle and host
time."""

import pytest

from port_bench import harness, runner

MS = 1_000_000  # ns


def _window(durations_ms, gap_ms=0.0):
    spans, t = [], 0
    for d in durations_ms:
        spans.append((t, t + int(d * MS)))
        t += int((d + gap_ms) * MS)
    return harness.Window(spans, wall_offset_ns=0, failed=0)


def _e2e(name, window, items=128.0):
    reading = {"setup_s": 1.0, "window": window,
               "rate": len(window.spans) * items / window.seconds}
    return runner.END_TO_END[name][1](reading)


def test_bench_stall_moves_rate_and_tail():
    steady = _window([100.0] * 200)
    stalled = _window([100.0] * 180 + [400.0] * 20)
    assert _e2e("enhance_au_s_per_s", steady) == pytest.approx(1280.0)
    assert _e2e("enhance_au_s_per_s", stalled) < 0.9 * 1280.0
    assert _e2e("enhance_call_p95_ms", steady) == pytest.approx(100.0)
    assert _e2e("enhance_call_p95_ms", stalled) > 300.0


def test_bench_percentile_matches_numpy_linear():
    import numpy as np

    xs = [3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0, 6.0]
    for q in (0, 50, 95, 100):
        assert harness.percentile(xs, q) == pytest.approx(
            float(np.percentile(xs, q)))


def test_bench_run_window_counts_failures_and_length():
    calls = []

    def call(i):
        calls.append(i)
        return i != 3

    w = harness.run_window(call, 0.01)
    assert len(w.spans) == len(calls) >= 1
    assert w.failed == (1 if len(calls) > 3 else 0)
    assert w.seconds >= 0.01


def _record(ops, spans, flops=0.0, rooflines=None):
    cell = harness.cell("fullsubnet-enhance-b32")
    window = harness.Window(spans, wall_offset_ns=0, failed=0)
    trace = harness.Trace(sorted(ops, key=lambda o: o[1]),
                          (spans[0][0], spans[-1][1]))
    return harness.Record(cell, window, trace, flops,
                          rooflines or {"lstm": 0.0}, harness.peaks())


def test_bench_trace_reduction():
    # two calls of 10 ms; the device busy 0-4 and 5-8 ms in the first,
    # 12-20 ms in the second (two overlapping kernels)
    spans = [(0, 10 * MS), (10 * MS, 20 * MS)]
    ops = [("void lstm_step_tc<1>(float const*)", 0, 4 * MS),
           ("Memcpy DtoH (Device -> Pageable)", 5 * MS, 8 * MS),
           ("void at::native::elementwise_kernel<128>(int)", 12 * MS,
            18 * MS),
           ("void lstm_proj_tc(float*)", 16 * MS, 20 * MS)]
    rec = _record(ops, spans, flops=1e9, rooflines={"lstm": 1e-3})
    assert rec.trace.busy_s() == pytest.approx(15e-3)
    assert rec.idle_pct() == pytest.approx(25.0)
    assert rec.host_ms_per_call() == pytest.approx(2.5)
    assert rec.device_ms_per_call(harness.is_port_kernel) == pytest.approx(4.0)
    assert rec.device_ms_per_call(
        lambda n: not harness.is_port_kernel(n)) == pytest.approx(4.5)
    # 2 calls of 1 ms least time over 8 ms of lstm_* kernels
    assert rec.roofline_pct("lstm", lambda n: harness.kernel_id(
        n).startswith("lstm_")) == pytest.approx(25.0)
    assert rec.roofline_pct("lstm", lambda n: False) is None
    assert rec.mfu_pct() == pytest.approx(2e9 / 0.02 / 495e12 * 100)
    gaps = dict(rec.trace.idle_gaps())
    assert gaps["lstm_step_tc -> Memcpy DtoH"] == \
        pytest.approx(1e-3)
    assert gaps["Memcpy DtoH -> elementwise_kernel"] == \
        pytest.approx(4e-3)
    assert rec.trace.top_ops()[0] == ["elementwise_kernel",
                                      pytest.approx(6e-3)]


def test_bench_kernel_id():
    assert harness.kernel_id("void (anonymous namespace)::tcp::dsconv_pre_tc"
                             "<64, 2>(float const*, int)") == "dsconv_pre_tc"
    assert harness.kernel_id("encoder_level_cc") == "encoder_level_cc"
    assert harness.is_port_kernel("void att_flash_tc<2>(float*)")
    assert not harness.is_port_kernel("ampere_sgemm_128x64_nn")
