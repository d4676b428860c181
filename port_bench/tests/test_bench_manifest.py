"""(e) BENCHMARK.json and every file it names load, name only known
metrics, and keep to the benchmark's contract."""

import re

import pytest

from port_bench import harness, runner

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_bench_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells (2 + 14 runs a cell, each run_seconds + 60
    # s, 180 s a cell to compile, 1,200 s spare) fits in 43,200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


def test_bench_names_units_and_bounds():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["name"] in runner.END_TO_END
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_bench_cell_files_load(cell):
    c = harness.cell(cell)
    assert c.config["name"] in {w["config"] for w in BENCH["workloads"]}
    assert c.traffic["mode"] in ("enhance", "train")
    assert (harness.HERE / "reference" / f"{c.family}.py").exists()
    assert (harness.HERE / "flops" / f"{c.family}.py").exists()
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer metric
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_bench_per_layer_metric_has_reader(metric):
    mod = harness.module("metrics", metric["name"])
    assert callable(mod.read)
    # the end-to-end metric it moves is reported in each of its cells
    for cell in metric.get("workloads", CELLS):
        moves = {m["name"] for m in harness.cell(cell).end_to_end}
        assert metric["moves"] in moves


def test_bench_metric_files_are_named():
    files = {p.name[:-3] for p in (harness.HERE / "metrics").glob("*.py")}
    assert files == {m["name"] for m in BENCH["per_layer"]}


def test_bench_configs():
    for c in BENCH["configs"]:
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert c["file"].startswith("port_bench/configs/")
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"] and cfg["chips"] == 1
        assert cfg["dtype"] == "float32" and cfg["tf32"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_bench_limits_name_the_mode_numbers(cell):
    c = harness.cell(cell)
    want = {"enhance": {"worst_call_rel_err"},
            "train": {"loss1_gap", "grad_gap", "change_gap"}}
    numbers = {k for k in c.limits if not k.startswith("_")}
    assert numbers == want[c.traffic["mode"]]
    assert all(c.limits[k] > 0 for k in numbers)
