"""BENCHMARK.json against the contract, every name resolving to its file,
and small CPU runs of each driver printing the contract's keys."""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.helpers import ROOT, small_run

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(one_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    n = len(BENCH["workloads"])
    assert 1 <= n <= 24 and 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128
    assert len(json.dumps(BENCH)) <= 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_entries_have_exactly_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_units_and_texts(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(set(names)) == len(names)
    for e in BENCH[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and kind in ("configs", "workloads", "per_layer"):
                assert one_line(e[key]), (e["name"], key)
    if kind == "workloads":
        for w in BENCH["workloads"]:
            assert NAME.match(w["config"]) and NAME.match(w["traffic"])
            assert w["chips"] in (1, 4)
        pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
        assert len(pairs) == len(BENCH["workloads"])


def test_metric_sources_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_name_resolves_to_its_file():
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/")
        d = json.load(open(os.path.join(ROOT, c["file"])))
        assert d["name"] == c["name"] and d["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        t = json.load(open(os.path.join(ROOT, "benchmark", "traffic",
                                        w["traffic"] + ".json")))
        assert os.path.exists(os.path.join(ROOT, "benchmark", "drivers",
                                           t["driver"] + ".py"))
        assert t["limits"]
    readers = set()
    for m in BENCH["per_layer"]:
        path = harness.metric_file(m["name"])
        assert os.path.exists(path), m["name"]
        readers.add(os.path.basename(path))
    # every reader is some metric's: none is left behind
    on_disk = {f for f in os.listdir(os.path.join(ROOT, "benchmark",
                                                  "metrics"))
               if f.endswith(".py") and f not in ("__init__.py",
                                                  "common.py")}
    assert on_disk == readers


def test_each_cell_reports_what_it_must():
    for w in CELLS:
        cell = harness.load_cell(ROOT, w)
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell["per_layer"], w
    for m in BENCH["per_layer"]:
        for w in m.get("workloads", CELLS):
            cell = harness.load_cell(ROOT, w)
            assert m["moves"] in {e["name"] for e in cell["end_to_end"]}


def test_four_chip_share():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def _line_keys(result: dict, trace: bool):
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    if trace:
        keys.append("breakdown")
    assert list(result) == keys + ["checks"]
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("workload", ["cascade_bf16_b1", "rcnn_train_800"])
@pytest.mark.parametrize("trace", [False, True])
def test_small_cpu_run_prints_the_contract_keys(workload, trace, capsys):
    result = small_run(workload, trace=trace)
    harness.emit(result)
    out = capsys.readouterr()
    last = json.loads(out.out.strip().splitlines()[-1])
    _line_keys(last, trace)
    cell = harness.load_cell(ROOT, workload)
    if not trace:
        assert set(last["metrics"]) == {m["name"]
                                        for m in cell["end_to_end"]}
    else:
        assert set(last["metrics"]) <= {m["name"]
                                         for m in cell["per_layer"]}
        assert "busy_s" in last["device"] and "window_s" in last["device"]
    assert out.err.strip().splitlines()[-1].startswith("check ")


def test_refuses_to_run_without_a_card():
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        CELLS[0], "--seed", str(2**31 + 3), "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_refuses_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for path in BENCH["paths"]:
        shutil.copytree(os.path.join(ROOT, path), tmp_path / path,
                        ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable] + BENCH["command"][1:] + [
        "--workload", CELLS[0], "--seed", "5", "--seconds", "1",
        "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        harness.load_cell(ROOT, "no_such_cell")
