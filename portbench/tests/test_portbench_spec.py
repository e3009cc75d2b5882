"""BENCHMARK.json against its required shape, and every cell resolved
from its files by name."""
import json
import os
import re

import pytest

from portbench import spec
from portbench.tests.small import CELLS, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench_spec():
    return spec.load_spec(ROOT)


def test_top_level_keys(bench_spec):
    assert set(bench_spec) == {"command", "paths", "run_seconds", "configs",
                               "workloads", "end_to_end", "per_layer"}
    assert bench_spec["command"] == ["python3", "portbench/run.py"]
    assert bench_spec["paths"] == ["portbench"]
    assert 1 <= bench_spec["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_names_units_and_keys(bench_spec):
    metrics = bench_spec["end_to_end"] + bench_spec["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    e2e = {m["name"] for m in bench_spec["end_to_end"]}
    cells = {w["name"] for w in bench_spec["workloads"]}
    assert "setup_s" in e2e
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in bench_spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for m in bench_spec["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != m["name"]
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        moved = next(e for e in bench_spec["end_to_end"]
                     if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolved_from_files(bench_spec, name):
    c = spec.resolve(bench_spec, ROOT, name)
    assert c.entry["chips"] == 1 and len(c.entry["why"]) <= 200
    assert c.config["name"] == c.entry["config"]
    assert os.path.exists(os.path.join(
        ROOT, "portbench", "generators", c.config["generator"] + ".py"))
    assert c.kind is spec.kind(c.traffic["kind"])
    for name in ("pool", "warm", "call", "call_low", "check", "columns"):
        assert callable(getattr(c.kind, name))
    assert isinstance(c.kind.SOLVES, bool)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]))


def test_configs(bench_spec):
    for c in bench_spec["configs"]:
        data = json.load(open(os.path.join(ROOT, c["file"])))
        assert c["file"].startswith("portbench/")
        assert data["reduced"] == c["reduced"]
        assert all(k in data for k in c["reduced"])
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    used = {w["config"] for w in bench_spec["workloads"]}
    assert used == {c["name"] for c in bench_spec["configs"]}


def test_unknown_cell_raises(bench_spec):
    with pytest.raises(KeyError):
        spec.resolve(bench_spec, ROOT, "no-such.cell")


@pytest.mark.parametrize("name", ["jacobi", "solve", "../spec", ""])
def test_unknown_kind_raises(name):
    with pytest.raises(KeyError, match="no traffic kind"):
        spec.kind(name)


def test_every_traffic_file_names_a_kind():
    here = os.path.join(ROOT, "portbench", "traffic")
    for f in sorted(os.listdir(here)):
        t = json.load(open(os.path.join(here, f)))
        kind = spec.kind(t["kind"])
        assert {"pool", "pool_seed", "sample", "trace_seconds"} <= set(t)
        assert kind.columns(t) >= 1
