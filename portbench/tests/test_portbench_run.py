"""A run's result line, on the CPU at small sizes; `run.py`'s refusals."""
import json
import math
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import bench
from portbench.tests import small

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", small.CELLS)
def test_untraced_line(name):
    line = small.run(name)
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    cell = small.cell(name)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        got = line["metrics"][m["name"]]
        assert got["unit"] == m["unit"]
        assert math.isfinite(got["value"]) and got["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("name", small.CELLS)
def test_traced_line(name):
    line = small.run(name, traced=True)
    assert line["correct"] is True
    cell = small.cell(name)
    names = {m["name"] for m in cell.per_layer}
    # no card: the device's metrics find nothing to read and are left out
    assert set(line["metrics"]) <= names
    assert "plan_s" in line["metrics"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(line)[-1] == "checks"


def test_same_seed_same_inputs():
    from portbench import drive

    c = small.cell("hpcg-104.cg")
    a = drive.make_pool(c.traffic, c.kind, 50, "cpu")
    b = drive.make_pool(c.traffic, c.kind, 50, "cpu")
    assert all((x == y).all() for x, y in zip(a, b))
    assert drive.order(c.traffic, 2**31 + 3) == drive.order(c.traffic,
                                                          2**31 + 3)
    assert drive.order(c.traffic, 2**31 + 3) != drive.order(c.traffic,
                                                          2**31 + 4)


@pytest.mark.parametrize("name", small.CELLS)
def test_fixed_start_set_in_a_seeded_order(name):
    from portbench import drive, spec

    s = spec.load_spec(small.ROOT)
    c = spec.resolve(s, small.ROOT, name)
    a = drive.make_pool(c.traffic, c.kind, 50, "cpu")
    b = drive.make_pool(dict(c.traffic, pool_seed=c.traffic["pool_seed"] + 1),
                        c.kind, 50, "cpu")
    assert len(a) == c.traffic["pool"]
    assert not (a[0] == b[0]).all()  # the set is the traffic file's
    orders = [drive.order(c.traffic, 2**31 + s) for s in range(6)]
    for o in orders:
        assert sorted(o) == list(range(c.traffic["pool"]))
    assert len({tuple(o) for o in orders}) > 1


def test_simplex_starts_sum_to_one():
    from portbench import drive

    c = small.cell("graph500-s16.pagerank")
    for x in drive.make_pool(dict(c.traffic, pool=16), c.kind, 100, "cpu"):
        assert float(x.sum()) == pytest.approx(1.0, rel=1e-5)
        assert float(x.min()) > 0


def test_window_counts_the_untraced_part():
    line = small.run("hpcg-104.cg", traced=True, seconds=0.5)
    assert line["correct"] is True
    assert 0 <= line["traced_part"]["completed"] <= line["attempted"]


def test_run_py_without_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, os.path.join(small.ROOT, "portbench", "run.py"),
         "--workload", "hpcg-104.cg", "--seed", "1", "--seconds", "1",
         "--trace", "0"],
        capture_output=True, text=True, cwd=small.ROOT, timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_run_py_in_a_bare_directory(tmp_path):
    shutil.copy(os.path.join(small.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(small.ROOT, "portbench"),
                    tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "hpcg-104.cg",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_banned_modules_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torchx", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    found = bench.banned_modules()
    assert "jax" in found and set(found) <= set(bench.BANNED)


@pytest.mark.gpu
def test_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "hpcg-104.spmm64",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=small.ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"


@pytest.mark.parametrize("name,numbers", [
    ("hpcg-104.cg", {"raised", "unconverged", "true_residual"}),
    ("graph500-s16.pagerank", {"raised", "unconverged", "rank_l1_error"}),
    ("hpcg-104.spmm64", {"raised", "spmm_error"}),
])
def test_numbers_compared_are_the_kinds(name, numbers):
    line = small.run(name, seconds=0.1)
    assert set(line["checks"]) == numbers


@pytest.mark.parametrize("whole", [False, True])
def test_window_ends_at_a_whole_pass_where_asked(whole):
    from portbench import drive
    from portbench.kinds import Answer

    c = small.cell("hpcg-104.cg")
    traffic = dict(c.traffic, pool=5, whole_passes=whole)
    pool = [torch.zeros(3) for _ in range(5)]
    win = drive.window(lambda x: Answer(x), c.kind, traffic, pool, 0.05,
                       2**31 + 9, "cpu")
    assert win.completed == win.attempted > 0
    if whole:
        assert win.attempted % 5 == 0
