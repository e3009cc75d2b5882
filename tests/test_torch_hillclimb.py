"""The port's hill-climb (`repro_torch.tools.hillclimb`) against
``tools/hillclimb.py``, read with `ast` (importing it sets ``XLA_FLAGS``):
the same run table, the same ``show`` line for the same result, the same
`run_cell` calls under the same flags, baselines read from the port's
artifacts; and one of its runs on a reduced cell on a fake 2x4 world."""
import ast
import dataclasses
import pathlib

import pytest

from repro_torch.configs import ARCHS, SHAPES_BY_NAME, get_arch
from repro_torch.configs.base import ShapeCell
from repro_torch.core.engine import clear_engine_cache, clear_schedule_cache
from repro_torch.launch import dryrun as dr
from repro_torch.models import Runtime
from repro_torch.tools import hillclimb as hc

REPO = pathlib.Path(__file__).resolve().parents[1]
TOOL = REPO / "tools" / "hillclimb.py"


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    clear_engine_cache()
    clear_schedule_cache()
    yield


def _tool_namespace():
    """``tools/hillclimb.py``'s ``_EP``, ``PHASES``, ``_mem_gib`` and
    ``show``, executed from its source alone."""
    tree = ast.parse(TOOL.read_text())
    keep = [n for n in tree.body
            if (isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) in ("_EP", "PHASES"))
            or (isinstance(n, ast.FunctionDef)
                and n.name in ("_mem_gib", "show"))]
    assert len(keep) == 4
    ns = {}
    exec(compile(ast.Module(keep, type_ignores=[]), str(TOOL), "exec"), ns)
    return ns


def test_the_run_table_is_the_tools():
    want = _tool_namespace()["PHASES"]
    assert hc.PHASES == want
    assert sum(len(v) for v in hc.PHASES.values()) == 18
    for runs in hc.PHASES.values():
        for arch, shape, _, rtkw, flags in runs:
            assert arch in ARCHS and shape in SHAPES_BY_NAME
            Runtime(**rtkw)  # every field is the port's
            assert set(flags) <= {"zero1", "fsdp", "expert_2d"}


def _result(ok=True, tag="hc1_sp"):
    return dr.CellResult(
        arch="smollm-360m", shape="train_4k", mesh="16x16", ok=ok,
        error=None if ok else "ValueError: " + "x" * 600, seconds=41.6,
        memory={"argument_size_in_bytes": 2.3e8,
                "output_size_in_bytes": 2.3e8, "temp_size_in_bytes": 2.6e11},
        cost={"flops": 1.58e14, "bytes accessed": 9e14},
        collectives={"all-reduce": 3e10, "all-gather": 1.5e10,
                     "total_bytes": 4.5e10, "op_count": 1234},
        runtime={"tag": tag})


@pytest.mark.parametrize("ok", [True, False])
@pytest.mark.parametrize("colls", [False, True])
def test_show_prints_the_tools_line(capsys, ok, colls):
    base = dataclasses.asdict(_result(tag="baseline"))
    base["collectives"]["total_bytes"] = 9e10
    base["memory"]["temp_size_in_bytes"] = 5e11
    res = _result(ok)
    tool_show = _tool_namespace()["show"]
    for b in (None, base):
        assert hc.show(res, b, colls=colls) is res
        got = capsys.readouterr().out
        tool_show(res, b, colls=colls)
        assert got == capsys.readouterr().out
        assert got.startswith("  hc1_sp")


def test_main_calls_run_cell_as_the_tool_does(monkeypatch, tmp_path,
                                              capsys):
    """``--phase 2 --only deepseek --unrolled-final``: each of the table's
    deepseek runs of phase 2 through `run_cell` with ``Runtime(scan_layers=
    False, **kwargs)``, the tag ``_unrolled``, the run's flags and
    ``--device``; each line against the baseline in the port's
    artifacts."""
    calls = []

    def fake_run_cell(cfg, cell, **kw):
        calls.append((cfg.name, cell.name, kw))
        return dataclasses.replace(_result(), arch=cfg.name,
                                   runtime={"tag": kw["tag"]})

    base = dataclasses.asdict(_result(tag="baseline"))
    monkeypatch.setattr(dr, "ARTIFACTS", tmp_path)
    (tmp_path / "deepseek-v2-lite-16b__train_4k__16x16__baseline.json"
     ).write_text(__import__("json").dumps(base))
    monkeypatch.setattr(dr, "run_cell", fake_run_cell)
    hc.main(["--phase", "2", "--only", "deepseek", "--unrolled-final",
             "--device", "cpu"])
    want = [r for r in hc.PHASES[2] if "deepseek" in r[0]]
    assert len(calls) == len(want) == 2
    for (arch, shape, kw), (w_arch, w_shape, tag, rtkw, flags) in zip(
            calls, want):
        assert (arch, shape) == (w_arch, w_shape)
        assert kw.pop("rt") == Runtime(scan_layers=False, **rtkw)
        assert kw.pop("tag") == tag + "_unrolled"
        assert str(kw.pop("device")) == "cpu"
        assert kw == flags
    out = capsys.readouterr().out
    assert "deepseek-v2-lite-16b train_4k -> hc5_ep" in out
    assert "[coll x1.000 mem x1.000 flops x1.000]" in out
    assert "colls:" in out  # phases past 1 print the kinds


def test_a_run_on_a_reduced_cell_records_its_levers():
    """smollm's ``hc3_sp_zero1`` (sequence-sharded attention, full remat,
    ZeRO-1), its `Runtime` and flags on a reduced cell on a fake 2x2 world:
    ``ok`` (the fold has a per-layer form), its JSON's ``runtime`` with
    both levers."""
    arch, shape, tag, rtkw, flags = next(
        r for r in hc.PHASES[1] if r[2] == "hc3_sp_zero1")
    res = dr.run_cell(get_arch(arch).reduced(),
                      ShapeCell("train_mini", 32, 4, "train"),
                      rt=Runtime(**rtkw), tag=tag, device="cpu",
                      mesh_shape=(2, 2), save=False, **flags)
    assert res.ok, res.error
    assert res.runtime["tag"] == "hc3_sp_zero1"
    assert res.runtime["seq_shard_attention"] is True
    assert res.runtime["moe_ep_constraint"] is False
    assert res.runtime["zero1"] is True and res.runtime["remat"] == "full"
