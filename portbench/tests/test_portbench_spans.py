"""The per-layer metrics that read the port's spans (`repro_torch.core.spans`):
in which cells they appear, and their arithmetic on hand-built records."""
import sys
import time
import types

import pytest

from portbench import bench, spec
from portbench.tests import small

SPANS = ("solve_host_share", "matmat_launch_us", "plan_stage_s.layout",
         "plan_stage_s.digest", "plan_stage_s.schedule")
STAGES = ("plan_stage_s.layout", "plan_stage_s.digest",
          "plan_stage_s.schedule")


def _entries():
    return {m["name"]: m for m in spec.load_spec(small.ROOT)["per_layer"]
            if m["name"] in SPANS}


@pytest.mark.parametrize("name", small.CELLS)
def test_each_metric_in_the_cells_its_entry_lists(name):
    from repro_torch.core import spans

    c = small.cell(name)
    c.traffic["trace_seconds"] = 0.15  # shorter than the window: a tail
    # a run's planning is the plan spans after the process's last call; end
    # whatever planning an earlier test of this process left without one
    with spans.span("repro.test.before"):
        pass
    line = bench.run(c, seed=2**31 + 23, seconds=0.6, traced=True,
                     device="cpu", t_start=time.perf_counter())
    assert line["correct"] is True
    entries = _entries()
    assert set(entries) == set(SPANS)
    for metric, m in entries.items():
        assert (metric in line["metrics"]) == (name in m["workloads"]), metric
    got = line["metrics"]
    assert sum(got[s]["value"] for s in STAGES) <= got["plan_s"]["value"]
    for s in STAGES:
        assert got[s]["unit"] == "s" and got[s]["value"] >= 0
    assert got["plan_stage_s.schedule"]["value"] > 0
    if c.kind.SOLVES:
        assert 0 < got["solve_host_share"]["value"] <= 100
    else:
        assert got["matmat_launch_us"]["value"] > 0


def test_untraced_line_has_none_of_them():
    line = small.run("hpcg-104.spmm64", seconds=0.2)
    assert not set(line["metrics"]) & set(SPANS)


# --------------------------------------------------------------------------
# The readers on hand-built records


def _span(name, start, end, sid, parent=0, request=0, profiled=False):
    from repro_torch.core.spans import Span

    return Span(name, start, end, sid, parent, request, profiled, None)


@pytest.fixture
def fake(monkeypatch):
    """Hand the readers `recs` (and a count dropped) in place of the
    process's ring."""
    from repro_torch.core import spans

    def use(recs, dropped=0):
        monkeypatch.setattr(spans, "records", lambda: list(recs))
        monkeypatch.setattr(spans, "dropped", lambda: dropped)
    return use


def _rec(solves=True, traced=True):
    return types.SimpleNamespace(
        trace=object() if traced else None,
        window=types.SimpleNamespace(solves=solves))


def _read(metric, rec):
    return spec.reader(metric)(rec)


#: A planning: a layout, then a schedule with a digest inside it (ns).
PLAN = [
    _span("repro.plan.layout", 0, 100, 1),
    _span("repro.plan.digest", 110, 150, 3, parent=2),
    _span("repro.plan.schedule", 100, 300, 2),
]


def _solve(sid, t0, probes, profiled):
    """A solve from t0 to t0 + 1000 with probes of the given lengths."""
    out, t = [], t0
    for i, p in enumerate(probes):
        out.append(_span("repro.solve.probe", t, t + p, sid + 1 + i, sid,
                         sid, profiled))
        t += p + 10
    out.append(_span("repro.solve", t0, t0 + 1000, sid, 0, sid, profiled))
    return out


def test_solve_host_share_reads_the_untraced_tail(fake):
    recs = PLAN + _solve(10, 400, [900], True) + _solve(20, 1500, [500], True)
    tail = _solve(30, 2600, [300, 100], False) + \
        _solve(40, 3700, [200], False)
    fake(recs + tail)
    # tail: 2000 ns of solves, 600 ns of probes
    assert _read("solve_host_share", _rec()) == pytest.approx(70.0)
    assert _read("solve_host_share", _rec(traced=False)) is None
    assert _read("solve_host_share", _rec(solves=False)) is None
    fake(recs)  # the window ended under the profiler: no tail
    assert _read("solve_host_share", _rec()) is None
    fake(tail)  # no record made under the profiler left in the ring
    assert _read("solve_host_share", _rec()) is None


def test_matmat_launch_us_is_the_mean_launch_of_the_tail(fake):
    def mm(sid, t0, launch, profiled):
        return [_span("repro.matmat.launch", t0, t0 + launch, sid + 1, sid,
                      sid, profiled),
                _span("repro.matmat", t0, t0 + 5000, sid, 0, sid, profiled)]

    recs = PLAN + mm(10, 400, 9000, True) + mm(20, 6000, 2000, False) + \
        mm(30, 12000, 4000, False)
    fake(recs)
    assert _read("matmat_launch_us", _rec(solves=False)) == pytest.approx(3.0)
    assert _read("matmat_launch_us", _rec(solves=True)) is None
    fake(recs[:5])
    assert _read("matmat_launch_us", _rec(solves=False)) is None


def test_plan_stages_are_self_times_of_the_last_planning(fake):
    before = _solve(90, -5000, [100], False)  # an earlier run's call
    old_plan = [_span("repro.plan.layout", -9000, -6000, 80)]
    calls = _solve(10, 400, [900], True) + _solve(20, 1500, [500], False)
    fake(old_plan + before + PLAN + calls)
    rec = _rec()
    assert _read("plan_stage_s.layout", rec) == pytest.approx(100e-9)
    assert _read("plan_stage_s.digest", rec) == pytest.approx(40e-9)
    assert _read("plan_stage_s.schedule", rec) == pytest.approx(160e-9)
    assert _read("plan_stage_s.layout", _rec(traced=False)) is None
    fake(before + calls)  # no planning in the ring
    assert _read("plan_stage_s.schedule", rec) is None
    fake(PLAN + calls, dropped=5)  # the planning may run past the ring
    assert _read("plan_stage_s.layout", rec) is None
    fake(before + PLAN + calls, dropped=5)  # it is whole
    assert _read("plan_stage_s.layout", rec) == pytest.approx(100e-9)


@pytest.mark.parametrize("metric", SPANS)
def test_a_port_without_spans_reads_none(metric, monkeypatch):
    import repro_torch.core

    monkeypatch.delattr(repro_torch.core, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.core.spans", None)
    assert _read(metric, _rec(solves=metric != "matmat_launch_us")) is None
