"""The port's span recorder (`repro_torch.core.spans`) and the spans the
planner, the solvers, the engine and the kernel build open, on the CPU."""
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import solvers, spans
from repro_torch.core.capture import HostReads
from repro_torch.core.engine import clear_engine_cache, \
    clear_schedule_cache, get_engine
from repro_torch.core.formats import csr_to_sell
from repro_torch.core.matrices import powerlaw, spd

N = 96


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    clear_engine_cache()
    clear_schedule_cache()
    spans.enable(True)
    yield
    spans.enable(True)


def _since(mark):
    """The process's records opened after `mark` (a span id)."""
    return [r for r in spans.records() if r.id > mark]


def _mark():
    return max((r.id for r in spans.records()), default=0)


def _names(recs, name, **attrs):
    return [r for r in recs if r.name == name
            and all((r.attrs or {}).get(k) == v for k, v in attrs.items())]


# --------------------------------------------------------------------------
# The recorder


def test_nesting_parents_requests_and_self_time():
    rec = spans.Recorder(capacity=64)
    with rec.span("outer", tag=1):
        with rec.span("repro.solve"):
            with rec.span("inner"):
                pass
            with rec.span("inner"):
                pass
        with rec.span("other"):
            pass
    recs = rec.records()
    assert [r.name for r in recs] == ["inner", "inner", "repro.solve",
                                      "other", "outer"]
    outer, solve = recs[4], recs[2]
    assert outer.parent == 0 and outer.request == 0
    assert outer.attrs == {"tag": 1} and solve.attrs is None
    assert solve.parent == outer.id and solve.request == solve.id
    for r in recs[:2]:
        assert r.parent == solve.id and r.request == solve.id
    assert recs[3].parent == outer.id and recs[3].request == 0
    for r in recs:
        assert r.end_ns >= r.start_ns and not r.profiled
    children = sum(r.end_ns - r.start_ns for r in recs[:2])
    assert spans.self_ns(recs, "repro.solve") == \
        solve.end_ns - solve.start_ns - children
    assert spans.self_ns(recs, "inner") == children
    assert spans.self_ns(recs, "missing") == 0


def test_a_span_that_raises_is_closed():
    rec = spans.Recorder(capacity=8)
    with pytest.raises(ValueError):
        with rec.span("outer"):
            with rec.span("fails"):
                raise ValueError("boom")
    with rec.span("after"):
        pass
    recs = rec.records()
    assert [r.name for r in recs] == ["fails", "outer", "after"]
    assert recs[0].parent == recs[1].id
    assert recs[2].parent == 0  # the stack was unwound


def test_two_threads_keep_their_own_stacks():
    rec = spans.Recorder(capacity=64)
    opened, release = threading.Event(), threading.Event()

    def a():
        with rec.span("a.outer"):
            opened.set()
            assert release.wait(10)
            with rec.span("a.inner"):
                pass

    def b():
        assert opened.wait(10)
        with rec.span("b.outer"):
            with rec.span("b.inner"):
                pass
        release.set()

    threads = [threading.Thread(target=a), threading.Thread(target=b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    by = {r.name: r for r in rec.records()}
    assert set(by) == {"a.outer", "a.inner", "b.outer", "b.inner"}
    assert by["b.outer"].parent == 0
    assert by["b.inner"].parent == by["b.outer"].id
    assert by["a.inner"].parent == by["a.outer"].id


def test_ring_is_bounded_and_counts_what_it_dropped():
    assert spans.Recorder().capacity == spans.CAPACITY >= 2**18
    rec = spans.Recorder(capacity=8)
    assert rec.records() == [] and rec.dropped() == 0
    for i in range(20):
        with rec.span(f"s{i}"):
            pass
    recs = rec.records()
    assert [r.name for r in recs] == [f"s{i}" for i in range(12, 20)]
    assert rec.dropped() == 12


def test_disabled_records_nothing():
    rec = spans.Recorder(capacity=8)
    rec.enabled = False
    with rec.span("a") as s:
        assert s is None
    assert rec.records() == []
    mark = _mark()
    spans.enable(False)
    with spans.span("repro.test.off"):
        pass
    A = spd(N, 4, 0.6)(seed=1)
    solvers.cg(get_engine(A, device="cpu"), np.ones(N, np.float32))
    assert _since(mark) == []
    assert spans.span("x") is spans.span("y")  # one shared null context


def test_profiler_events_and_records_share_a_clock():
    rec = spans.Recorder(capacity=64)
    names = [f"repro.test.clock{i}" for i in range(5)]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for name in names:
            with rec.span(name):
                torch.ones(64).sum()
    with rec.span("repro.test.after"):
        pass
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name() in names}
    assert set(events) == set(names)
    recs = {r.name: r for r in rec.records()}
    assert not recs["repro.test.after"].profiled
    for name in names:
        r, e = recs[name], events[name]
        assert r.profiled
        assert abs(rec.profiler_clock_ns(r.start_ns) - e.start_ns()) < 1e6
        assert abs(rec.profiler_clock_ns(r.end_ns) - e.end_ns()) < 1e6


# --------------------------------------------------------------------------
# The port's spans


def test_recording_adds_no_host_read():
    A = spd(N, 4, 0.6)(seed=2)
    b = np.random.default_rng(2).standard_normal(N).astype(np.float32)
    ops = []
    for on in (True, False):
        clear_engine_cache()
        clear_schedule_cache()
        spans.enable(on)
        with HostReads() as reads:
            res = solvers.cg(get_engine(A, device="cpu"), b, tol=1e-6)
        assert res.converged
        ops.append(reads.ops)
    assert ops[0] == ops[1] and ops[0]


@pytest.mark.parametrize("name", ["cg", "jacobi", "pagerank",
                                  "power_iteration"])
def test_one_solve_span_a_solve_and_one_probe_a_block(name):
    A = powerlaw(N, 6)(seed=3) if name == "pagerank" \
        else spd(N, 4, 0.6)(seed=3)
    if name == "pagerank":
        A = solvers.transition_matrix(A)
    eng = get_engine(A, device="cpu")
    args = ((np.ones(N, np.float32),) if name in ("cg", "jacobi") else ())
    getattr(solvers, name)(eng, *args)  # plans the engine
    mark = _mark()
    res = getattr(solvers, name)(eng, *args)
    recs = _since(mark)
    (solve,) = _names(recs, "repro.solve")
    assert solve.attrs == {"solver": name} and solve.parent == 0
    probes = _names(recs, "repro.solve.probe")
    launches = _names(recs, "repro.solve.launch")
    assert len(probes) == len(launches) + 1
    assert len(recs) == 1 + len(probes) + len(launches)  # nothing per step
    assert len(launches) < res.iterations
    for r in probes + launches:
        assert r.parent == solve.id and r.request == solve.id
    steps = sum(r.attrs["steps"] for r in launches)
    assert steps == res.matvecs - (1 if name == "cg" else 0)
    assert not _names(recs, "repro.plan.schedule")  # a warm call plans nothing


def test_python_loop_records_one_solve_and_no_block():
    A = spd(N, 4, 0.6)(seed=4)
    eng = get_engine(A, device="cpu")
    solvers.cg(eng, np.ones(N, np.float32), loop="python")
    mark = _mark()
    solvers.cg(eng, np.ones(N, np.float32), loop="python")
    assert [r.name for r in _since(mark)] == ["repro.solve"]


def test_get_engine_on_sell_plans_and_digests_once():
    sell = csr_to_sell(spd(N, 4, 0.6)(seed=5))
    mark = _mark()
    for _ in range(2):
        get_engine(sell, device="cpu").device_matvec()
    recs = _since(mark)
    assert len(_names(recs, "repro.plan.schedule",
                      stage="block_schedule")) == 1
    assert len(_names(recs, "repro.plan.digest", of="sell")) == 1
    assert len(_names(recs, "repro.plan.digest", of="stream")) == 1
    assert len(_names(recs, "repro.plan.layout", stage="pad")) == 1
    assert not _names(recs, "repro.plan.layout", stage="csr_to_sell")


def test_get_engine_on_csr_converts_and_digests_every_time():
    A = spd(N, 4, 0.6)(seed=6)
    mark = _mark()
    for _ in range(2):
        get_engine(A, device="cpu").device_matvec()
    recs = _since(mark)
    assert len(_names(recs, "repro.plan.layout", stage="csr_to_sell")) == 2
    assert len(_names(recs, "repro.plan.digest", of="sell")) == 2
    assert len(_names(recs, "repro.plan.schedule",
                      stage="block_schedule")) == 1
    sched = _names(recs, "repro.plan.schedule", stage="block_schedule")[0]
    (digest,) = _names(recs, "repro.plan.digest", of="stream")
    assert digest.parent == sched.id  # the stream's digest inside the build


def test_planning_stages_of_a_cuda_engine_on_the_cpu():
    adj = powerlaw(N, 6)(seed=7)
    with spans.span("repro.test.before"):  # ends any earlier planning
        pass
    mark = _mark()
    A = solvers.transition_matrix(adj)
    eng = get_engine(A, device="cpu", backend="cuda")
    eng.device_matvec()
    eng.plan_values(torch.float32)
    recs = _since(mark)
    stages = {(r.name, tuple(sorted((r.attrs or {}).items())))
              for r in recs}
    assert ("repro.plan.layout", (("stage", "transition"),)) in stages
    # the device plan's span carries how far the walk was cut
    plan = eng.device_plan
    (lowered,) = _names(recs, "repro.plan.schedule", stage="device_plan")
    assert lowered.attrs == {
        "stage": "device_plan", "n_windows": plan.n_windows,
        "split_slices": plan.split_slices, "item_share": plan.item_share}
    assert ("repro.plan.schedule", (("stage", "values"),)) in stages
    assert all(r.name.startswith("repro.plan.") for r in recs)
    planning = spans.last_planning(spans.records())
    assert {r.id for r in planning} == {r.id for r in recs}


def test_matmat_opens_a_request_around_its_launch():
    A = spd(N, 4, 0.6)(seed=8)
    eng = get_engine(A, device="cpu", backend="cuda")
    X = torch.randn(N, 3)
    eng.matmat(X)
    mark = _mark()
    eng.matmat(X)
    recs = _since(mark)
    assert [r.name for r in recs] == ["repro.matmat.launch", "repro.matmat"]
    launch, mm = recs
    assert mm.parent == 0 and mm.request == mm.id
    assert launch.parent == mm.id and launch.request == mm.id


def test_kernel_build_span_only_when_nvcc_runs(tmp_path, monkeypatch):
    from repro_torch.kernels import _build

    out = tmp_path / "lib"

    def fake_compile(out_dir, lib_path):
        out_dir.mkdir(parents=True)
        lib_path.write_bytes(b"")

    monkeypatch.setattr(_build, "library_dir", lambda: out)
    monkeypatch.setattr(_build, "_compile", fake_compile)
    mark = _mark()
    assert _build.build() == out / _build.LIB_NAME
    assert _build.build() == out / _build.LIB_NAME
    assert [r.name for r in _since(mark)] == ["repro.kernel.build"]
