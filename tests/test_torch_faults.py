"""The port's fault injection (`repro_torch.core.faults`, a copy of
`repro.core.faults`): the same parse results and firing sequences as the
JAX package for the same spec and seed, and each fault site against the
port's store and streaming executor, healed bit for bit on the reference
backend."""
import os

import numpy as np
import pytest
import torch

from repro.core import faults as jfaults
from repro_torch.core import faults, solvers
from repro_torch.core.engine import clear_engine_cache, \
    clear_schedule_cache, get_engine, schedule_cache_stats
from repro_torch.core.faults import FaultPlan, InjectedCorruption, \
    InjectedIOError, InjectedShardFailure, InjectedTimeout, parse_fault_spec
from repro_torch.core.gather_engine import clear_gather_engine_cache
from repro_torch.core.matrices import banded, spd
from repro_torch.core.runtime import StreamingExecutor

RNG = np.random.default_rng(11)


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    clear_engine_cache()
    clear_schedule_cache()
    clear_gather_engine_cache()
    yield


def _csr(n=192, half_bw=6, seed=0):
    return banded(n, half_bw, 0.8)(seed=seed)


SPECS = [
    "store_read",
    "store_read:rate=0.3,seed=7;dispatch_timeout:after=5",
    "store_write:count=2;shard_fail:after=1,count=1",
    "dispatch_timeout:rate=0.5,count=4,seed=3",
    " store_read : rate = 1 , count = 2 ; ",
]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_and_firing_sequence_equal_repro(spec):
    assert faults.FAULT_SITES == jfaults.FAULT_SITES
    for seed in (0, 9):
        ours = parse_fault_spec(spec, default_seed=seed)
        theirs = jfaults.parse_fault_spec(spec, default_seed=seed)
        assert {s: vars(r) for s, r in ours.items()} == {
            s: vars(r) for s, r in theirs.items()}
        plan, jplan = FaultPlan(spec, seed=seed), jfaults.FaultPlan(
            spec, seed=seed)
        for site in faults.FAULT_SITES:
            seq = [plan.fire(site) for _ in range(40)]
            assert seq == [jplan.fire(site) for _ in range(40)], site
        assert plan.report() == jplan.report()


@pytest.mark.parametrize("bad", [
    "", "nosuch:rate=1", "store_read:rate=2", "store_read:rate=x",
    "store_read:after=x", "store_read:bogus=1", "store_read:rate",
    "store_read;store_read",
])
def test_malformed_specs_rejected_like_repro(bad):
    with pytest.raises(ValueError) as ours:
        parse_fault_spec(bad)
    with pytest.raises(ValueError) as theirs:
        jfaults.parse_fault_spec(bad)
    assert str(ours.value) == str(theirs.value)


def test_maybe_inject_typed_exceptions_and_scoping(tmp_path, monkeypatch):
    kinds = {"store_read": InjectedCorruption, "store_write": InjectedIOError,
             "dispatch_timeout": InjectedTimeout,
             "shard_fail": InjectedShardFailure}
    faults.maybe_inject("store_write")  # no plan: a no-op
    for site, exc in kinds.items():
        with FaultPlan(f"{site}:count=1") as plan:
            with pytest.raises(exc) as info:
                faults.maybe_inject(site)
            assert info.value.site == site
            faults.maybe_inject(site)  # count exhausted
            faults.note_recovered(site, 5)  # clamped to injected
        assert plan.report()["recovered"] == 1
    path = tmp_path / "f.npz"
    path.write_bytes(b"PK" + b"x" * 100)
    with FaultPlan("store_read:count=1"):
        with faults.suspended():
            assert not faults.corrupt_file(str(path))
        assert faults.corrupt_file(str(path))
        assert not faults.corrupt_file(str(path))
    assert path.read_bytes().startswith(b"\x00CHAOS")
    monkeypatch.setenv(faults.ENV_VAR, "shard_fail:count=1")
    with pytest.raises(InjectedShardFailure):
        faults.maybe_inject("shard_fail")
    with FaultPlan("store_read:count=1"):  # a scoped plan shadows the env
        faults.maybe_inject("shard_fail")


def test_store_read_corruption_quarantines_and_rebuilds(tmp_path):
    csr = _csr()
    d = str(tmp_path)
    X = RNG.standard_normal((csr.n_cols, 4)).astype(np.float32)
    eng = get_engine(csr, backend="reference", cache_dir=d, device="cpu")
    y_free = eng.matmat(X)
    files = [n for n in os.listdir(d) if n.endswith(".npz")]
    assert len(files) == 1

    clear_engine_cache()
    clear_schedule_cache()
    with FaultPlan("store_read:rate=1,count=1") as plan:
        eng2 = get_engine(csr, backend="reference", cache_dir=d,
                          device="cpu")
        y_chaos = eng2.matmat(X)
        health = eng2.plan_report()["cache_health"]
    assert torch.equal(y_chaos, y_free)  # bit-identical recovery
    assert health["quarantined"] == 1 and health["rebuilds"] == 1
    stats = schedule_cache_stats()
    assert stats["disk_rejects"] == 1 and stats["disk_saves"] == 1
    assert any(n.endswith(".bad") for n in os.listdir(d))
    assert [n for n in os.listdir(d) if n.endswith(".npz")] == files
    rep = plan.report()
    assert rep["injected"] == 1 and rep["unrecovered"] == 0

    clear_engine_cache()
    clear_schedule_cache()
    eng3 = get_engine(csr, backend="reference", cache_dir=d, device="cpu")
    assert torch.equal(eng3.matmat(X), y_free)
    assert schedule_cache_stats()["disk_hits"] == 1


def test_store_write_errors_retry_then_degrade_to_memory(tmp_path):
    csr = _csr()
    with FaultPlan("store_write:rate=1,count=2") as plan:
        get_engine(csr, backend="reference", cache_dir=str(tmp_path / "a"),
                   device="cpu").plan_report()
    assert os.listdir(tmp_path / "a") and not [
        n for n in os.listdir(tmp_path / "a") if n.endswith(".tmp")]
    stats = schedule_cache_stats()
    assert stats["retries"] == 2 and stats["save_errors"] == 0
    assert plan.report()["unrecovered"] == 0

    clear_engine_cache()
    clear_schedule_cache()
    d = tmp_path / "b"
    X = RNG.standard_normal((csr.n_cols, 3)).astype(np.float32)
    with FaultPlan("store_write:rate=1"):  # every attempt fails
        y = get_engine(csr, backend="reference", cache_dir=str(d),
                       device="cpu").matmat(X)
    assert tuple(y.shape) == (csr.n_rows, 3)
    stats = schedule_cache_stats()
    assert stats["save_errors"] >= 1 and stats["disk_saves"] == 0
    assert all(not n.endswith((".npz", ".tmp")) for n in os.listdir(d))


@pytest.mark.parametrize("retries", [2, 0])
def test_dispatch_timeout_at_retirement(retries):
    csr = _csr()
    eng = get_engine(csr, backend="reference", device="cpu")
    X = RNG.standard_normal((csr.n_cols, 8)).astype(np.float32)
    y_free = eng.matmat(X)
    streamer = StreamingExecutor(eng, microbatch=4, depth=2, retries=retries)
    with FaultPlan("dispatch_timeout:after=1,count=1") as plan:
        h = streamer.submit(X)
        outs = streamer.drain()
    rep = plan.report()
    assert rep["injected"] == 1
    if retries:
        assert outs.ok and torch.equal(h.result(), y_free)
        assert streamer.stats["retries"] >= 1
        assert rep["unrecovered"] == 0
    else:
        assert len(outs.failures) == 1
        assert isinstance(outs.failures[0].error, InjectedTimeout)
        assert rep["unrecovered"] == 1  # nothing healed it


def test_chaos_run_bit_identical_to_fault_free(tmp_path):
    """Every store and dispatch fault healed: matvec, streamed matmat and a
    solve equal the fault-free run bit for bit on the reference backend."""
    csr = spd(192, 6, 0.6)(seed=3)
    X = RNG.standard_normal((csr.n_cols, 6)).astype(np.float32)
    b = X[:, 0]

    def run(d):
        eng = get_engine(csr, backend="reference", cache_dir=d, device="cpu")
        streamer = StreamingExecutor(eng, microbatch=2, depth=2, retries=2)
        return (eng.matvec(b), streamer.matmat(X),
                solvers.jacobi(eng, b, tol=1e-6, loop="python").x)

    free = run(str(tmp_path / "free"))
    clear_engine_cache()
    clear_schedule_cache()
    d = str(tmp_path / "chaos")
    run(d)  # a warm file to corrupt
    clear_engine_cache()
    clear_schedule_cache()
    with FaultPlan("store_read:rate=1,count=1;store_write:count=1;"
                   "dispatch_timeout:after=1,count=2") as plan:
        chaos = run(d)
    for a, b_ in zip(free, chaos):
        assert torch.equal(a, b_)
    rep = plan.report()
    assert rep["injected"] == 4 and rep["unrecovered"] == 0
