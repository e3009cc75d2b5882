"""The port's sharded SpMV engine (`repro_torch.core.dist`) and meshes
(`repro_torch.launch.mesh`), held to `repro.core.dist`: on the reference
backend in float32 every strategy and shard count is bit-identical to the
single-device engine and to the JAX package's sharded engine (one JAX CPU
device, shards round-robined); per-shard plan files cross between the
packages; a shard failed by injection is recomputed bit-identically and a
real failure raises; the sharded CG host loop follows `repro`'s."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dist as jdist
from repro.core import engine as jengine
from repro.core import formats as jf
from repro.core import matrices as jm
from repro.core import solvers as jsolvers
from repro.launch import mesh as jmesh
from repro_torch.core import formats as tf
from repro_torch.core import matrices as tm
from repro_torch.core import solvers
from repro_torch.core.dist import ShardedSpMVEngine, device_str, \
    row_shard_sells
from repro_torch.core.engine import SpMVEngine, clear_engine_cache, \
    clear_schedule_cache, schedule_cache_stats
from repro_torch.core.faults import FaultPlan
from repro_torch.core.partition import PARTITION_STRATEGIES
from repro_torch.core.runtime import DeviceMesh, StreamingExecutor, \
    proper_slice
from repro_torch.launch.mesh import auto_spmv_mesh, make_host_mesh, \
    parse_mesh_spec

MATRICES = {
    "banded": (lambda m: m.banded(300, 16, 0.7), 8),
    "powerlaw": (lambda m: m.powerlaw(257, 8), 8),
    "skewed": (lambda m: m.powerlaw(640, 6, skew=3.0), 8),
}
CPU = torch.device("cpu")


# jitted: eager op-by-op dispatch of the JAX planner costs seconds a shard;
# its schedule cache is kept across tests (shards recur between strategies)
_repro_build = jax.jit(jengine.build_block_schedule,
                       static_argnames=("window", "block_rows", "max_warps"))


@pytest.fixture(autouse=True)
def _fresh_port_caches(monkeypatch):
    monkeypatch.setattr(jengine, "build_block_schedule", _repro_build)
    clear_engine_cache()
    clear_schedule_cache()
    yield


def _sells(name):
    gen, h = MATRICES[name]
    return (tf.csr_to_sell(gen(tm)(np.random.default_rng(0)), slice_height=h),
            jf.csr_to_sell(gen(jm)(np.random.default_rng(0)), slice_height=h))


def _rhs(n, k, seed=1, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(dtype)


@pytest.mark.parametrize("strategy", PARTITION_STRATEGIES)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_row_shard_sells_equal_repro(name, strategy):
    t, j = _sells(name)
    ours = row_shard_sells(t, 3, partition=strategy)
    theirs = jdist.row_shard_sells(j, 3, partition=strategy)
    assert len(ours) == len(theirs)
    for (ts, tlo, thi), (js, jlo, jhi) in zip(ours, theirs):
        assert (tlo, thi) == (jlo, jhi)
        assert (ts.n_rows, ts.n_cols, ts.slice_height) == (
            js.n_rows, js.n_cols, js.slice_height)
        for f in ("slice_ptrs", "slice_widths", "colidx", "values"):
            np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))


@pytest.mark.parametrize("strategy", PARTITION_STRATEGIES)
@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_sharded_bit_identical_to_single_device_and_repro(name, n_shards,
                                                          strategy):
    t, j = _sells(name)
    X = _rhs(t.n_cols, 5)
    sharded = ShardedSpMVEngine(t, backend="reference", n_shards=n_shards,
                                partition=strategy, device="cpu")
    assert sharded.n_shards == min(n_shards, t.n_slices)
    single = SpMVEngine(t, backend="reference", device="cpu")
    Y, y = sharded.matmat(X), sharded.matvec(X[:, 0])
    assert torch.equal(Y, single.matmat(X))
    assert torch.equal(y, single.matvec(X[:, 0]))
    theirs = jdist.ShardedSpMVEngine(j, backend="reference",
                                     n_shards=n_shards, partition=strategy)
    np.testing.assert_array_equal(Y.numpy(),
                                  np.asarray(theirs.matmat(jnp.asarray(X))))
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(theirs.matvec(jnp.asarray(X[:, 0]))))


def test_float64_host_batches_equal_repro_bitwise():
    """A float64 host batch is staged as float32, as `jnp.asarray` does
    with x64 off (ROADMAP C12)."""
    t, j = _sells("powerlaw")
    X = _rhs(t.n_cols, 4, dtype=np.float64)
    ours = ShardedSpMVEngine(t, backend="reference", n_shards=3,
                             device="cpu")
    theirs = jdist.ShardedSpMVEngine(j, backend="reference", n_shards=3)
    Y = ours.matmat(X)
    assert Y.dtype == torch.float32
    np.testing.assert_array_equal(Y.numpy(), np.asarray(theirs.matmat(X)))
    assert torch.equal(Y, ours.matmat(X.astype(np.float32)))
    y = ours.matvec(X[:, 0])
    assert y.dtype == torch.float32
    np.testing.assert_array_equal(y.numpy(),
                                  np.asarray(theirs.matvec(X[:, 0])))


def test_matmat_shapes_placement_and_plan_report_as_repro():
    t, j = _sells("skewed")
    ours = ShardedSpMVEngine(t, backend="reference", n_shards=4,
                             device="cpu")
    theirs = jdist.ShardedSpMVEngine(j, backend="reference", n_shards=4)
    assert ours.matmat(_rhs(t.n_cols, 0)).shape == (t.n_rows, 0)
    assert ours.matmat(_rhs(t.n_cols, 1)).shape == (t.n_rows, 1)
    with pytest.raises(ValueError, match="matmat|stage"):
        ours.matmat(_rhs(t.n_cols + 1, 2))
    with pytest.raises(ValueError, match="matvec"):
        ours.matvec(np.zeros(t.n_cols + 1))
    keys = ("shard", "rows", "cols", "nnz_padded", "width", "device_str")
    assert [{k: p[k] for k in keys} for p in ours.placement(6)] == [
        {k: p[k] for k in keys} for p in theirs.placement(6)]
    rep, jrep = ours.plan_report(k=6), theirs.plan_report(k=6)
    for key in ("n_rows", "n_cols", "nnz_padded", "n_shards", "block_rows",
                "wide_accesses", "coalesce_rate", "mesh", "n_devices"):
        assert rep[key] == jrep[key], key
    assert rep["partition"] == jrep["partition"]
    assert rep["matmat"] == jrep["matmat"]
    drop = ("schedule_cached",)
    assert [{k: v for k, v in s.items() if k not in drop}
            for s in rep["shards"]] == [
        {k: v for k, v in s.items() if k not in drop}
        for s in jrep["shards"]]
    widths = [s["width"] for s in rep["shards"]]
    assert max(widths) > min(widths)  # each shard pads to its own width


def test_shards_round_robin_over_grid_rows_and_columns():
    t, _ = _sells("banded")
    mesh = parse_mesh_spec("2,2", device="cpu")
    eng = ShardedSpMVEngine(t, mesh=mesh, backend="reference", n_shards=5)
    assert (eng.n_data, eng.n_model) == (2, 2)
    assert [eng._shard_device_row(i) for i in range(5)] == [0, 1, 0, 1, 0]
    place = eng.placement(5)
    assert len(place) == 10 and {p["cols"] for p in place} == {(0, 2), (2, 5)}
    X = _rhs(t.n_cols, 5)
    single = SpMVEngine(t, backend="reference", device="cpu")
    assert torch.equal(eng.matmat(X), single.matmat(X))
    staged = eng.stage(X)
    # one copy per distinct device and column group
    assert len({id(s) for s in staged.placed.values()}) == 2


def test_streaming_executor_over_sharded_engine_equals_matmat():
    t, _ = _sells("powerlaw")
    eng = ShardedSpMVEngine(t, backend="reference", n_shards=3,
                            mesh=parse_mesh_spec("1,2", device="cpu"))
    X = _rhs(t.n_cols, 11)
    streamer = StreamingExecutor(eng, microbatch=4, depth=2)
    assert torch.equal(streamer.matmat(X), eng.matmat(X))
    assert torch.equal(eng.finalize(eng.dispatch(eng.stage(X))),
                       eng.matmat(X))


@pytest.mark.parametrize("spec,k", [("shard_fail:after=1,count=1", 3),
                                    ("shard_fail:rate=1,count=2", 3),
                                    ("shard_fail:after=2,count=1", 19)])
def test_shard_fail_recovery_bit_identical(spec, k):
    """A failed shard is recomputed by the reference executor (in chunks
    of `RECOVERY_COLUMNS` columns past that width), bit for bit."""
    t, _ = _sells("skewed")
    eng = ShardedSpMVEngine(t, backend="reference", n_shards=4,
                            mesh=parse_mesh_spec("2,1", device="cpu"))
    X = _rhs(t.n_cols, k)
    want = eng.matmat(X)
    with FaultPlan(spec) as plan:
        got = eng.matmat(X)
    assert torch.equal(got, want)
    rec = eng.recovery_report()
    rep = plan.report()
    assert rec["recovered"] == rec["injected"] == rep["injected"] >= 1
    assert rep["unrecovered"] == 0
    ev = rec["events"][0]
    assert ev["mode"] == "reference-recompute" and ev["injected"]
    assert ev["rows"] == eng.row_ranges[ev["shard"]]
    assert eng.plan_report()["recovery"]["recovered"] == rec["recovered"]


def test_organic_dispatch_failure_is_recovered(monkeypatch):
    """Only an injected failure is recovered: a shard engine that raises for
    real (here: in place of its kernel) raises out of `matmat`, and no
    recovery is logged — on the card a reference recompute would put the
    plain version in the kernel's place."""
    t, _ = _sells("banded")
    eng = ShardedSpMVEngine(t, backend="cuda", n_shards=3, device="cpu")
    X = _rhs(t.n_cols, 2)
    eng.matmat(X)

    def broken(staged):
        raise RuntimeError("lost device")

    monkeypatch.setattr(eng.engines[2], "dispatch", broken)
    with pytest.raises(RuntimeError, match="lost device"):
        eng.matmat(X)
    rec = eng.recovery_report()
    assert rec["recovered"] == rec["injected"] == 0 and not rec["events"]


def test_per_shard_plan_files_cross_between_packages(tmp_path):
    t, j = _sells("skewed")
    d1 = str(tmp_path / "from_repro")
    theirs = jdist.ShardedSpMVEngine(j, backend="reference", n_shards=3,
                                     cache_dir=d1)
    theirs.plan_report()
    files = sorted(os.listdir(d1))
    assert len(files) == 3
    ours = ShardedSpMVEngine(t, backend="reference", n_shards=3,
                             cache_dir=d1, device="cpu")
    rep = ours.plan_report()
    stats = schedule_cache_stats()
    assert stats["built"] == 0 and stats["disk_hits"] == 3
    assert all(s["schedule_cached"] for s in rep["shards"])

    jengine.clear_engine_cache()
    jengine.clear_schedule_cache()
    clear_engine_cache()
    clear_schedule_cache()
    d2 = str(tmp_path / "from_port")
    ShardedSpMVEngine(t, backend="reference", n_shards=3, cache_dir=d2,
                      device="cpu").plan_report()
    assert sorted(os.listdir(d2)) == files  # the same names either way
    jrep = jdist.ShardedSpMVEngine(j, backend="reference", n_shards=3,
                                   cache_dir=d2).plan_report()
    jstats = jengine.schedule_cache_stats()
    assert jstats["built"] == 0 and jstats["disk_hits"] == 3
    assert all(s["schedule_cached"] for s in jrep["shards"])


def test_persist_schedules_writes_every_shard(tmp_path):
    t, _ = _sells("banded")
    eng = ShardedSpMVEngine(t, backend="reference", n_shards=3, device="cpu")
    assert eng.persist_schedules(str(tmp_path)) == []  # nothing planned yet
    eng.plan_report()
    paths = eng.persist_schedules(str(tmp_path))
    assert len(paths) == 3 and all(os.path.exists(p) for p in paths)


@pytest.mark.parametrize("n_shards", [1, 3])
def test_sharded_cg_follows_repro(n_shards):
    csr = tm.make_spd(tm.powerlaw(640, 6, skew=3.0)(seed=2))
    jcsr = jm.make_spd(jm.powerlaw(640, 6, skew=3.0)(seed=2))
    b = np.random.default_rng(4).standard_normal(640).astype(np.float32)
    ours = ShardedSpMVEngine(csr, backend="reference", n_shards=n_shards,
                             partition="cost", device="cpu")
    theirs = jdist.ShardedSpMVEngine(jcsr, backend="reference",
                                     n_shards=n_shards, partition="cost")
    res = solvers.cg(ours, b, tol=1e-6)
    jres = jsolvers.cg(theirs, b, tol=1e-6)
    assert res.loop == "host" and res.converged and jres.converged
    # the partial dots are float32 reductions in each framework's order
    assert abs(res.iterations - jres.iterations) <= 1
    jx = np.asarray(jres.x)
    assert np.linalg.norm(res.x - jx) <= 1e-4 * np.linalg.norm(jx)
    single = solvers.cg(csr, b, tol=1e-6, loop="host", backend="reference",
                        device="cpu")
    assert abs(res.iterations - single.iterations) <= 1


def test_mesh_specs_and_errors(monkeypatch):
    m = parse_mesh_spec("4x2", device="cpu")
    assert m.devices.shape == (4, 2) and m.axis_names == ("data", "model")
    assert all(d == CPU for d in m.devices.flat)
    assert parse_mesh_spec("data,model", device="cpu").devices.shape == (1, 1)
    assert auto_spmv_mesh(device="cpu").shape == {"data": 1, "model": 1}
    assert make_host_mesh(device="cpu").devices.shape == (1, 1)
    for bad, msg in (("4,2,1", "two positive ints"), ("0,1", "two positive"),
                     ("a,b", "expects 'data,model'")):
        with pytest.raises(ValueError, match=msg):
            parse_mesh_spec(bad, device="cpu")
        with pytest.raises(ValueError, match=msg):
            jmesh.parse_mesh_spec(bad)  # the same errors as repro
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    m = parse_mesh_spec("2,1")
    assert [str(d) for d in m.devices.flat] == ["cuda:0", "cuda:1"]
    assert auto_spmv_mesh().shape == {"data": 1, "model": 2}
    with pytest.raises(ValueError, match="needs 4 devices but only 2"):
        parse_mesh_spec("2,2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parse_mesh_spec("1,1")


def test_grid_normalization_and_helpers():
    """A mesh is a (data, model) grid; the engine addresses it as
    ``devices[data_row, model_col]``."""
    devs = np.empty((1, 3), dtype=object)
    devs[:] = CPU
    mesh = DeviceMesh(devs)
    assert mesh.shape == {"data": 1, "model": 3}
    assert ShardedSpMVEngine(_sells("banded")[0], mesh=mesh,
                             backend="reference").devices.shape == (1, 3)
    with pytest.raises(ValueError, match=r"\(data, model\) grid; got 3"):
        DeviceMesh(np.empty((1, 3, 1), dtype=object))
    assert device_str(CPU) == "cpu:0"
    assert device_str(torch.device("cuda", 3)) == "cuda:3"
    assert proper_slice(slice(0, 2), 5) and not proper_slice(slice(0, 5), 5)
    t, _ = _sells("banded")
    with pytest.raises(ValueError, match="either mesh= or device="):
        ShardedSpMVEngine(t, mesh=make_host_mesh(device="cpu"), device="cpu")
    with pytest.raises(ValueError, match="n_shards must be >= 1"):
        ShardedSpMVEngine(t, n_shards=0, device="cpu")


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_dropped_engines_free_without_the_collector(backend):
    """An engine's executors hold no reference cycle: a dropped sharded
    engine and its shard engines are freed at once, with the garbage
    collector off (their device memory goes with them)."""
    import gc
    import weakref

    t, _ = _sells("banded")
    X = _rhs(t.n_cols, 3)
    gc.disable()
    try:
        eng = ShardedSpMVEngine(t, backend=backend, n_shards=3,
                                mesh=parse_mesh_spec("2,1", device="cpu"))
        eng.matmat(X)
        eng.matvec(X[:, 0])
        eng.plan_report(k=3)
        refs = [weakref.ref(eng)] + [weakref.ref(e) for e in eng.engines]
        del eng
        clear_engine_cache()
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
