"""The port's `GatherEngine`, mirroring tests/test_gather_engine.py: backend
parity, one engine across spellings, one schedule build across backends,
the wrapper's shapes, the prebuilt-plan kernel path, and `plan_report`
numbers equal to `repro`'s on the same stream. CPU engines: the cuda backend
runs the kernel's plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as je
from repro.core import gather_engine as jge
from repro_torch.core.engine import clear_engine_cache, \
    clear_schedule_cache, schedule_cache_stats
from repro_torch.core.gather_engine import (
    GatherEngine,
    clear_gather_engine_cache,
    gather_engine_cache_stats,
    get_gather_engine,
    resolve_gather_backend,
)
from repro_torch.core.indirect_stream import coalesced_gather
from repro_torch.kernels.coalesced_gather import build_gather_plan, \
    coalesced_gather_plain, resolve_gather_plan


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    clear_engine_cache()
    clear_schedule_cache()
    clear_gather_engine_cache()
    yield


def _case(n_rows=64, d=8, n=96, seed=0):
    rng = np.random.default_rng(seed)
    table = torch.as_tensor(rng.standard_normal((n_rows, d)).astype(
        np.float32))
    idx = rng.integers(0, n_rows, n).astype(np.int32)
    return table, idx


@pytest.mark.parametrize("backend", ["index", "coalesced", "reference",
                                     "cuda", "auto"])
def test_backend_parity_bitwise(backend):
    """Every backend is a gather: bitwise ``table[idx]``."""
    table, idx = _case(seed=3)
    eng = GatherEngine(table.shape, idx, window=32, backend=backend,
                       device="cpu")
    assert torch.equal(eng.gather(table), table[idx])


def test_backend_resolution():
    assert resolve_gather_backend("auto", "cpu") == "coalesced"
    assert resolve_gather_backend("auto", torch.device("cuda", 0)) == "cuda"
    assert resolve_gather_backend("reference", "cpu") == "coalesced"
    assert resolve_gather_backend("index", "cpu") == "index"
    with pytest.raises(ValueError, match="backend must be one of"):
        resolve_gather_backend("jnp", "cpu")


def test_engine_cache_identity_across_spellings():
    """Same stream + geometry -> same engine object; 'reference' is an alias
    of 'coalesced' and 'auto' resolves to it on the CPU."""
    table, idx = _case()
    a = get_gather_engine(table.shape, idx, window=32, backend="coalesced",
                          device="cpu")
    b = get_gather_engine(table.shape, torch.as_tensor(idx), window=32,
                          backend="coalesced", device="cpu")
    c = get_gather_engine(table.shape, idx, window=32, backend="reference",
                          device="cpu")
    d = get_gather_engine(table.shape, idx.astype(np.int64), window=32,
                          backend="auto", device="cpu")
    assert a is b is c is d
    stats = gather_engine_cache_stats()
    assert stats["size"] == 1 and stats["misses"] == 1 and stats["hits"] == 3


def test_schedule_built_once_across_backends():
    """The schedule cache is content-addressed on (stream, geometry,
    device), so every backend of one stream shares a single build."""
    table, idx = _case()
    for backend in ("index", "coalesced", "cuda"):
        get_gather_engine(table.shape, idx, window=32, backend=backend,
                          device="cpu").gather(table)
    assert schedule_cache_stats()["built"] == 1


def test_wrapper_routes_through_engine_cache():
    """Repeat streams through coalesced_gather hit the engine cache (zero
    new schedule builds after the first call)."""
    table, idx = _case()
    out1 = coalesced_gather(table, idx, window=32, backend="coalesced")
    built = schedule_cache_stats()["built"]
    out2 = coalesced_gather(table, idx, window=32, backend="coalesced")
    assert schedule_cache_stats()["built"] == built == 1
    assert torch.equal(out1, out2) and torch.equal(out1, table[idx])


@pytest.mark.parametrize("backend", ["index", "coalesced", "cuda"])
def test_wrapper_preserves_index_shape(backend):
    table, idx = _case(n=24)
    out = coalesced_gather(table, torch.as_tensor(idx).reshape(4, 6),
                           window=32, backend=backend)
    assert out.shape == (4, 6, table.shape[1])
    assert torch.equal(out.reshape(24, -1), table[idx])
    empty = coalesced_gather(table, np.zeros((0, 3), np.int32), window=32)
    assert empty.shape == (0, 3, table.shape[1])


def test_wrapper_runs_a_prebuilt_schedule():
    table, idx = _case()
    eng = GatherEngine(table.shape, idx, window=32, block_rows=8,
                       device="cpu")
    out = coalesced_gather(table, idx, window=32, block_rows=8,
                           schedule=eng.schedule)
    assert torch.equal(out, table[idx])


@pytest.mark.parametrize("block_rows,packed", [(1, "auto"), (8, "auto"),
                                               (8, False)])
def test_plan_report_numbers_equal_repro(block_rows, packed):
    table, idx = _case(n=200, seed=5)
    kw = dict(window=32, block_rows=block_rows, packed=packed)
    ours = GatherEngine(table.shape, idx, backend="coalesced", device="cpu",
                        **kw).plan_report(row_bytes=4096)
    theirs = jge.GatherEngine(table.shape, idx, backend="coalesced",
                              **kw).plan_report(row_bytes=4096)
    assert ours == theirs


def test_gather_perf_rewards_dedup():
    n_rows, d = 64, 8
    dup = np.repeat(np.arange(8), 8).astype(np.int32)  # 64 refs, 8 rows
    distinct = np.arange(64).astype(np.int32)
    rep_dup = GatherEngine((n_rows, d), dup, window=64,
                           device="cpu").plan_report()
    rep_dis = GatherEngine((n_rows, d), distinct, window=64,
                           device="cpu").plan_report()
    assert rep_dup["wide_accesses"] < rep_dis["wide_accesses"]
    assert (rep_dup["gather_perf"]["dedup_rate"]
            > rep_dis["gather_perf"]["dedup_rate"])


def test_kernel_accepts_prebuilt_plan():
    """The kernel path runs from a hoisted plan alone, no index stream;
    a plan built for window=32 is not a window=64 plan."""
    table, idx = _case()
    eng = GatherEngine(table.shape, idx, window=32, backend="cuda",
                       device="cpu")
    plan = build_gather_plan(eng.schedule, packed="auto")
    assert plan is not eng.device_plan and torch.equal(
        plan.elem_meta, eng.device_plan.elem_meta)
    out = coalesced_gather_plain(table, None, window=32, block_rows=1,
                                 plan=plan, n_out=len(idx))
    assert torch.equal(out, table[idx])
    with pytest.raises(ValueError, match="gather plan was built"):
        resolve_gather_plan(None, window=64, block_rows=1, plan=plan)


def test_constructor_validation():
    with pytest.raises(ValueError):
        GatherEngine((64,), np.arange(4, dtype=np.int32), device="cpu")
    with pytest.raises(ValueError):
        GatherEngine((64, 8), np.array([], dtype=np.int32), device="cpu")
    with pytest.raises(ValueError):
        GatherEngine((64, 8), np.array([64], dtype=np.int32), device="cpu")
    with pytest.raises(ValueError):
        GatherEngine((64, 8), np.arange(4), packed="yes", device="cpu")
    table, idx = _case()
    eng = GatherEngine(table.shape, idx, window=32, device="cpu")
    with pytest.raises(ValueError, match="table of shape"):
        eng.gather(torch.zeros((32, 8)))
    with pytest.raises(ValueError, match="lives on"):
        eng.gather(torch.zeros((64, 8), device="meta"))


def test_numpy_table_is_staged_and_shape_bound_not_value_bound():
    """A numpy table is staged on the engine's device, and one engine
    serves every same-shaped table (k-pages and v-pages)."""
    table, idx = _case()
    eng = GatherEngine(table.shape, idx, window=32, device="cpu")
    other = table.numpy() * 2.0
    assert torch.equal(eng.gather(other), torch.as_tensor(other)[idx])
    assert torch.equal(eng.gather(table), table[idx])


def test_engine_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GatherEngine((64, 8), np.arange(4, dtype=np.int32))


def test_repro_engine_cache_is_untouched():
    """The port's caches are its own: planning here builds nothing in
    `repro`'s schedule cache."""
    table, idx = _case()
    before = je.schedule_cache_stats()["built"]
    GatherEngine(table.shape, idx, window=32, device="cpu").gather(table)
    assert je.schedule_cache_stats()["built"] == before
    jge.GatherEngine(table.shape, idx, window=32).gather(
        jnp.asarray(table.numpy()))
    assert schedule_cache_stats()["built"] == 1
