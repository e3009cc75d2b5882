"""The port's persistent schedule store (`repro_torch.core.schedule_store`):
plan files are interchangeable with the JAX package's in both directions
(same names, same arrays, zero builds on load), and the store validates,
quarantines, retries and writes atomically as `repro`'s does."""
import json
import os

import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import schedule_store as jstore
from repro.core.gather_engine import get_gather_engine as j_gather_engine
from repro.core.matrices import banded as j_banded
from repro_torch.core import schedule_store
from repro_torch.core.coalescer import build_block_schedule, \
    trim_schedule_warps
from repro_torch.core.engine import clear_engine_cache, \
    clear_schedule_cache, get_engine, schedule_cache_stats, stream_digest
from repro_torch.core.faults import FaultPlan
from repro_torch.core.gather_engine import clear_gather_engine_cache, \
    get_gather_engine
from repro_torch.core.matrices import banded
from repro_torch.core.schedule_store import ScheduleCacheMismatch, \
    load_schedule, plan_key_digest, save_schedule, schedule_path

FIELDS = ("tags", "n_warps", "elem_warp", "elem_offset", "elem_valid")
RNG = np.random.default_rng(7)


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    clear_engine_cache()
    clear_schedule_cache()
    clear_gather_engine_cache()
    yield


def _schedule(n=500, rows=97, window=64, block_rows=8):
    idx = RNG.integers(0, rows, size=n).astype(np.int32)
    sched = trim_schedule_warps(build_block_schedule(
        idx, window=window, block_rows=block_rows, device="cpu"))
    return idx, sched


def _files(d):
    return sorted(n for n in os.listdir(d) if n.endswith(".npz"))


def _assert_same_arrays(path, sched):
    """The file holds `sched`'s arrays, as both packages read them."""
    theirs = jstore.load_schedule(path)
    ours = load_schedule(path, device="cpu")
    for f in FIELDS:
        want = getattr(sched, f).cpu().numpy()
        np.testing.assert_array_equal(np.asarray(getattr(theirs, f)), want)
        assert torch.equal(getattr(ours, f), getattr(sched, f).cpu()), f
        assert np.asarray(getattr(theirs, f)).dtype == want.dtype


# (port backend, repro backend): the reference pair plans at window 256, the
# kernel pair at cols_per_chunk * slice_height over the widened plan.
@pytest.mark.parametrize("backends", [("reference", "reference"),
                                      ("cuda", "pallas")])
def test_engine_plans_interchange_in_both_directions(tmp_path, backends):
    ours_b, theirs_b = backends
    csr = banded(192, 6, 0.8)(seed=0)
    jcsr = j_banded(192, 6, 0.8)(seed=0)

    # repro saves, the port loads without building
    d1 = str(tmp_path / "from_repro")
    jengine.get_engine(jcsr, backend=theirs_b, cache_dir=d1).schedule
    eng = get_engine(csr, backend=ours_b, cache_dir=d1, device="cpu")
    sched = eng.schedule
    stats = schedule_cache_stats()
    assert stats["built"] == 0 and stats["disk_hits"] == 1
    assert eng.plan_cached is True
    (name,) = _files(d1)
    _assert_same_arrays(os.path.join(d1, name), sched)

    # the port saves, repro loads without building
    jengine.clear_engine_cache()
    jengine.clear_schedule_cache()
    clear_engine_cache()
    clear_schedule_cache()
    d2 = str(tmp_path / "from_port")
    own = get_engine(csr, backend=ours_b, cache_dir=d2, device="cpu").schedule
    assert schedule_cache_stats()["built"] == 1
    jeng = jengine.get_engine(jcsr, backend=theirs_b, cache_dir=d2)
    jeng.schedule
    jstats = jengine.schedule_cache_stats()
    assert jstats["built"] == 0 and jstats["disk_hits"] == 1
    assert _files(d2) == [name]  # the same file name from either package
    _assert_same_arrays(os.path.join(d2, name), own)


def test_gather_plans_interchange_in_both_directions(tmp_path):
    idx = (np.arange(600) * 7 % 50).astype(np.int32)
    d1 = str(tmp_path / "from_repro")
    j_gather_engine((50, 8), idx, cache_dir=d1).schedule
    eng = get_gather_engine((50, 8), idx, cache_dir=d1, device="cpu")
    sched = eng.schedule
    assert schedule_cache_stats()["built"] == 0 and eng.plan_cached
    (name,) = _files(d1)
    _assert_same_arrays(os.path.join(d1, name), sched)

    clear_gather_engine_cache()
    clear_schedule_cache()
    d2 = str(tmp_path / "from_port")
    eng = get_gather_engine((50, 8), idx, device="cpu")
    eng.schedule
    # adopting a directory later writes the plan through
    again = get_gather_engine((50, 8), idx, cache_dir=d2, device="cpu")
    assert again is eng and _files(d2) == [name]
    assert eng.persist_schedule() == os.path.join(d2, name)


def test_engine_adopts_a_directory_and_writes_through(tmp_path):
    csr = banded(128, 4, 0.8)(seed=1)
    eng = get_engine(csr, backend="reference", device="cpu")
    eng.schedule  # planned without a directory
    assert eng.persist_schedule() is None
    d = str(tmp_path)
    assert get_engine(csr, backend="reference", cache_dir=d,
                      device="cpu") is eng
    (name,) = _files(d)
    assert eng.persist_schedule() == os.path.join(d, name)
    assert schedule_cache_stats()["disk_saves"] == 1


def test_round_trip_path_names_and_validation(tmp_path):
    idx, sched = _schedule()
    digest = stream_digest(idx)
    assert digest == jengine.stream_digest(idx)
    d = str(tmp_path)
    for kw in (dict(window=64, block_rows=8),
               dict(window=64, block_rows=8, max_warps=3,
                    matrix_digest="m" * 64)):
        assert schedule_path(d, digest, **kw) == jstore.schedule_path(
            d, digest, **kw)
        assert plan_key_digest(digest, **kw) == jstore.plan_key_digest(
            digest, **kw)
    path = schedule_path(d, digest, window=64, block_rows=8)
    save_schedule(path, sched, stream_digest=digest, matrix_digest="m" * 64)
    loaded = load_schedule(path, expect_stream_digest=digest,
                           expect_window=64, expect_block_rows=8,
                           expect_matrix_digest="m" * 64, device="cpu")
    assert (loaded.window, loaded.block_rows) == (64, 8)
    _assert_same_arrays(path, sched)
    for kw, match in ((dict(expect_stream_digest="x"), "stream digest"),
                      (dict(expect_matrix_digest="n" * 64), "matrix digest"),
                      (dict(expect_window=32), "window"),
                      (dict(expect_block_rows=4), "block_rows")):
        with pytest.raises(ScheduleCacheMismatch, match=match):
            load_schedule(path, device="cpu", **kw)
    # a file saved without a matrix digest is valid for any matrix
    save_schedule(path, sched, stream_digest=digest)
    load_schedule(path, expect_matrix_digest="n" * 64, device="cpu")


def test_corrupt_truncated_and_wrong_version_files_rejected(tmp_path):
    idx, sched = _schedule()
    digest = stream_digest(idx)
    garbage = tmp_path / "garbage.npz"
    garbage.write_bytes(b"not an npz at all")
    with pytest.raises(ScheduleCacheMismatch, match="unreadable"):
        load_schedule(str(garbage), device="cpu")
    path = str(tmp_path / "s.npz")
    save_schedule(path, sched, stream_digest=digest)
    with np.load(path, allow_pickle=False) as z:
        data = {k: z[k] for k in z.files}
    data["tags"] = data["tags"][:-1]  # drop a window
    with open(path, "wb") as f:
        np.savez_compressed(f, **data)
    with pytest.raises(ScheduleCacheMismatch, match="shapes"):
        load_schedule(path, device="cpu")
    save_schedule(path, sched, stream_digest=digest)
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files if k != "header"}
        header = json.loads(z["header"].item())
    header["version"] = 1
    with open(path, "wb") as f:
        np.savez_compressed(f, header=json.dumps(header), **arrays)
    with pytest.raises(ScheduleCacheMismatch, match="version"):
        load_schedule(path, device="cpu")


def _open_fds():
    return len(os.listdir("/proc/self/fd"))


def test_atomic_writes_leave_nothing_behind(tmp_path, monkeypatch):
    idx, sched = _schedule()
    nested = str(tmp_path / "a" / "b")
    path = schedule_path(nested, stream_digest(idx), window=64, block_rows=8)
    save_schedule(path, sched, stream_digest=stream_digest(idx))
    assert os.listdir(nested) == [os.path.basename(path)]

    torn = str(tmp_path / "torn.npz")

    def tearing_write(f):
        f.write(b"half a schedule")
        raise OSError(28, "No space left on device")

    before = _open_fds()
    with pytest.raises(OSError):
        schedule_store.atomic_write_bytes(torn, tearing_write)
    monkeypatch.setattr(os, "fdopen", lambda *a, **k: (_ for _ in ()).throw(
        MemoryError("simulated fdopen failure")))
    for _ in range(4):
        with pytest.raises(MemoryError):
            schedule_store.atomic_write_bytes(torn, lambda f: None)
    assert _open_fds() == before
    assert not os.path.exists(torn) and sorted(os.listdir(tmp_path)) == ["a"]


def test_retry_io_and_quarantine(tmp_path):
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError(28, "No space left on device")
        return "ok"

    schedule_store.clear_store_io_stats()
    assert schedule_store.retry_io(flaky, what="flaky") == "ok"
    assert calls["n"] == 3 and schedule_store.store_io_stats()["retries"] == 2

    def denied():
        calls["n"] += 1
        raise PermissionError(13, "Permission denied")

    calls["n"] = 0
    with pytest.raises(PermissionError):
        schedule_store.retry_io(denied, what="denied")
    assert calls["n"] == 1
    with pytest.raises(OSError):
        schedule_store.retry_io(
            lambda: (_ for _ in ()).throw(OSError(28, "full")), what="full",
            retries=2, base_delay=0.0)

    p = str(tmp_path / "sched-x.npz")
    with open(p, "wb") as f:
        f.write(b"broken")
    seen = []
    assert schedule_store.quarantine(
        p, on_quarantine=lambda: seen.append(1)) == p + ".bad"
    assert seen == [1] and schedule_store.quarantine(p) is None
    assert schedule_store.store_io_stats()["quarantined"] == 1

    idx, sched = _schedule()
    digest = stream_digest(idx)
    path = str(tmp_path / "s.npz")
    schedule_store.clear_store_io_stats()
    with FaultPlan("store_write:rate=1,count=2"):
        save_schedule(path, sched, stream_digest=digest)
    assert torch.equal(load_schedule(path, device="cpu").tags, sched.tags)
    assert schedule_store.store_io_stats()["retries"] == 2
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
