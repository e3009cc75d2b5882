"""The port's plan autotuner (`repro_torch.core.tune`) held to
`repro.core.tune`: model-mode winners and keys equal, tune files read by
either package with zero trials, tampered and out-of-space files
quarantined and re-searched, the cache-directory fallbacks, measure mode on
the CPU reference backend (and its infeasible candidates and memory
groups), and the `get_tuned_engine` handoff."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.core import formats as jf
from repro.core import matrices as jm
from repro.core import tune as jtune
from repro_torch.core import formats as tf
from repro_torch.core import matrices as tm
from repro_torch.core import tune as tune_mod
from repro_torch.core.engine import SpMVEngine, clear_engine_cache, \
    clear_schedule_cache
from repro_torch.core.faults import FaultPlan
from repro_torch.core.tune import DEFAULT_SPACE, autotune, \
    candidate_device_bytes, clear_tune_cache, get_tuned_engine, \
    resolve_tune_cache_dir, tune_key, tune_path, tune_stats

N_CANDIDATES = 216  # |DEFAULT_SPACE| = 3 * 3 * 3 * 2 * 2 * 2
SMALL_SPACE = {"cols_per_chunk": (4, 8), "block_rows": (4, 8),
               "k_tile": (8,), "packed": (0, 1), "buffer_depth": (2,),
               "value_dtype": ("native",)}


def _sells(gen=lambda m: m.banded(256, 12, 0.7), slice_height=None):
    kw = {} if slice_height is None else {"slice_height": slice_height}
    return (tf.csr_to_sell(gen(tm)(np.random.default_rng(0)), **kw),
            jf.csr_to_sell(gen(jm)(np.random.default_rng(0)), **kw))


SELL, JSELL = _sells()


@pytest.fixture(autouse=True)
def _fresh_port_caches(monkeypatch):
    monkeypatch.delenv("REPRO_TUNE_CACHE", raising=False)
    monkeypatch.delenv("REPRO_SCHEDULE_CACHE", raising=False)
    clear_tune_cache()
    clear_engine_cache()
    clear_schedule_cache()
    jtune.clear_tune_cache()
    yield


def _knobs(plan):
    return (plan.cols_per_chunk, plan.block_rows, plan.k_tile, plan.packed,
            plan.buffer_depth, plan.value_dtype, plan.cost)


@pytest.mark.parametrize("case,k,space", [
    ("banded", 32, None),
    ("banded", 1, None),
    ("powerlaw", 8, None),
    ("skewed", 64, SMALL_SPACE),
])
def test_model_winner_and_key_equal_repro(case, k, space):
    gens = {"banded": lambda m: m.banded(256, 12, 0.7),
            "powerlaw": lambda m: m.powerlaw(300, 8),
            "skewed": lambda m: m.powerlaw(640, 6, skew=3.0)}
    t, j = _sells(gens[case], slice_height=8)
    ours = autotune(t, k=k, backend="reference", mode="model", space=space,
                    device="cpu")
    theirs = jtune.autotune(j, k=k, backend="reference", mode="model",
                            space=space)
    assert _knobs(ours) == _knobs(theirs)
    assert ours.trials == theirs.trials == (
        N_CANDIDATES if space is None else 8)
    norm = tune_mod._normalize_space(space)
    assert norm == jtune._normalize_space(space)
    from repro.core.engine import _sell_content_digest as jdigest
    from repro_torch.core.engine import _sell_content_digest as tdigest

    assert tdigest(t) == jdigest(j)
    assert tune_key(tdigest(t), k=k, backend="reference", mode="model",
                    space=norm) == jtune.tune_key(
        jdigest(j), k=k, backend="reference", mode="model", space=norm)


def test_cuda_backend_searches_one_k_tile():
    """The Hopper kernels take their column tile from k, so a search on the
    cuda backend keeps one k_tile (the engine default): 72 candidates, not
    216, and a key of its own."""
    plan = autotune(SELL, k=16, backend="cuda", mode="model", device="cpu")
    assert plan.trials == N_CANDIDATES // 3 and plan.k_tile == 8
    assert plan.backend == "cuda"
    ref = autotune(SELL, k=16, backend="reference", mode="model",
                   device="cpu")
    assert ref.trials == N_CANDIDATES
    space = dict(DEFAULT_SPACE, k_tile=(4, 16))
    assert autotune(SELL, k=16, backend="cuda", mode="model", device="cpu",
                    space=space).k_tile == 4


def test_memory_cache_hit_runs_zero_trials():
    p1 = autotune(SELL, k=16, backend="reference", mode="model", device="cpu")
    assert p1.source == "search" and p1.trials == N_CANDIDATES
    p2 = autotune(SELL, k=16, backend="reference", mode="model", device="cpu")
    assert p2.source == "memory" and p2.trials == 0
    assert _knobs(p2) == _knobs(p1)
    assert tune_stats()["searched"] == 1 and tune_stats()["memory_hits"] == 1


def test_tune_files_interchange_both_ways_with_zero_trials(tmp_path,
                                                          monkeypatch):
    d1 = str(tmp_path / "from_repro")
    theirs = jtune.autotune(JSELL, k=32, backend="reference", mode="model",
                            cache_dir=d1)
    (name,) = os.listdir(d1)

    def _forbidden(*a, **k):
        raise AssertionError("searched despite a warm tune cache")

    monkeypatch.setattr(tune_mod, "_model_search", _forbidden)
    ours = autotune(SELL, k=32, backend="reference", mode="model",
                    cache_dir=d1, device="cpu")
    assert ours.source == "disk" and ours.trials == 0
    assert _knobs(ours) == _knobs(theirs)
    monkeypatch.undo()

    d2 = str(tmp_path / "from_port")
    clear_tune_cache()
    jtune.clear_tune_cache()
    mine = autotune(SELL, k=32, backend="reference", mode="model",
                    cache_dir=d2, device="cpu")
    assert os.listdir(d2) == [name]  # the same file name from either side
    with open(os.path.join(d1, name)) as a, open(os.path.join(d2, name)) as b:
        assert json.load(a) == json.load(b)  # and the same body
    monkeypatch.setattr(jtune, "_model_search", _forbidden)
    back = jtune.autotune(JSELL, k=32, backend="reference", mode="model",
                          cache_dir=d2)
    assert back.source == "disk" and back.trials == 0
    assert _knobs(back) == _knobs(mine)
    assert jtune.tune_stats()["disk_hits"] == 1


@pytest.mark.parametrize("tamper", ["digest", "out_of_space", "garbage"])
def test_tampered_and_out_of_space_files_quarantined(tmp_path, tamper):
    d = str(tmp_path)
    p1 = autotune(SELL, k=32, backend="reference", mode="model",
                  cache_dir=d, device="cpu")
    (path,) = [tmp_path / n for n in os.listdir(d)]
    payload = json.loads(path.read_text())
    if tamper == "digest":
        payload["matrix_digest"] = "0" * 64  # another matrix's winner
        path.write_text(json.dumps(payload))
    elif tamper == "out_of_space":
        payload["winner"]["k_tile"] = 999  # a knob the space never had
        path.write_text(json.dumps(payload))
    else:
        path.write_bytes(b"{not json")
    clear_tune_cache()
    p2 = autotune(SELL, k=32, backend="reference", mode="model",
                  cache_dir=d, device="cpu")
    stats = tune_stats()
    assert stats["disk_rejects"] == 1 and stats["quarantined"] == 1
    assert stats["searched"] == 1 and stats["disk_saves"] == 1
    assert p2.source == "search" and _knobs(p2) == _knobs(p1)
    assert os.path.exists(str(path) + ".bad") and path.exists()


def test_injected_store_faults_heal(tmp_path):
    d = str(tmp_path)
    autotune(SELL, k=8, backend="reference", mode="model", cache_dir=d,
             device="cpu")
    clear_tune_cache()
    with FaultPlan("store_read:rate=1,count=1;store_write:count=1") as plan:
        p = autotune(SELL, k=8, backend="reference", mode="model",
                     cache_dir=d, device="cpu")
    rep = plan.report()
    assert rep["injected"] == 2 and rep["unrecovered"] == 0
    assert p.source == "search"
    stats = tune_stats()
    assert stats["quarantined"] == 1 and stats["retries"] == 1
    assert stats["disk_saves"] == 1


def test_cache_dir_env_var_and_schedule_store_fallback(tmp_path,
                                                       monkeypatch):
    assert resolve_tune_cache_dir(None) is None
    monkeypatch.setenv("REPRO_SCHEDULE_CACHE", str(tmp_path / "sched"))
    assert resolve_tune_cache_dir(None) == str(tmp_path / "sched")
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune"))
    assert resolve_tune_cache_dir(None) == str(tmp_path / "tune")
    assert resolve_tune_cache_dir(str(tmp_path / "x")) == str(tmp_path / "x")
    autotune(SELL, k=8, backend="reference", mode="model", device="cpu")
    assert any(f.name.startswith("tune-")
               for f in (tmp_path / "tune").iterdir())
    monkeypatch.delenv("REPRO_TUNE_CACHE")
    clear_tune_cache()
    autotune(SELL, k=4, backend="reference", mode="model", device="cpu")
    assert any(f.name.startswith("tune-")
               for f in (tmp_path / "sched").iterdir())


def test_measure_mode_reference_backend_on_the_cpu():
    log = []
    plan = autotune(SELL, k=4, backend="reference", mode="measure",
                    space=SMALL_SPACE, rounds=2, device="cpu",
                    trial_log=log)
    assert plan.source == "search" and plan.mode == "measure"
    assert plan.backend == "reference"
    assert plan.trials == 16  # 8 candidates x 2 interleaved rounds
    assert len(log) == 8 and all(t.error is None for t in log)
    assert plan.cost == min(t.us for t in log) > 0
    best = min(log, key=lambda t: t.us).candidate
    assert (plan.cols_per_chunk, plan.block_rows, plan.packed) == (
        best["cols_per_chunk"], best["block_rows"], best["packed"])
    again = autotune(SELL, k=4, backend="reference", mode="measure",
                     space=SMALL_SPACE, rounds=2, device="cpu")
    assert again.trials == 0 and again.source == "memory"
    # rounds are part of a measured question
    assert autotune(SELL, k=4, backend="reference", mode="measure",
                    space=SMALL_SPACE, rounds=1, device="cpu").trials == 8


def test_measure_mode_scores_refused_geometries_as_infeasible(monkeypatch):
    real = SpMVEngine.matvec

    def refuse_cpc4(self, x):
        if self.cols_per_chunk == 4:
            raise ValueError("one stage of one wide block ... exceeds the "
                             "shared-memory limit")
        return real(self, x)

    monkeypatch.setattr(SpMVEngine, "matvec", refuse_cpc4)
    log = []
    plan = autotune(SELL, k=1, backend="cuda", mode="measure",
                    space=SMALL_SPACE, rounds=1, device="cpu", trial_log=log)
    assert plan.cols_per_chunk == 8
    refused = [t for t in log if t.error is not None]
    assert len(refused) == 4 and all(t.us == float("inf") for t in refused)
    assert all(t.candidate["cols_per_chunk"] == 4 for t in refused)
    assert tune_stats()["infeasible"] == 4 and plan.trials == 4
    clear_tune_cache()
    with pytest.raises(RuntimeError, match="every one of the 4 candidates"):
        autotune(SELL, k=1, backend="cuda", mode="measure", device="cpu",
                 space=dict(SMALL_SPACE, cols_per_chunk=(4,)), rounds=1)


def test_measure_mode_in_groups_reruns_the_group_winners(monkeypatch):
    monkeypatch.setattr(tune_mod, "_measure_groups",
                        lambda sell, cands, device, reserve: [
                            list(range(0, 3)), list(range(3, len(cands)))])
    log = []
    plan = autotune(SELL, k=4, backend="reference", mode="measure",
                    space=SMALL_SPACE, rounds=1, device="cpu", trial_log=log)
    assert [t.group for t in log] == [0, 0, 0, 1, 1, 1, 1, 1]
    assert plan.trials == 8 + 2  # every candidate once, then the 2 winners
    assert plan.cost == min(t.us for t in log)


def test_candidate_device_bytes_bound_what_an_engine_holds():
    for cand in tune_mod._candidates(tune_mod._normalize_space(SMALL_SPACE)):
        eng = SpMVEngine(SELL, backend="cuda", device="cpu",
                         cols_per_chunk=cand["cols_per_chunk"],
                         block_rows=cand["block_rows"],
                         packed=bool(cand["packed"]))
        plan, sched = eng.device_plan, eng.schedule
        held = (eng.plan_values(torch.float32).nbytes + plan.tags.nbytes
                + plan.elem_meta.nbytes)
        assert held <= candidate_device_bytes(SELL, cand,
                                              with_schedule=False)
        with_sched = held + sum(
            getattr(sched, f).nbytes for f in
            ("tags", "n_warps", "elem_warp", "elem_offset", "elem_valid"))
        assert with_sched <= candidate_device_bytes(SELL, cand,
                                                    with_schedule=True)


def test_measure_groups_fit_the_free_memory(monkeypatch):
    cands = tune_mod._candidates(tune_mod._normalize_space(SMALL_SPACE))
    assert tune_mod._measure_groups(SELL, cands, torch.device("cpu"), 0) == [
        list(range(8))]
    one = candidate_device_bytes(SELL, cands[0], with_schedule=True)
    free = int(2 * one * 2.5 / tune_mod.MEASURE_MEMORY_SHARE)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (free, 4 * free))
    groups = tune_mod._measure_groups(SELL, cands, torch.device("cuda", 0),
                                      0)
    assert sorted(i for g in groups for i in g) == list(range(8))
    assert 1 < len(groups) < 8
    for g in groups:
        seen, need = set(), 0
        for i in g:
            key = (cands[i]["cols_per_chunk"], cands[i]["block_rows"])
            need += candidate_device_bytes(SELL, cands[i],
                                           with_schedule=key not in seen)
            seen.add(key)
        assert need <= tune_mod.MEASURE_MEMORY_SHARE * free or len(g) == 1


def test_space_validation():
    with pytest.raises(ValueError, match="unknown"):
        autotune(SELL, k=4, mode="model", space={"warp_size": (32,)},
                 device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        autotune(SELL, k=4, mode="model", space={"k_tile": (0,)},
                 device="cpu")
    with pytest.raises(ValueError, match="packed"):
        autotune(SELL, k=4, mode="model", space={"packed": (2,)},
                 device="cpu")
    with pytest.raises(ValueError, match="mode"):
        autotune(SELL, k=4, mode="exhaustive", device="cpu")
    with pytest.raises(ValueError, match="k must be"):
        autotune(SELL, k=0, mode="model", device="cpu")


def test_distinct_questions_and_hw_get_distinct_winners(tmp_path):
    from repro_torch.core.perfmodel import DEFAULT_HW

    d = str(tmp_path)
    autotune(SELL, k=8, backend="reference", mode="model", cache_dir=d,
             device="cpu")
    autotune(SELL, k=64, backend="reference", mode="model", cache_dir=d,
             device="cpu")
    assert len(os.listdir(d)) == 2  # k is part of the identity
    slow = dataclasses.replace(DEFAULT_HW, channel_bytes_per_cycle=4.0)
    p = autotune(SELL, k=8, backend="reference", mode="model", hw=slow,
                 device="cpu")
    q = jtune.autotune(JSELL, k=8, backend="reference", mode="model",
                       hw=jtune.DEFAULT_HW.__class__(
                           **dataclasses.asdict(slow)))
    assert p.source == "search" and _knobs(p) == _knobs(q)


def test_get_tuned_engine_feeds_get_engine(tmp_path):
    engine, plan = get_tuned_engine(
        SELL, k=16, backend="reference", mode="model",
        tune_cache_dir=str(tmp_path), device="cpu",
    )
    assert engine.block_rows == plan.block_rows
    assert engine.k_tile == plan.k_tile
    assert engine.buffer_depth == plan.buffer_depth
    assert engine.value_dtype == (None if plan.value_dtype == "native"
                                  else plan.value_dtype)
    engine2, plan2 = get_tuned_engine(
        SELL, k=16, backend="reference", mode="model",
        tune_cache_dir=str(tmp_path), device="cpu",
    )
    assert engine2 is engine and plan2.trials == 0
    X = np.random.default_rng(3).standard_normal((SELL.n_cols, 16)).astype(
        np.float32)
    # the reference executor's sums do not depend on the plan's geometry
    ref = SpMVEngine(SELL, backend="reference", device="cpu",
                     value_dtype=engine.value_dtype)
    assert torch.equal(engine.matmat(X), ref.matmat(X))
    assert tune_path("/tmp/cache", "ab").endswith("tune-ab.json")
    assert DEFAULT_SPACE == jtune.DEFAULT_SPACE
    assert tune_mod.TUNE_VERSION == jtune.TUNE_VERSION
