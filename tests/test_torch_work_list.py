"""The cuda engine's ragged plan on the CPU: each slice's own windows, cut
into the work items the SELL kernels walk.

Against the plan padded to the widest slice (the uniform `DevicePlan` the
kernels walked before, and the JAX-parity callers still build): the ragged
plan's windows are that plan's live windows, tag for tag and word for word;
the work list covers every window once with no item above its share; the
kernels' plain versions over it, partial rows and combine included, match
the reference backend (``|got - ref| <= 1e-5 + 1e-5 * |ref|``, the card
tests' form of the 1e-5 gate: a cut slice's sum is added up in another
order); a matrix whose slices all hold the same windows is cut nowhere.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import matrices
from repro_torch.core.engine import SpMVEngine, cached_block_schedule, \
    clear_engine_cache, clear_schedule_cache
from repro_torch.core.formats import CSRMatrix
from repro_torch.core.runtime import normalize_to_sell, pad_slices, \
    pad_width
from repro_torch.core.spmv import _sell_padded
from repro_torch.kernels.sell_spmm import sell_spmm_plain
from repro_torch.kernels.sell_spmv import build_device_plan, item_share, \
    resident_slots, sell_spmv_plain, work_list

ATOL = RTOL = 1e-5

FAMILIES = {
    "powerlaw": lambda: matrices.powerlaw(3000, 8)(seed=1),
    "banded": lambda: matrices.banded(3000, 24, 0.8)(seed=1),
}


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    clear_engine_cache()
    clear_schedule_cache()
    yield


def _engine(csr, **kw):
    return SpMVEngine(csr, backend="cuda", device="cpu", **kw)


def _padded_plan(csr, *, cpc=8, block_rows=8, packed="auto"):
    """The plan of every slice padded to the widest (a uniform plan)."""
    sell = normalize_to_sell(csr)
    ci, va, _ = _sell_padded(sell)
    ci, va, _ = pad_width(ci, va, multiple=cpc)
    sched, _ = cached_block_schedule(
        ci.reshape(-1), window=cpc * sell.slice_height,
        block_rows=block_rows, device="cpu")
    return build_device_plan(sched, n_slices=sell.n_slices,
                             cols_per_chunk=cpc,
                             slice_height=sell.slice_height, packed=packed)


def _close(got, want):
    err = (got - want).abs()
    assert torch.all(err <= ATOL + RTOL * want.abs()), float(err.max())


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_ragged_windows_equal_the_padded_plans_live_windows(family, packed):
    csr = FAMILIES[family]()
    eng = _engine(csr, packed=packed)
    plan = eng.device_plan
    padded = _padded_plan(csr, packed=packed)
    assert plan.packed == packed
    assert padded.n_windows == padded.n_slices * padded.n_chunks
    own = np.asarray(eng.slice_windows)
    live = (np.arange(padded.n_chunks)[None, :] < own[:, None]).reshape(-1)
    assert plan.n_windows == int(live.sum()) < padded.n_windows
    assert plan.n_chunks == padded.n_chunks == int(own.max())
    assert plan.max_warps == padded.max_warps
    live = torch.as_tensor(live)
    torch.testing.assert_close(plan.tags, padded.tags[live], rtol=0, atol=0)
    lanes = plan.elem_meta.shape[1:]
    torch.testing.assert_close(
        plan.elem_meta, padded.elem_meta.reshape((-1,) + lanes)[live],
        rtol=0, atol=0)
    ptr = np.zeros(own.size + 1, dtype=np.int64)
    ptr[1:] = np.cumsum(own)
    np.testing.assert_array_equal(plan.slice_chunk_ptr.numpy(), ptr)
    # the values the kernels read are the slices' own storage, window-major
    assert tuple(eng.plan_values(torch.float32).shape) == (
        plan.n_windows, 8, plan.slice_height)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_work_list_covers_every_window_once_within_the_share(family):
    eng = _engine(FAMILIES[family]())
    plan = eng.device_plan
    own = np.asarray(eng.slice_windows)
    ptr = plan.slice_chunk_ptr.numpy().astype(np.int64)
    items = plan.items.numpy().astype(np.int64)
    sl, first, count, part = items.T
    assert plan.item_share == item_share(own, resident_slots("cpu", 32))
    assert count.min() >= 1 and count.max() <= plan.item_share
    assert np.all(np.diff(count) <= 0)  # heaviest first
    covered = np.concatenate([np.arange(f, f + c)
                              for f, c in zip(first, count)])
    np.testing.assert_array_equal(np.sort(covered),
                                  np.arange(plan.n_windows))
    # every item lies inside its own slice
    assert np.all(first >= ptr[sl]) and np.all(first + count <= ptr[sl + 1])
    cut = own > plan.item_share
    assert plan.split_slices == int(cut.sum()) > 0
    np.testing.assert_array_equal(part >= 0, cut[sl])
    comb = plan.combine.numpy().astype(np.int64)
    np.testing.assert_array_equal(comb[:, 0], np.flatnonzero(cut))
    assert plan.n_partials == int(comb[:, 2].sum())
    for s, p0, n in comb:  # a cut slice's items name its rows in order
        mine = items[sl == s]
        mine = mine[np.argsort(mine[:, 1])]
        np.testing.assert_array_equal(mine[:, 3], np.arange(p0, p0 + n))
        assert mine[:, 2].max() - mine[:, 2].min() <= 1  # near-equal cuts


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_plain_kernels_over_split_slices_match_the_reference(family):
    csr = FAMILIES[family]()
    eng, ref = _engine(csr), SpMVEngine(csr, backend="reference",
                                        device="cpu")
    plan = eng.device_plan
    assert plan.split_slices > 0
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.standard_normal(csr.n_cols).astype(np.float32))
    X = torch.as_tensor(rng.standard_normal((csr.n_cols, 9)).astype(
        np.float32))
    _close(eng.matvec(x), ref.matvec(x))
    _close(eng.matmat(X), ref.matmat(X))
    values = eng.plan_values(torch.float32)
    y = sell_spmv_plain(None, values, x, plan=plan)[:csr.n_rows]
    assert torch.equal(y, eng.matvec(x))
    Y = sell_spmm_plain(None, values, X, plan=plan, k_tile=4)[:csr.n_rows]
    _close(Y, ref.matmat(X))


def _uniform_csr(n=4096, per_row=20):
    """Every row holds `per_row` entries, so every slice one width."""
    rng = np.random.default_rng(3)
    cols = (np.arange(n)[:, None] + 37 * np.arange(per_row)[None, :]) % n
    cols = np.sort(cols, axis=1)
    return CSRMatrix(n, n, np.arange(n + 1, dtype=np.int64) * per_row,
                     cols.reshape(-1).astype(np.int32),
                     rng.standard_normal(n * per_row))


def test_a_uniform_width_matrix_plans_no_split_slice():
    csr = _uniform_csr()
    eng = _engine(csr)
    plan = eng.device_plan
    assert set(np.asarray(eng.slice_windows).tolist()) == {3}
    assert plan.split_slices == plan.n_partials == 0
    assert plan.n_items == plan.n_slices and plan.n_windows == 3 * 128
    items = plan.items.numpy()
    np.testing.assert_array_equal(items[:, 0], np.arange(128))  # slice order
    np.testing.assert_array_equal(items[:, 3], -1)
    x = torch.randn(csr.n_cols)
    _close(eng.matvec(x), SpMVEngine(csr, backend="reference",
                                     device="cpu").matvec(x))


def test_a_uniform_plan_is_one_item_a_slice():
    """`build_device_plan` without per-slice windows (the JAX-parity
    callers) gives every slice the widest slice's windows and walks one
    item a slice, in slice order, none cut."""
    plan = _padded_plan(FAMILIES["powerlaw"]())
    assert plan.split_slices == plan.n_partials == 0
    n = plan.n_chunks
    np.testing.assert_array_equal(plan.items.numpy(), np.stack([
        np.arange(plan.n_slices), np.arange(plan.n_slices) * n,
        np.full(plan.n_slices, n), np.full(plan.n_slices, -1)], axis=1))
    np.testing.assert_array_equal(plan.slice_chunk_ptr.numpy(),
                                  np.arange(plan.n_slices + 1) * n)
    assert tuple(plan.combine.shape) == (0, 3)


@pytest.mark.parametrize("counts, share, want", [
    # slices of 5, 1, 1 and 9 windows at share 3: slice 0 cut 3 + 2, slice
    # 3 cut 3 + 3 + 3 (partial rows 0-1 and 2-4); heaviest first, stably
    ([5, 1, 1, 9], 3, [(0, 0, 3, 0), (3, 7, 3, 2), (3, 10, 3, 3),
                       (3, 13, 3, 4), (0, 3, 2, 1), (1, 5, 1, -1),
                       (2, 6, 1, -1)]),
    ([2, 2, 2], 2, [(0, 0, 2, -1), (1, 2, 2, -1), (2, 4, 2, -1)]),
])
def test_work_list_by_hand(counts, share, want):
    items, combine = work_list(np.asarray(counts), share)
    assert list(map(tuple, items.tolist())) == want
    cut = [s for s, c in enumerate(counts) if c > share]
    assert combine[:, 0].tolist() == cut
    assert [tuple(r) for r in combine[:, 1:].tolist()] == (
        [(0, 2), (2, 3)] if cut else [])


def test_item_share_is_the_mean_walk_but_never_below_the_lightest_slice():
    assert item_share(np.array([1, 1, 40]), slots=4) == 11
    assert item_share(np.array([6, 6, 6]), slots=100) == 6
    assert item_share(np.array([3, 4, 4, 4]), slots=2) == 8


def test_pad_slices_keeps_each_slice_at_its_own_width():
    sell = normalize_to_sell(FAMILIES["powerlaw"]())
    ci, va, widths = pad_slices(sell, multiple=8)
    assert np.all(widths % 8 == 0) and np.all(widths >= sell.slice_widths)
    assert np.all(widths - sell.slice_widths < 8)
    H, ptr = sell.slice_height, 0
    for s in range(sell.n_slices):
        c, v = sell.slice_arrays(s)
        w = int(widths[s])
        got_c = ci[ptr:ptr + w * H].reshape(w, H)
        got_v = va[ptr:ptr + w * H].reshape(w, H)
        np.testing.assert_array_equal(got_c[:c.shape[0]], c)
        np.testing.assert_array_equal(got_v[:v.shape[0]], v)
        assert not got_c[c.shape[0]:].any() and not got_v[v.shape[0]:].any()
        ptr += w * H
    assert ptr == ci.size
