"""The port's plan lowering and the kernels' plain versions against `repro`:
`DevicePlan` arrays exactly equal in both encodings (warp 2**15 included),
and `sell_spmv_plain` / `sell_spmm_plain` within 1e-5 of `repro`'s Pallas
kernels run in interpret mode — from `colidx`, and from a `repro` schedule
carried over with `interop.schedule_from_arrays`. The CUDA kernels
themselves are compared with these plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coalescer as jc
from repro.kernels import sell_spmv as jsv
from repro.kernels.sell_spmm import sell_spmm_pallas
from repro_torch.core import coalescer as tc
from repro_torch.core.engine import clear_engine_cache, clear_schedule_cache
from repro_torch.core.interop import schedule_from_arrays
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sell_spmv as tsv
from repro_torch.kernels.sell_spmm import sell_spmm_cuda, sell_spmm_plain

FIELDS = ("tags", "n_warps", "elem_warp", "elem_offset", "elem_valid")
TOL = 1e-5  # f32 sums of <= 8 products in another order


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    clear_engine_cache()
    clear_schedule_cache()
    yield


def _case(seed, dtype_name, k=None, n_cols=64):
    """tests/test_spmm.py-shaped inputs: colidx (3, 8, 16), 70% dense values,
    x (n_cols,) or X (n_cols, k), made with numpy from `seed`."""
    rng = np.random.default_rng(seed)
    colidx = rng.integers(0, n_cols, size=(3, 8, 16)).astype(np.int32)
    values = (rng.standard_normal((3, 8, 16))
              * (rng.random((3, 8, 16)) < 0.7)).astype(np.float32)
    rhs = rng.standard_normal((n_cols,) if k is None else (n_cols, k))
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype_name]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    j = (jnp.asarray(colidx), jnp.asarray(values).astype(jdt),
         jnp.asarray(rhs.astype(np.float32)))
    t = (torch.as_tensor(colidx), torch.as_tensor(values).to(tdt),
         torch.as_tensor(rhs.astype(np.float32)))
    return j, t


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL)


# -- plan lowering -----------------------------------------------------------


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("cpc,H", [(4, 16), (3, 7)])
def test_device_plan_arrays_equal_repro(packed, cpc, H):
    rng = np.random.default_rng(cpc * H)
    n_slices, W = 3, 2 * cpc
    stream = rng.integers(0, 300, size=n_slices * W * H).astype(np.int32)
    kw = dict(window=cpc * H, block_rows=8)
    ja = jc.build_block_schedule(jnp.asarray(stream), **kw)
    tb = tc.build_block_schedule(stream, **kw, device="cpu")
    geo = dict(n_slices=n_slices, cols_per_chunk=cpc, slice_height=H,
               packed=packed)
    pa = jsv.build_device_plan(ja, **geo)
    pb = tsv.build_device_plan(tb, **geo)
    assert pb.packed == pa.packed == packed
    np.testing.assert_array_equal(np.asarray(pa.tags), pb.tags.numpy())
    np.testing.assert_array_equal(np.asarray(pa.elem_meta),
                                  pb.elem_meta.numpy())
    np.testing.assert_array_equal(np.asarray(pa.elem_warp),
                                  pb.elem_warp.numpy())
    np.testing.assert_array_equal(np.asarray(pa.elem_offset),
                                  pb.elem_offset.numpy())
    assert pb.meta_bytes_per_element == pa.meta_bytes_per_element


def test_packed_plan_round_trips_warp_two_to_the_fifteen():
    """Warp ids >= 2**15 set the int32 sign bit after the shift; the port's
    packing must give repro's word and decode it with a logical shift."""
    ew = np.array([[0, 1, 2**15, tc.PACK_LIMIT - 1]], np.int32)
    eo = np.array([[0, 7, 5, 3]], np.int32)
    arrays = dict(
        tags=np.zeros((1, tc.PACK_LIMIT), np.int32),
        n_warps=np.ones(1, np.int32), elem_warp=ew, elem_offset=eo,
        elem_valid=np.ones((1, 4), bool),
    )
    ja = jc.BlockSchedule(**{f: jnp.asarray(arrays[f]) for f in FIELDS},
                          window=4, block_rows=8)
    tb = schedule_from_arrays(arrays, window=4, block_rows=8, device="cpu")
    geo = dict(n_slices=1, cols_per_chunk=1, slice_height=4, packed=True)
    pa = jsv.build_device_plan(ja, **geo)
    pb = tsv.build_device_plan(tb, **geo)
    np.testing.assert_array_equal(np.asarray(pa.elem_meta),
                                  pb.elem_meta.numpy())
    assert int(pb.elem_meta.min()) < 0  # the sign bit is set
    np.testing.assert_array_equal(pb.elem_warp.numpy().ravel(), ew.ravel())
    np.testing.assert_array_equal(pb.elem_offset.numpy().ravel(), eo.ravel())


def test_packing_requests_and_geometry_checks():
    stream = np.arange(2 * 8 * 4, dtype=np.int32)
    sched = tc.build_block_schedule(stream, window=32, block_rows=4,
                                    device="cpu")
    big = tc.BlockSchedule(
        tags=torch.zeros((2, tc.PACK_LIMIT + 1), dtype=torch.int32),
        n_warps=sched.n_warps, elem_warp=sched.elem_warp,
        elem_offset=sched.elem_offset, elem_valid=sched.elem_valid,
        window=32, block_rows=4,
    )
    assert tsv.resolve_packing("auto", sched) is True
    assert tsv.resolve_packing("auto", big) is False
    with pytest.raises(ValueError, match="packed metadata"):
        tsv.resolve_packing(True, big)
    with pytest.raises(ValueError, match="window"):
        tsv.build_device_plan(sched, n_slices=2, cols_per_chunk=4,
                              slice_height=4)
    with pytest.raises(ValueError, match="tile"):
        tsv.build_device_plan(sched, n_slices=3, cols_per_chunk=8,
                              slice_height=4)
    plan = tsv.build_device_plan(sched, n_slices=2, cols_per_chunk=8,
                                 slice_height=4)
    values = torch.zeros((2, 8, 4))
    with pytest.raises(ValueError, match="block_rows"):
        tsv.sell_spmv_plain(None, values, torch.zeros(64), plan=plan)
    with pytest.raises(ValueError, match="packed"):
        tsv.sell_spmv_plain(None, values, torch.zeros(64), plan=plan,
                            block_rows=4, packed=False)
    with pytest.raises(ValueError, match="colidx is required"):
        tsv.sell_spmv_plain(None, values, torch.zeros(64), block_rows=4)
    with pytest.raises(ValueError, match="chunks of 3"):
        tsv.sell_spmv_plain(None, values, torch.zeros(64), cols_per_chunk=3,
                            plan=plan)
    for depth in (0, 9):
        with pytest.raises(ValueError, match="buffer_depth"):
            tsv.sell_spmv_plain(None, values, torch.zeros(64), plan=plan,
                                block_rows=4, buffer_depth=depth)


# -- plain versions against repro's interpret-mode Pallas kernels -------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sell_spmv_plain_matches_pallas(dtype):
    (jci, jva, jx), (tci, tva, tx) = _case(1, dtype)
    want = jsv.sell_spmv_pallas(jci, jva, jx, cols_per_chunk=4, block_rows=8,
                                interpret=True)
    got = ops.sell_spmv(tci, tva, tx, cols_per_chunk=4, block_rows=8)
    assert got.dtype == torch.float32
    _close(got, want)
    _close(got, ref.sell_spmv_ref(tci, tva.float(), tx))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k", [0, 1, 7, 8, 32])
def test_sell_spmm_plain_matches_pallas(k, dtype):
    (jci, jva, jX), (tci, tva, tX) = _case(2 + k, dtype, k=k)
    got = ops.sell_spmm(tci, tva, tX, cols_per_chunk=4, block_rows=8,
                        k_tile=8)
    assert got.shape == (48, k) and got.dtype == torch.float32
    want = sell_spmm_pallas(jci, jva, jX, cols_per_chunk=4, block_rows=8,
                            k_tile=8, interpret=True)
    assert want.shape == (48, k)
    _close(got, want)
    _close(got, ref.sell_spmm_ref(tci, tva.float(), tX))


@pytest.mark.parametrize("packed", [True, False])
def test_plain_versions_run_a_repro_schedule(packed):
    """A schedule planned by repro, carried over as numpy arrays, drives the
    port's plan lowering and plain kernels to repro's kernel results."""
    (jci, jva, jX), (tci, tva, tX) = _case(40, "f32", k=5)
    ja = jc.build_block_schedule(jci.reshape(-1), window=64, block_rows=8)
    tb = schedule_from_arrays(
        {f: np.asarray(getattr(ja, f)) for f in FIELDS}, window=64,
        block_rows=8, device="cpu",
    )
    geo = dict(cols_per_chunk=4, block_rows=8, packed=packed)
    want = sell_spmm_pallas(None, jva, jX, schedule=ja, k_tile=8,
                            interpret=True, **geo)
    got = sell_spmm_plain(None, tva, tX, schedule=tb, k_tile=8, **geo)
    _close(got, want)
    y = tsv.sell_spmv_plain(None, tva, tX[:, 0], schedule=tb, **geo)
    _close(y, np.asarray(want)[:, 0])


def test_plain_versions_agree_across_k_tiles_and_with_the_oracle():
    _, (tci, tva, tX) = _case(50, "f32", k=19)
    base = sell_spmm_plain(tci, tva, tX, cols_per_chunk=4, k_tile=19)
    for kt in (1, 4, 8, 64):
        _close(sell_spmm_plain(tci, tva, tX, cols_per_chunk=4, k_tile=kt),
               base)
    _close(base, ref.sell_spmm_ref(tci, tva, tX))
    rows = torch.tensor([5, 0, 63, 5])
    assert torch.equal(ref.coalesced_gather_ref(tX, rows), tX[[5, 0, 63, 5]])
    for j in (0, 18):
        _close(tsv.sell_spmv_plain(tci, tva, tX[:, j], cols_per_chunk=4),
               base[:, j])


# -- dispatch and launch geometry ---------------------------------------------


def test_ops_runs_plain_on_cpu_and_cuda_wrappers_refuse_cpu_tensors():
    _, (tci, tva, tX) = _case(60, "f32", k=3)
    before = (tsv.sell_spmv_cuda.launches, sell_spmm_cuda.launches)
    ops.sell_spmv(tci, tva, tX[:, 0], cols_per_chunk=4)
    ops.sell_spmm(tci, tva, tX, cols_per_chunk=4)
    assert (tsv.sell_spmv_cuda.launches, sell_spmm_cuda.launches) == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsv.sell_spmv_cuda(tci, tva, tX[:, 0], cols_per_chunk=4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sell_spmm_cuda(tci, tva, tX, cols_per_chunk=4)
    assert (tsv.sell_spmv_cuda.launches, sell_spmm_cuda.launches) == before


def test_launch_config_fits_shared_memory_and_threads():
    limit = 232448  # H100: 227 KB a block may opt into
    # banded spmv: 8 slices of 32 threads, all 9 warps staged at once
    assert tsv.launch_config(n_slices=31250, slice_height=32, k_tile=1,
                             max_warps=9, block_rows=8,
                             smem_limit=limit) == (8, 9, 8 * 9 * 8 * 4)
    # random spmm at k_tile 8: one 256-thread slice, 64 KB of wide blocks
    assert tsv.launch_config(n_slices=4096, slice_height=32, k_tile=8,
                             max_warps=256, block_rows=8,
                             smem_limit=limit) == (1, 256, 65536)
    # at k_tile 32 a window's tiles exceed the budget: staged in groups
    s, group, smem = tsv.launch_config(n_slices=4096, slice_height=32,
                                       k_tile=32, max_warps=256,
                                       block_rows=8, smem_limit=limit)
    assert (s, group) == (1, limit // (8 * 32 * 4)) and group < 256
    assert smem <= limit
    # few slices never give a block more slices than exist
    assert tsv.launch_config(n_slices=2, slice_height=8, k_tile=1,
                             max_warps=4, block_rows=8,
                             smem_limit=limit)[0] == 2
    with pytest.raises(ValueError, match="threads"):
        tsv.launch_config(n_slices=1, slice_height=32, k_tile=64,
                          max_warps=1, block_rows=8, smem_limit=limit)
    with pytest.raises(ValueError, match="shared-memory"):
        tsv.launch_config(n_slices=1, slice_height=1, k_tile=512,
                          max_warps=1, block_rows=256, smem_limit=limit)


def test_cuda_wrappers_check_the_plan_before_launching(monkeypatch):
    """With inputs that pass the device check, a malformed plan still
    raises before any kernel is built or launched."""
    stream = np.arange(2 * 8 * 4, dtype=np.int32)
    sched = tc.build_block_schedule(stream, window=32, block_rows=4,
                                    device="cpu")
    plan = tsv.build_device_plan(sched, n_slices=2, cols_per_chunk=8,
                                 slice_height=4)
    values, x = torch.zeros((2, 8, 4)), torch.zeros(64)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    bad = [
        tsv.DevicePlan(**{**plan.__dict__, "tags": plan.tags.to(torch.int64)}),
        tsv.DevicePlan(**{**plan.__dict__, "tags": plan.tags.t()}),
        tsv.DevicePlan(**{**plan.__dict__,
                          "elem_meta": plan.elem_meta[..., :16]}),
    ]
    for p in bad:
        with pytest.raises(ValueError, match="contiguous int32"):
            tsv.sell_spmv_cuda(None, values, x, plan=p, block_rows=4)
