"""The port's gather kernel module against `repro`'s: gather plans exactly
equal in both encodings, `coalesced_gather_plain` bit-equal to `repro`'s
Pallas kernel run in interpret mode on finite tables and to ``table[idx]``
on every table, and the same plan-resolution errors. The CUDA kernel is held
to the plain version on the card (tests/test_torch_gpu.py, chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coalescer as jc
from repro.kernels import coalesced_gather as jg
from repro_torch.core import coalescer as tc
from repro_torch.core.engine import clear_engine_cache, clear_schedule_cache
from repro_torch.core.gather_engine import clear_gather_engine_cache
from repro_torch.kernels import coalesced_gather as tg
from repro_torch.kernels import ops

WINDOW = 32


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    clear_engine_cache()
    clear_schedule_cache()
    clear_gather_engine_cache()
    yield


# jitted: eager op-by-op dispatch of the vmapped planner costs seconds a call
_repro_build = jax.jit(jc.build_block_schedule,
                       static_argnames=("window", "block_rows", "max_warps"))


def _stream(n_rows, n=75, seed=0):
    """75 ids over n_rows rows: repeats, and a partial last window of 11."""
    return np.random.default_rng(seed).integers(0, n_rows, n).astype(np.int32)


def _schedules(idx, block_rows):
    kw = dict(window=WINDOW, block_rows=block_rows)
    return (_repro_build(jnp.asarray(idx), **kw),
            tc.build_block_schedule(idx, **kw, device="cpu"))


def _bits(a):
    """An array's raw bits as unsigned integers (numpy, torch or jax)."""
    if torch.is_tensor(a):
        width = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                 8: torch.int64}[a.element_size()]
        a = a.contiguous().view(width).numpy()
    a = np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}")


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("block_rows", [1, 8])
def test_gather_plan_arrays_equal_repro(packed, block_rows):
    ja, tb = _schedules(_stream(45), block_rows)
    pa = jg.build_gather_plan(ja, packed=packed)
    pb = tg.build_gather_plan(tb, packed=packed)
    assert pb.packed == pa.packed == packed
    assert (pb.n_slices, pb.n_chunks, pb.window, pb.cols_per_chunk,
            pb.slice_height) == (pa.n_slices, pa.n_chunks, pa.window,
                                 pa.cols_per_chunk, pa.slice_height)
    np.testing.assert_array_equal(np.asarray(pa.tags), pb.tags.numpy())
    np.testing.assert_array_equal(np.asarray(pa.elem_meta),
                                  pb.elem_meta.numpy())


@pytest.mark.parametrize("block_rows,n_rows", [(1, 40), (8, 45)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_bit_equal_to_repro_interpret_kernel(dtype, block_rows,
                                                   n_rows):
    """Finite table, repeated ids, partial last window; block_rows 8 with a
    row count that is not a multiple of it."""
    table = np.random.default_rng(1).standard_normal((n_rows, 5)).astype(
        np.float32)
    idx = _stream(n_rows)
    jt = jnp.asarray(table).astype(
        {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype])
    tt = torch.as_tensor(table).to(
        {"f32": torch.float32, "bf16": torch.bfloat16}[dtype])
    want = jg.coalesced_gather_pallas(
        jt, jnp.asarray(idx), window=WINDOW, block_rows=block_rows,
        interpret=True)
    _, tb = _schedules(idx, block_rows)
    plan = tg.build_gather_plan(tb)
    got = tg.coalesced_gather_plain(tt, None, window=WINDOW,
                                    block_rows=block_rows, plan=plan,
                                    n_out=len(idx))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(tt[idx]))


def test_plain_is_table_indexing_on_non_finite_tables():
    """-0.0, inf and nan come back as they are. The JAX kernel extracts rows
    with a one-hot matmul and does not: -0.0 + 0.0 gives +0.0, and an inf in
    a block fetched for a window gives 0 * inf = nan in that column of every
    other row of the window. The port keeps the documented semantics,
    ``table[indices]``."""
    table = np.random.default_rng(2).standard_normal((16, 3)).astype(
        np.float32)
    table[3, 0] = -0.0
    table[7, 1] = np.inf
    table[9, 2] = np.nan
    idx = np.array([3, 5, 9, 7, 12, 1, 3, 3, 15, 0], np.int32)
    tt = torch.as_tensor(table)
    for block_rows in (1, 8):
        for packed in (True, False):
            got = tg.coalesced_gather_plain(tt, idx, window=8,
                                            block_rows=block_rows,
                                            packed=packed)
            np.testing.assert_array_equal(_bits(got), _bits(table[idx]))
    jax_out = np.asarray(jg.coalesced_gather_pallas(
        jnp.asarray(table), jnp.asarray(idx), window=8, block_rows=1,
        interpret=True))
    assert not np.signbit(jax_out[0, 0])  # -0.0 came back as +0.0
    assert np.isnan(jax_out[1, 1])  # row 5 caught row 7's inf as nan


def test_rows_past_the_table_read_as_zeros():
    """A plan whose block spans past the last row (rows 8..15 of a 12-row
    table at block_rows 8) reads those rows as zeros, as the kernel does."""
    arrays = dict(tags=np.array([[1]], np.int32), n_warps=np.ones(1, np.int32),
                  elem_warp=np.zeros((1, 4), np.int32),
                  elem_offset=np.array([[0, 3, 4, 7]], np.int32),
                  elem_valid=np.ones((1, 4), bool))
    sched = tc.BlockSchedule(**{k: torch.as_tensor(v)
                                for k, v in arrays.items()},
                             window=4, block_rows=8)
    table = torch.arange(12 * 2, dtype=torch.float32).reshape(12, 2) + 1
    got = tg.coalesced_gather_plain(table, None, window=4, block_rows=8,
                                    plan=tg.build_gather_plan(sched))
    want = torch.stack([table[8], table[11], torch.zeros(2), torch.zeros(2)])
    assert torch.equal(got, want)


def _raise_message(fn):
    with pytest.raises(ValueError) as exc:
        fn()
    return str(exc.value)


def test_resolve_gather_plan_raises_the_same_errors():
    idx = _stream(45)
    ja, tb = _schedules(idx, 8)
    pa, pb = jg.build_gather_plan(ja), tg.build_gather_plan(tb)
    cases = [
        dict(window=64, block_rows=8),  # window of the plan
        dict(window=WINDOW, block_rows=4),  # block_rows of the plan
        dict(window=WINDOW, block_rows=8, packed=False),  # encoding
    ]
    for kw in cases:
        assert _raise_message(
            lambda: tg.resolve_gather_plan(None, plan=pb, **kw)
        ) == _raise_message(
            lambda: jg.resolve_gather_plan(None, plan=pa, **kw))
    for kw in (dict(window=64, block_rows=8), dict(window=WINDOW,
                                                    block_rows=4)):
        assert _raise_message(
            lambda: tg.resolve_gather_plan(None, schedule=tb, **kw)
        ) == _raise_message(
            lambda: jg.resolve_gather_plan(None, schedule=ja, **kw))
    assert _raise_message(
        lambda: tg.resolve_gather_plan(None, window=WINDOW, block_rows=8)
    ) == _raise_message(
        lambda: jg.resolve_gather_plan(None, window=WINDOW, block_rows=8))
    table = torch.zeros((45, 2))
    with pytest.raises(ValueError, match="does not fit"):
        tg.coalesced_gather_plain(table, None, window=WINDOW, block_rows=8,
                                  plan=pb, n_out=3 * WINDOW + 1)


def test_ops_dispatch_and_the_kernel_wrapper_on_cpu():
    """A CPU table takes the plain version (the launch count stays); the
    CUDA wrapper raises on it instead of running anything."""
    table = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (45, 4)).astype(np.float32))
    idx = _stream(45)
    before = tg.coalesced_gather_cuda.launches
    got = ops.coalesced_gather(table, idx, window=WINDOW, block_rows=8)
    assert torch.equal(got, table[idx])
    assert tg.coalesced_gather_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        tg.coalesced_gather_cuda(table, idx, window=WINDOW, block_rows=8)


def test_launch_geometry_helpers():
    assert tg.gather_unit(65536, 256, 512) == 16
    assert tg.gather_unit(6, 256, 512) == 2  # D = 3 bf16
    assert tg.gather_unit(64, 256, 8) == 8  # an 8-byte aligned pointer
    # the paged shape: 5 windows of 4,096 16-byte units -> 32-unit tiles
    assert tg.gather_tile_units(5, 4096, 132) == 32
    assert tg.gather_tile_units(1, 3, 132) == 3  # a narrow row: one tile
    _, tb = _schedules(_stream(45), 8)
    plan = tg.build_gather_plan(tb)
    assert tg.gather_smem_bytes(plan) == WINDOW * 8 + plan.max_warps * 4
