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
    np.testing.assert_array_equal(   # repro's one chunk a window
        np.asarray(pa.elem_meta).reshape(pb.elem_meta.shape),
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


# The card the launch geometry is sized for in these tests: an H100's SMs and
# the shared memory a block may opt into.
N_SMS, SMEM_LIMIT = 132, 232448


def _config(**kw):
    kw.setdefault("n_sms", N_SMS)
    kw.setdefault("smem_limit", SMEM_LIMIT)
    return tg.gather_launch_config(**kw)


def test_launch_geometry_helpers():
    assert tg.gather_unit(65536, 256, 512) == 16
    assert tg.gather_unit(6, 256, 512) == 2  # D = 3 bf16
    assert tg.gather_unit(64, 256, 8) == 8  # an 8-byte aligned pointer
    # the paged shape: 5 windows of 64 KB rows, 4 tiles of 16 KB, 64 groups
    # a full window and 4 for the 16 elements of the last: about 4 items for
    # each of 2 x 132 blocks
    cfg = _config(n_out=1040, window=256, max_warps=256, block_rows=1,
                  row_bytes=65536, unit=16)
    assert (cfg.path, cfg.tile, cfg.n_tiles, cfg.depth) == ("bulk", 16384,
                                                           4, 4)
    assert (cfg.windows, cfg.groups_full, cfg.groups_last) == (5, 64, 4)
    assert cfg.items == (4 * 64 + 4) * 4 and cfg.grid == 2 * N_SMS
    assert (cfg.chunk, cfg.chunks) == (256, 1)  # one fan-out a window
    assert cfg.smem_bytes == tg.fanout_smem_bytes(
        chunk=256, max_warps=256, block_rows=1, depth=4, stage_bytes=16384)
    _, tb = _schedules(_stream(45), 8)
    plan = tg.build_gather_plan(tb)
    narrow = _config(n_out=75, window=WINDOW, max_warps=plan.max_warps,
                     block_rows=8, row_bytes=6, unit=2)
    assert (narrow.path, narrow.tile, narrow.n_tiles, narrow.depth) == (
        "unit", 3, 1, 0)
    assert narrow.smem_bytes == tg.fanout_smem_bytes(
        chunk=WINDOW, max_warps=plan.max_warps, block_rows=8)


@pytest.mark.parametrize("row_bytes,pointers,path", [
    (65536, (256, 512), "bulk"),  # a 64 KB page row
    (8192, (0, 256), "bulk"),  # a llama3-8b bf16 token row
    (4096, (16, 256), "bulk"),  # the narrowest bulk row, 16-byte bases
    (2048, (256, 256), "unit"),  # 16-byte aligned, too narrow to pay
    (6, (256, 512), "unit"),  # D = 3 bf16
    (132, (256, 512), "unit"),  # D = 33 f32
    (65536, (260, 512), "unit"),  # a view 4 bytes off
    (65536, (272, 512), "bulk"),  # a view 16 bytes off a 128-byte line
])
def test_launch_config_chooses_the_path_by_row_bytes_and_alignment(
        row_bytes, pointers, path):
    unit = tg.gather_unit(row_bytes, *pointers)
    kw = dict(n_out=700, window=256, max_warps=256, block_rows=8,
              row_bytes=row_bytes, unit=unit)
    cfg = _config(**kw)
    assert cfg.path == path
    if path == "bulk":
        assert cfg.unit == 16 and cfg.row_units == row_bytes
        assert cfg.tile % 16 == 0 and cfg.stage_bytes % 128 == 0
    else:
        assert cfg.unit == unit and cfg.row_units * unit == row_bytes
        assert cfg.depth == cfg.stage_bytes == 0
    assert _config(path="unit", **kw).path == "unit"  # always possible
    if unit == 16:
        assert _config(path="bulk", **kw).path == "bulk"
    else:
        with pytest.raises(ValueError, match="bulk path"):
            _config(path="bulk", **kw)


def _paged_stream(batch, pages, shared):
    """chip_smoke.paged_stream: `batch` requests of `pages` pages, the first
    `shared` common to all."""
    rows, nxt = [], shared
    for _ in range(batch):
        rows.append(np.concatenate([np.arange(shared),
                                    np.arange(nxt, nxt + pages - shared)]))
        nxt += pages - shared
    return np.concatenate(rows).astype(np.int32)


# Shapes (a), (b), (c) of chip_smoke.py's gather phase at full size: name ->
# (index stream, table rows, block_rows, row bytes, rows read by design).
FULL_SHAPES = {
    "a_paged_pool": (_paged_stream(16, 65, 0), 1040, 1, 65536, 1040),
    "b_shared_prefix": (_paged_stream(16, 65, 48), 1040, 1, 65536, 464),
    "c_token_table": (
        ((np.random.default_rng(12).zipf(1.1, 8192) - 1) % 128256).astype(
            np.int32), 128256, 8, 8192, None),
}


def _fanout(plan, n_out, n_rows, cfg):
    """A numpy model of the kernel's fan-out tables: {(window, chunk,
    group): [(source row or -1, output positions), ...]}, the group's keys
    in first-occurrence order. As in `csrc/coalesced_gather.cu`: a window
    is taken in chunks of `cfg.chunk` elements; a key is ``warp *
    block_rows + offset``; an element out of range is a key of its own; a
    key's bytes are one write per output plus one read if its row lies in
    the table, and it belongs to the group of G in which its share of the
    chunk's bytes starts."""
    tags = plan.tags.numpy().astype(np.int64)
    warps = plan.elem_warp.numpy().astype(np.int64)
    offsets = plan.elem_offset.numpy().astype(np.int64)
    br, win = plan.block_rows, plan.window
    groups = {}
    for w in range(cfg.windows):
        n_w = min(win, n_out - w * win)
        starts = range(0, n_w, cfg.chunk)
        for c, e0 in enumerate(starts):
            n = min(cfg.chunk, n_w - e0)
            ew, eo = warps[w, e0:e0 + n], offsets[w, e0:e0 + n]
            valid = (ew >= 0) & (ew < plan.max_warps) & (eo >= 0) & (eo < br)
            key = np.where(valid, ew * br + eo, -1)
            row = np.where(valid, tags[w, np.clip(ew, 0, plan.max_warps - 1)]
                           * br + eo, -1)
            row = np.where((row >= 0) & (row < n_rows), row, -1)
            e = np.arange(n)
            efirst = e.copy()
            _, first, inverse = np.unique(key[valid], return_index=True,
                                          return_inverse=True)
            efirst[valid] = e[valid][first][inverse]
            cnt = np.bincount(efirst, minlength=n)
            is_first = efirst == e
            weight = np.where(is_first, cnt + (is_first & (row >= 0)), 0)
            total = n + int((is_first & (row >= 0)).sum())
            last = w == cfg.windows - 1 and c == len(starts) - 1
            G = cfg.groups_last if last else cfg.groups_full
            grp = np.where(is_first,
                           (np.cumsum(weight) - weight) * G // total, -1)
            for g in range(G):
                groups[w, c, g] = [
                    (int(row[f]), np.flatnonzero(efirst == f) + w * win + e0)
                    for f in np.flatnonzero(grp == g)]
    return groups


def _window_slots(groups, w):
    """The (row, outputs) slots of window `w`, over its chunks and groups."""
    return [s for (gw, _, _), slots in sorted(
        groups.items(), key=lambda kv: kv[0]) if gw == w for s in slots]


@pytest.mark.parametrize("shape", sorted(FULL_SHAPES))
def test_items_cover_every_distinct_row_and_column_once(shape):
    """At shapes (a)-(c): every output is written once a column tile, each
    distinct row of a window is read once a tile, by one item, the tiles
    cover the row once, and the work items fill the card's SMs."""
    idx, n_rows, br, row_bytes, by_design = FULL_SHAPES[shape]
    sched = tc.build_block_schedule(idx, window=256, block_rows=br,
                                    device="cpu")
    plan = tg.build_gather_plan(sched)
    cfg = _config(n_out=len(idx), window=256, max_warps=plan.max_warps,
                  block_rows=br, row_bytes=row_bytes, unit=16)
    assert cfg.path == "bulk" and N_SMS <= cfg.items
    assert cfg.grid == min(cfg.items, 2 * N_SMS)
    cols = [(t * cfg.tile, min((t + 1) * cfg.tile, row_bytes))
            for t in range(cfg.n_tiles)]
    assert cols[0][0] == 0 and cols[-1][1] == row_bytes
    assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(cols, cols[1:]))
    assert cfg.chunk == 256  # one fan-out a window
    groups = _fanout(plan, len(idx), n_rows, cfg)
    assert cfg.items == len(groups) * cfg.n_tiles
    written = np.concatenate([out for slots in groups.values()
                              for _, out in slots])
    np.testing.assert_array_equal(np.sort(written), np.arange(len(idx)))
    reads = 0
    for w in range(cfg.windows):
        slots = _window_slots(groups, w)
        rows = [row for row, _ in slots]
        assert len(rows) == len(set(rows)) == len(np.unique(
            idx[w * 256:(w + 1) * 256]))
        reads += len(rows)
        for row, out in slots:
            assert (idx[out] == row).all()
    assert reads == (by_design or reads)
    assert reads == sum(len(np.unique(idx[i:i + 256]))
                        for i in range(0, len(idx), 256))


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("block_rows", [1, 8])
def test_fanout_model_matches_repro_schedule(block_rows, packed):
    """The fan-out of each window (its distinct keys and the outputs each
    feeds) is what `repro`'s schedule says: the keys are its (warp, offset)
    pairs, at block_rows 1 as many as its request warps."""
    idx = _stream(45)
    ja, tb = _schedules(idx, block_rows)
    plan = tg.build_gather_plan(tb, packed=packed)
    cfg = _config(n_out=len(idx), window=WINDOW, max_warps=plan.max_warps,
                  block_rows=block_rows, row_bytes=512, unit=16)
    groups = _fanout(plan, len(idx), 45, cfg)
    tags = np.asarray(ja.tags)
    ew, eo = np.asarray(ja.elem_warp), np.asarray(ja.elem_offset)
    valid = np.asarray(ja.elem_valid)
    for w in range(cfg.windows):
        slots = _window_slots(groups, w)
        want = {}
        for e in np.flatnonzero(valid[w]):
            row = int(tags[w, ew[w, e]]) * block_rows + int(eo[w, e])
            want.setdefault(row, []).append(w * WINDOW + e)
        assert {row: list(out) for row, out in slots} == want
        if block_rows == 1:
            assert len(slots) == int(np.asarray(ja.n_warps)[w])


@pytest.mark.parametrize("n_last", [1, 16, 100, 256])
def test_partial_last_window_gets_work_in_proportion(n_last):
    """The last window's groups follow its share of a full window's
    elements (the paged shape's 5th window holds 16)."""
    cfg = _config(n_out=4 * 256 + n_last, window=256, max_warps=256,
                  block_rows=1, row_bytes=65536, unit=16)
    assert cfg.groups_last == max(1, -(-cfg.groups_full * n_last // 256))
    assert abs(cfg.groups_last / cfg.groups_full - n_last / 256) <= (
        1 / cfg.groups_full)
    assert cfg.items == (4 * cfg.groups_full + cfg.groups_last) * cfg.n_tiles


def _paged_smem(depth, stage_bytes=16384):
    """Shared memory of the paged shape's block: the fan-out tables of a
    256-element window and 256 keys beside a ring of `depth` stages."""
    return tg.fanout_smem_bytes(chunk=256, max_warps=256, block_rows=1,
                                depth=depth, stage_bytes=stage_bytes)


@pytest.mark.parametrize("slack", [0, 100])
@pytest.mark.parametrize("depth", [2, 3, 4])
def test_ring_shared_memory_grows_with_depth_under_the_limit(depth, slack):
    """Where shared memory is short the ring loses stages, down to 2, before
    its tiles narrow; each stage costs its bytes and its barrier."""
    limit = _paged_smem(depth) + slack
    cfg = _config(n_out=1040, window=256, max_warps=256, block_rows=1,
                  row_bytes=65536, unit=16, smem_limit=limit)
    assert (cfg.depth, cfg.tile, cfg.chunk) == (depth, tg.MAX_TILE_BYTES, 256)
    assert cfg.smem_bytes == _paged_smem(depth) <= limit
    if depth > 2:
        assert _paged_smem(depth) - _paged_smem(depth - 1) in (16384,
                                                              16384 + 16)
    if depth < 4:
        assert _paged_smem(depth + 1) > limit  # a stage more does not fit


def test_ring_tiles_narrow_below_the_smallest_ring():
    limit = _paged_smem(2) - 1
    cfg = _config(n_out=1040, window=256, max_warps=256, block_rows=1,
                  row_bytes=65536, unit=16, smem_limit=limit)
    assert cfg.tile < tg.MAX_TILE_BYTES and cfg.smem_bytes <= limit
    assert cfg.depth >= tg.MIN_GATHER_DEPTH and cfg.chunk == 256
    assert cfg.n_tiles * cfg.tile >= 65536 > (cfg.n_tiles - 1) * cfg.tile


@pytest.mark.parametrize("row_bytes,depth", [
    (65536, 4),  # 16 KB stages: 3 loading while one is stored
    (8192, 7),  # 8 KB rows of llama3-8b's bf16 token table
    (512, 8),  # the deepest ring
])
def test_ring_depth_keeps_the_bytes_in_flight(row_bytes, depth):
    kw = dict(n_out=1040, window=256, max_warps=256, block_rows=1,
              row_bytes=row_bytes, unit=16)
    cfg = _config(path="bulk", **kw)
    assert cfg.depth == depth
    assert (cfg.depth - 1) * cfg.stage_bytes <= max(
        tg.IN_FLIGHT_BYTES, tg.MIN_GATHER_DEPTH * cfg.stage_bytes)
    assert _config(path="unit", **kw).depth == 0


# Long windows: (window, max_warps, block_rows, row bytes, path, chunked).
LONG_WINDOWS = [
    (2500, 2500, 4, 512, "unit", False),  # 10,000 keys, one fan-out
    (4500, 4500, 1, 65536, "bulk", True),  # too long for one fan-out
    (5000, 5000, 8, 16384, "bulk", True),  # 40,000 keys: a 2-stage ring
    (12000, 12000, 1, 16384, "bulk", True),
    (20000, 20000, 1, 48, "unit", True),
]


@pytest.mark.parametrize("window,max_warps,block_rows,row_bytes,path,chunked",
                         LONG_WINDOWS)
def test_long_windows_are_taken_in_element_chunks(
        window, max_warps, block_rows, row_bytes, path, chunked):
    """A window whose per-element tables do not fit beside the ring is
    taken in the longest chunks that do; only its keys and tags must fit
    whole."""
    n_out = 2 * window + 700
    cfg = _config(n_out=n_out, window=window, max_warps=max_warps,
                  block_rows=block_rows, row_bytes=row_bytes, unit=16)
    assert cfg.path == path and cfg.smem_bytes <= SMEM_LIMIT
    assert (cfg.chunk < window) == chunked
    assert cfg.chunk >= min(window, tg.MIN_CHUNK)
    assert cfg.chunks == -(-window // cfg.chunk)
    ring = dict(max_warps=max_warps, block_rows=block_rows, depth=cfg.depth,
                stage_bytes=cfg.stage_bytes)
    assert cfg.smem_bytes == tg.fanout_smem_bytes(chunk=cfg.chunk, **ring)
    if chunked:  # the longest chunk that fits
        assert tg.fanout_smem_bytes(chunk=cfg.chunk + 1, **ring) > SMEM_LIMIT
    n_chunks = 2 * cfg.chunks + -(-700 // cfg.chunk)
    assert cfg.items == ((n_chunks - 1) * cfg.groups_full
                         + cfg.groups_last) * cfg.n_tiles
    if (window, block_rows) == (5000, 8):
        assert cfg.depth == tg.MIN_GATHER_DEPTH


@pytest.mark.parametrize("chunk", [256, 400, 999])
@pytest.mark.parametrize("block_rows", [1, 4])
def test_items_cover_every_output_once_in_chunks(block_rows, chunk):
    """A long window taken in chunks (a shared-memory limit that fits the
    tables of `chunk` elements beside the ring forces them): every output
    is written once, each distinct row is read once a chunk, and each
    chunk's slots are its distinct (warp, offset) keys."""
    idx = np.random.default_rng(23).integers(0, 3000, 2 * 1000 + 301)
    sched = tc.build_block_schedule(idx.astype(np.int32), window=1000,
                                    block_rows=block_rows, device="cpu")
    plan = tg.build_gather_plan(sched)
    smem_limit = tg.fanout_smem_bytes(
        chunk=chunk, max_warps=plan.max_warps, block_rows=block_rows,
        depth=8, stage_bytes=512)
    cfg = _config(n_out=len(idx), window=1000, max_warps=plan.max_warps,
                  block_rows=block_rows, row_bytes=512, unit=16,
                  smem_limit=smem_limit, path="bulk")
    assert (cfg.depth, cfg.chunk, cfg.chunks) == (8, chunk, -(-1000 // chunk))
    assert cfg.smem_bytes == smem_limit
    groups = _fanout(plan, len(idx), 3000, cfg)
    assert cfg.items == len(groups) * cfg.n_tiles
    written = np.concatenate([out for slots in groups.values()
                              for _, out in slots])
    np.testing.assert_array_equal(np.sort(written), np.arange(len(idx)))
    for w in range(cfg.windows):
        for e0 in range(0, min(1000, len(idx) - w * 1000), cfg.chunk):
            lo = w * 1000 + e0
            hi = min(lo + cfg.chunk, (w + 1) * 1000, len(idx))
            slots = [s for (gw, c, _), sl in groups.items()
                     if gw == w and c == e0 // cfg.chunk for s in sl]
            assert sorted(row for row, _ in slots) == sorted(
                np.unique(idx[lo:hi]).tolist())
            for row, out in slots:
                assert (idx[out] == row).all()


@pytest.mark.parametrize("kw,match", [
    (dict(window=65536, max_warps=65536), "fan-out tables"),  # too many keys
    (dict(window=2500, max_warps=2500, block_rows=64), "fan-out tables"),
    (dict(unit=4, path="bulk"), "bulk path"),  # a misaligned view
    (dict(window=60000, max_warps=29100, path="unit"), "fan-out tables"),
    (dict(window=60000, max_warps=28000), "a ring of 2 stages of 16 bytes"),
    (dict(path="fast"), "path"),
    (dict(window=0), "window"),
    (dict(smem_limit=_paged_smem(0) + 200),
     "a ring of 2 stages of 16 bytes"),  # the tables fit, no ring beside
])
def test_launch_config_raises_where_it_does_not_fit(kw, match):
    args = dict(n_out=1040, window=256, max_warps=256, block_rows=1,
                row_bytes=65536, unit=16)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        _config(**args)
    if kw.get("max_warps") == 28000:  # the unit path needs no ring
        assert _config(**dict(args, path="unit")).chunk >= 1
