"""The port's CUDA kernels against their plain torch versions, on the card.

Marked `gpu`: each test asks for the `cuda` fixture, which skips with a
reason when torch finds no CUDA device. The file imports neither JAX nor
the JAX package, so it also runs where JAX is absent:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_gpu.py

Tolerance: ``|kernel - plain| <= 1e-5 + 1e-5 * |plain|`` elementwise for the
SELL kernels — both sum the same float32 products in different orders (and
the kernel may fuse multiply-adds). The gather copies bytes: it must equal
its plain version and ``table[idx]`` bitwise.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import matrices
from repro_torch.core.engine import SpMVEngine, cached_block_schedule, \
    clear_engine_cache, clear_schedule_cache
from repro_torch.core.gather_engine import clear_gather_engine_cache
from repro_torch.core.runtime import normalize_to_sell, pad_width
from repro_torch.core.spmv import _sell_padded
from repro_torch.kernels import _build, ops
from repro_torch.core.coalescer import BlockSchedule
from repro_torch.kernels.coalesced_gather import build_gather_plan, \
    coalesced_gather_cuda, coalesced_gather_plain, gather_launch_config, \
    gather_unit
from repro_torch.kernels.sell_spmm import sell_spmm_cuda, sell_spmm_plain
from repro_torch.kernels.sell_spmv import build_device_plan, launch_config, \
    sell_spmv_cuda, sell_spmv_plain

pytestmark = pytest.mark.gpu

ATOL = RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    clear_engine_cache()
    clear_schedule_cache()
    clear_gather_engine_cache()
    yield torch.device("cuda", torch.cuda.current_device())


def _plan_case(csr, *, cpc, block_rows, packed, device):
    """(values f64 numpy (n_slices, W, H), DevicePlan on `device`)."""
    sell = normalize_to_sell(csr)
    ci, va, _ = _sell_padded(sell)
    ci, va, W = pad_width(ci, va, multiple=cpc)
    sched, _ = cached_block_schedule(
        ci.reshape(-1), window=cpc * sell.slice_height,
        block_rows=block_rows, device=device,
    )
    plan = build_device_plan(
        sched, n_slices=sell.n_slices, cols_per_chunk=cpc,
        slice_height=sell.slice_height, packed=packed,
    )
    return va, plan


def _close(got, want):
    err = (got - want).abs()
    assert torch.all(err <= ATOL + RTOL * want.abs()), float(err.max())


CASES = {
    "banded": lambda: matrices.banded(3000, 24, 0.8)(seed=1),
    "random": lambda: matrices.random_uniform(16384, 16)(seed=2),
}


@pytest.mark.parametrize("family", sorted(CASES))
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_sell_spmv_kernel_matches_plain(cuda, family, packed, dtype, depth):
    csr = CASES[family]()
    va, plan = _plan_case(csr, cpc=8, block_rows=8, packed=packed,
                          device=cuda)
    rng = np.random.default_rng(3)
    values = torch.as_tensor(va).to(dtype).to(cuda)
    x = torch.as_tensor(rng.standard_normal(csr.n_cols).astype(np.float32),
                        device=cuda)
    before = sell_spmv_cuda.launches
    y = ops.sell_spmv(None, values, x, plan=plan, cols_per_chunk=8,
                      buffer_depth=depth)
    torch.cuda.synchronize()
    assert sell_spmv_cuda.launches == before + 1
    _close(y, sell_spmv_plain(None, values, x, plan=plan, cols_per_chunk=8))


@pytest.mark.parametrize("k", [1, 7, 8, 32, 33, 64, 65, 128, 200])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_sell_spmm_kernel_matches_plain(cuda, k, packed, dtype, depth):
    """Every k the column tile meets: one column (k = 1), k not a multiple
    of 4 or 8 (7, 33, 65: 4-byte copies, masked columns), k = 8, the
    streamed micro-batch's 32 and the sync path's 64 (whole rows in 16-byte
    pieces), one full 128-column tile, and k = 200 (two tiles)."""
    va, plan = _plan_case(CASES["banded"](), cpc=4, block_rows=8,
                          packed=packed, device=cuda)
    rng = np.random.default_rng(4)
    values = torch.as_tensor(va).to(dtype).to(cuda)
    X = torch.as_tensor(rng.standard_normal((3000, k)).astype(np.float32),
                        device=cuda)
    before = sell_spmm_cuda.launches
    Y = ops.sell_spmm(None, values, X, plan=plan, cols_per_chunk=4, k_tile=8,
                      buffer_depth=depth)
    torch.cuda.synchronize()
    assert sell_spmm_cuda.launches == before + 1
    _close(Y, sell_spmm_plain(None, values, X, plan=plan, cols_per_chunk=4,
                              k_tile=8))


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_sell_spmm_stages_large_windows_in_groups(cuda, depth):
    """A random plan at k = 64 needs more shared memory per window than a
    stage of the ring may take, so the kernel stages each window in groups
    of warps, one step of the ring a group."""
    va, plan = _plan_case(CASES["random"](), cpc=8, block_rows=8,
                          packed=True, device=cuda)
    values = torch.as_tensor(va).to(torch.float32).to(cuda)
    cfg = launch_config(
        n_slices=plan.n_slices, slice_height=plan.slice_height, k=64,
        cols_per_thread=8, max_warps=plan.max_warps, block_rows=8,
        cols_per_chunk=8, value_bytes=4, packed=True, buffer_depth=depth,
        smem_limit=_build.max_dynamic_smem(cuda),
    )
    assert cfg.group < plan.max_warps  # the multi-step path
    rng = np.random.default_rng(5)
    X = torch.as_tensor(rng.standard_normal((16384, 64)).astype(np.float32),
                        device=cuda)
    Y = sell_spmm_cuda(None, values, X, plan=plan, buffer_depth=depth)
    torch.cuda.synchronize()
    _close(Y, sell_spmm_plain(None, values, X, plan=plan))


def _offset_view(t, shift):
    """A contiguous copy of `t` whose storage starts `shift` elements into a
    larger buffer: an address not aligned to 16 bytes."""
    buf = torch.empty(t.numel() + shift, dtype=t.dtype, device=t.device)
    view = buf[shift:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_stage_unaligned_inputs(cuda, dtype):
    """Values and X at addresses that are not 16-byte aligned: the windows'
    values are staged in 4-byte (f32) or 2-byte (bf16) pieces and X in
    4-byte pieces, with the same result."""
    va, plan = _plan_case(CASES["banded"](), cpc=8, block_rows=8,
                          packed=True, device=cuda)
    values = _offset_view(torch.as_tensor(va).to(dtype).to(cuda), 1)
    rng = np.random.default_rng(10)
    X = _offset_view(torch.as_tensor(rng.standard_normal((3000, 64)).astype(
        np.float32), device=cuda), 1)
    assert values.data_ptr() % 16 and X.data_ptr() % 16
    _close(sell_spmm_cuda(None, values, X, plan=plan),
           sell_spmm_plain(None, values, X, plan=plan))
    _close(sell_spmv_cuda(None, values, X[:, 3].contiguous(), plan=plan),
           sell_spmv_plain(None, values, X[:, 3], plan=plan))
    torch.cuda.synchronize()


@pytest.mark.parametrize("k", [7, 64])
@pytest.mark.parametrize("block_rows", [7, 8])
def test_kernels_zero_fill_past_the_last_row_of_x(cuda, k, block_rows):
    """2,999 columns: the last wide block of x/X is partial (or, at
    block_rows 7, every block is a 7-row tile copied in 4-byte pieces), and
    its rows past n_cols read as 0."""
    csr = matrices.banded(2999, 24, 0.8)(seed=11)
    va, plan = _plan_case(csr, cpc=8, block_rows=block_rows, packed=True,
                          device=cuda)
    values = torch.as_tensor(va).to(torch.float32).to(cuda)
    rng = np.random.default_rng(12)
    X = torch.as_tensor(rng.standard_normal((2999, k)).astype(np.float32),
                        device=cuda)
    kw = dict(plan=plan, block_rows=block_rows)
    _close(sell_spmm_cuda(None, values, X, **kw),
           sell_spmm_plain(None, values, X, **kw))
    x = X[:, 0].contiguous()
    _close(sell_spmv_cuda(None, values, x, **kw),
           sell_spmv_plain(None, values, x, **kw))
    torch.cuda.synchronize()


def test_kernels_raise_where_launch_config_refuses(cuda):
    """A geometry the kernel cannot take raises before any launch; it never
    falls back to the plain version."""
    va, plan = _plan_case(CASES["banded"](), cpc=8, block_rows=16384,
                          packed=True, device=cuda)
    values = torch.as_tensor(va).to(torch.float32).to(cuda)
    X = torch.zeros((3000, 64), device=cuda)
    before = (sell_spmv_cuda.launches, sell_spmm_cuda.launches)
    with pytest.raises(ValueError, match="shared-memory"):
        ops.sell_spmm(None, values, X, plan=plan, block_rows=16384)
    with pytest.raises(ValueError, match="shared-memory"):
        sell_spmv_cuda(None, values, X[:, 0].contiguous(), plan=plan,
                       block_rows=16384, buffer_depth=8)
    assert (sell_spmv_cuda.launches, sell_spmm_cuda.launches) == before


def test_kernel_rejects_cpu_and_wrong_dtypes(cuda):
    va, plan = _plan_case(CASES["banded"](), cpc=8, block_rows=8,
                          packed=True, device=cuda)
    values = torch.as_tensor(va).to(torch.float32)
    x = torch.zeros(3000)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sell_spmv_cuda(None, values, x, plan=plan)
    with pytest.raises(TypeError, match="float32"):
        sell_spmv_cuda(None, values.double().to(cuda), x.to(cuda), plan=plan)


def test_engine_cuda_backend_matches_reference_on_card(cuda):
    csr = CASES["banded"]()
    rng = np.random.default_rng(6)
    X = rng.standard_normal((csr.n_cols, 9)).astype(np.float32)
    eng = SpMVEngine(csr, backend="auto", device=cuda)
    ref = SpMVEngine(csr, backend="reference", device=cuda)
    assert eng.backend_resolved == "cuda"
    _close(eng.matmat(X), ref.matmat(X))
    _close(eng.matvec(X[:, 0]), ref.matvec(X[:, 0]))
    _close(eng.matmat_vmapped(X), ref.matmat(X))


def _bytes(t):
    return t.contiguous().view(-1).view(torch.uint8)


def _paged_stream(batch, pages, shared):
    rows, nxt = [], shared
    for _ in range(batch):
        rows.append(np.concatenate([np.arange(shared),
                                    np.arange(nxt, nxt + pages - shared)]))
        nxt += pages - shared
    return np.concatenate(rows).astype(np.int32)


def _special_table(gen, device):
    t = torch.randn((50, 9), generator=gen, device=device)
    t[3, 1] = float("inf")
    t[7, 5] = -0.0
    t[9] = float("nan")
    t[11, ::2] = float("-inf")
    return t


# Cases (a)-(e) of chip_smoke.py's gather phase, at a small size: name ->
# (table maker (generator, device), index stream, block_rows).
GATHER_CASES = {
    "a_pages": (lambda g, d: torch.randn((4 * 9, 2 * 4 * 16), generator=g,
                                         device=d),
                _paged_stream(4, 9, 0), 1),
    "b_shared_prefix": (lambda g, d: torch.randn((4 * 9, 2 * 4 * 16),
                                                 generator=g, device=d),
                        _paged_stream(4, 9, 5), 1),
    "c_tokens_bf16": (lambda g, d: torch.randn((1000, 64), generator=g,
                                               device=d).to(torch.bfloat16),
                      ((np.random.default_rng(1).zipf(1.1, 700) - 1)
                       % 1000).astype(np.int32), 8),
    "d_narrow_bf16": (lambda g, d: torch.randn((101, 3), generator=g,
                                               device=d).to(torch.bfloat16),
                      np.random.default_rng(2).integers(0, 101, 300), 8),
    "e_specials": (_special_table, np.random.default_rng(3).integers(
        0, 50, 300), 8),
}


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_coalesced_gather_kernel_matches_plain_bitwise(cuda, case, packed):
    make, idx, br = GATHER_CASES[case]
    table = make(torch.Generator(device=cuda).manual_seed(7), cuda)
    sched, _ = cached_block_schedule(idx, window=64, block_rows=br,
                                     device=cuda)
    plan = build_gather_plan(sched, packed=packed)
    kw = dict(window=64, block_rows=br, plan=plan, n_out=len(idx))
    before = coalesced_gather_cuda.launches
    got = ops.coalesced_gather(table, None, **kw)
    torch.cuda.synchronize()
    assert coalesced_gather_cuda.launches == before + 1
    assert torch.equal(_bytes(got), _bytes(coalesced_gather_plain(
        table, None, **kw)))
    want = table[torch.as_tensor(idx, device=cuda).long()]
    assert torch.equal(_bytes(got), _bytes(want))


def test_serve_paged_full_width_heads_on_card(cuda):
    """llama3-8b's heads and head_dim (one short decode) through the gather
    kernel on the card: parity with dense SDPA and no steady-state builds."""
    from repro_torch.launch import serve

    args = serve.build_parser().parse_args(
        ["--arch", "llama3-8b", "--paged", "--batch", "2", "--prompt-len",
         "40", "--decode-steps", "3", "--page-block", "16"])
    before = coalesced_gather_cuda.launches
    out = serve.run(args)
    assert coalesced_gather_cuda.launches - before == 2 * 32 * 3
    assert out["max_err"] <= 1e-5 and out["builds_warm"] == 0
    assert out["caches"][0].k_pages.is_cuda
    assert out["reports"][0]["backend_resolved"] == "cuda"


def _config_of(table, plan, n_out, path="auto"):
    """The launch geometry `coalesced_gather_cuda` takes for this call."""
    row_bytes = table.shape[1] * table.element_size()
    return gather_launch_config(
        n_out=n_out, window=plan.window, max_warps=plan.max_warps,
        block_rows=plan.block_rows, row_bytes=row_bytes,
        unit=gather_unit(row_bytes, table.data_ptr()), path=path,
        n_sms=torch.cuda.get_device_properties(
            table.device).multi_processor_count,
        smem_limit=_build.max_dynamic_smem(table.device))


def test_coalesced_gather_stages_long_windows_in_chunks(cuda):
    """Long windows and a partial last window; 48-byte rows take the unit
    path. 2,500 elements at block_rows 4 (up to 10,000 keys) fit one
    fan-out a window; 12,000 at block_rows 1 are taken in element chunks."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    for window, block_rows, n_rows in ((2500, 4, 5000), (12000, 1, 40000)):
        table = torch.randn((n_rows, 12), generator=gen, device=cuda)
        idx = np.random.default_rng(9).integers(0, n_rows, 2 * window + 700)
        sched, _ = cached_block_schedule(idx, window=window,
                                         block_rows=block_rows, device=cuda)
        plan = build_gather_plan(sched)
        cfg = _config_of(table, plan, len(idx))
        assert cfg.path == "unit"
        assert (cfg.chunk < window) == (window == 12000)
        got = coalesced_gather_cuda(table, None, window=window,
                                    block_rows=block_rows, plan=plan,
                                    n_out=len(idx))
        torch.cuda.synchronize()
        assert torch.equal(got, table[torch.as_tensor(
            idx, device=cuda).long()])


def _gather_both(table, idx, *, window, block_rows, paths=("bulk", "unit")):
    """The kernel on each path against the plain version and table[idx],
    bitwise; returns the outputs by path."""
    sched, _ = cached_block_schedule(idx, window=window, block_rows=block_rows,
                                     device=table.device)
    plan = build_gather_plan(sched)
    kw = dict(window=window, block_rows=block_rows, plan=plan, n_out=len(idx))
    want = table[torch.as_tensor(idx, device=table.device).long()]
    plain = coalesced_gather_plain(table, None, **kw)
    outs = {}
    for path in paths:
        got = coalesced_gather_cuda(table, None, path=path, **kw)
        torch.cuda.synchronize()
        assert torch.equal(_bytes(got), _bytes(plain)), path
        assert torch.equal(_bytes(got), _bytes(want)), path
        outs[path] = got
    return outs, plan


@pytest.mark.parametrize("case", ["a_pages", "b_shared_prefix",
                                  "c_tokens_bf16"])
def test_coalesced_gather_both_paths_on_the_same_data(cuda, case):
    make, idx, br = GATHER_CASES[case]
    table = make(torch.Generator(device=cuda).manual_seed(7), cuda)
    _gather_both(table, idx, window=64, block_rows=br)


@pytest.mark.parametrize("row_floats,depth", [
    (128, 8),  # 512-byte rows: more items than blocks, 300 windows
    (2048, 7),  # 8 KB rows
    (16384, 4),  # 64 KB rows in 4 tiles of 16 KB
])
def test_coalesced_gather_ring_runs_on_across_items(cuda, row_floats, depth):
    """Many items a block: the ring's stages and barrier phases carry over
    from item to item, at the depth each row width gives."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    n_rows = {128: 19200, 2048: 4800, 16384: 600}[row_floats]
    table = torch.randn((n_rows, row_floats), generator=gen, device=cuda)
    idx = np.random.default_rng(13).integers(0, n_rows, n_rows + 17)
    _, plan = _gather_both(table, idx.astype(np.int32), window=64,
                           block_rows=1)
    cfg = _config_of(table, plan, len(idx), path="bulk")
    assert cfg.depth == depth and cfg.items > cfg.grid


def test_coalesced_gather_two_stage_ring_in_chunks(cuda):
    """40,000 keys a window (5,000 distinct blocks of 8 rows): the key
    table leaves room for a ring of 2 stages of 16 KB, and the window is
    taken in element chunks; both paths."""
    rng = np.random.default_rng(22)
    idx = np.concatenate([rng.permutation(5000) * 8 + rng.integers(0, 8, 5000)
                          for _ in range(3)])[:12000].astype(np.int32)
    table = torch.randn((40000, 4096), generator=torch.Generator(
        device=cuda).manual_seed(23), device=cuda)
    _, plan = _gather_both(table, idx, window=5000, block_rows=8)
    cfg = _config_of(table, plan, len(idx))
    assert (cfg.path, cfg.depth) == ("bulk", 2) and cfg.chunk < 5000


@pytest.mark.parametrize("block_rows", [1, 8])
def test_coalesced_gather_row_named_by_every_element(cuda, block_rows):
    """One row fans out to every output of every window."""
    table = torch.randn((40, 64), generator=torch.Generator(
        device=cuda).manual_seed(14), device=cuda)
    _gather_both(table, np.full(1000, 37, np.int32), window=256,
                 block_rows=block_rows)


@pytest.mark.parametrize("path", ["bulk", "unit"])
def test_coalesced_gather_rows_past_the_table_read_as_zeros(cuda, path):
    """A block spanning past the last row (rows 8..15 of a 12-row table at
    block_rows 8): those outputs are zeros, on both paths."""
    arrays = dict(tags=[[1]], n_warps=[1], elem_warp=[[0] * 6],
                  elem_offset=[[0, 3, 4, 7, 4, 0]])
    sched = BlockSchedule(
        **{k: torch.tensor(v, dtype=torch.int32, device=cuda)
           for k, v in arrays.items()},
        elem_valid=torch.ones((1, 6), dtype=torch.bool, device=cuda),
        window=6, block_rows=8)
    table = torch.randn((12, 64), generator=torch.Generator(
        device=cuda).manual_seed(15), device=cuda)
    plan = build_gather_plan(sched)
    got = coalesced_gather_cuda(table, None, window=6, block_rows=8,
                                plan=plan, path=path)
    torch.cuda.synchronize()
    zero = torch.zeros(64, device=cuda)
    want = torch.stack([table[8], table[11], zero, zero, zero, table[8]])
    assert torch.equal(_bytes(got), _bytes(want))
    assert torch.equal(_bytes(got), _bytes(coalesced_gather_plain(
        table, None, window=6, block_rows=8, plan=plan)))


def test_coalesced_gather_views_choose_the_path_by_alignment(cuda):
    """A table view 16 bytes off a 128-byte line takes the bulk path; one
    4 bytes off must take the unit path, and asking for bulk raises."""
    base = torch.randn(70 * 64 + 4, generator=torch.Generator(
        device=cuda).manual_seed(16), device=cuda)
    idx = np.random.default_rng(17).integers(0, 70, 300).astype(np.int32)
    aligned16 = base[4:4 + 70 * 64].view(70, 64)
    assert aligned16.data_ptr() % 128 == 16
    _gather_both(aligned16, idx, window=64, block_rows=8)
    shifted = base[1:1 + 70 * 64].view(70, 64)
    assert gather_unit(256, shifted.data_ptr()) == 4
    _gather_both(shifted, idx, window=64, block_rows=8, paths=("unit",))
    sched, _ = cached_block_schedule(idx, window=64, block_rows=8,
                                     device=cuda)
    with pytest.raises(ValueError, match="bulk path"):
        coalesced_gather_cuda(shifted, None, window=64, block_rows=8,
                              plan=build_gather_plan(sched), path="bulk")


def test_coalesced_gather_long_windows_on_the_bulk_path(cuda):
    """The long-window case with 512-byte rows, both paths."""
    gen = torch.Generator(device=cuda).manual_seed(18)
    table = torch.randn((5000, 128), generator=gen, device=cuda)
    idx = np.random.default_rng(19).integers(0, 5000, 2 * 2500 + 700)
    _gather_both(table, idx.astype(np.int32), window=2500, block_rows=4)


def test_coalesced_gather_work_queue_per_stream(cuda):
    """Launches queued on two streams, each with its own work counter that
    every launch leaves at zero, all equal table[idx]."""
    gen = torch.Generator(device=cuda).manual_seed(20)
    table = torch.randn((3000, 256), generator=gen, device=cuda)
    idx = np.random.default_rng(21).integers(0, 3000, 4000).astype(np.int32)
    sched, _ = cached_block_schedule(idx, window=256, block_rows=1,
                                     device=cuda)
    plan = build_gather_plan(sched)
    want = table[torch.as_tensor(idx, device=cuda).long()]
    side = torch.cuda.Stream(device=cuda)
    outs = []
    for stream in (torch.cuda.current_stream(cuda), side, side):
        with torch.cuda.stream(stream):
            for path in ("bulk", "unit"):
                outs.append(coalesced_gather_cuda(
                    table, None, window=256, block_rows=1, plan=plan,
                    n_out=len(idx), path=path))
    torch.cuda.synchronize()
    for got in outs:
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# Per-micro-batch pipeline hooks, the streaming executor and the solvers'
# CUDA graphs
# ---------------------------------------------------------------------------

# ~50 ms of spin on an H100: long enough that host work issued behind it
# finishes first.
SPIN_CYCLES = 100_000_000


def test_finalize_waits_for_its_own_micro_batch_only(cuda):
    """finalize of batch i returns while batch i+1's kernel is still queued
    behind a spin kernel; batch i+1's copy (on the copy stream) is not held
    up by the spin; both equal matmat bit for bit."""
    csr = CASES["banded"]()
    rng = np.random.default_rng(30)
    X1, X2 = (rng.standard_normal((csr.n_cols, 8)).astype(np.float32)
              for _ in range(2))
    eng = SpMVEngine(csr, device=cuda)
    want1, want2 = eng.matmat(X1), eng.matmat(X2)
    p1 = eng.dispatch(eng.stage(X1))
    torch.cuda._sleep(SPIN_CYCLES)
    p2 = eng.dispatch(eng.stage(X2))
    y1 = eng.finalize(p1)
    p2.staged.copied.synchronize()
    assert not p2.done.query()  # still behind the spin
    y2 = eng.finalize(p2)
    assert torch.equal(y1, want1) and torch.equal(y2, want2)
    assert p2.staged.host.is_pinned()


def test_matmat_and_matvec_stage_host_arrays_without_blocking(cuda):
    """matmat and matvec place a host array as stage does (pinned memory,
    the copy stream) and return while the compute stream is still busy
    with a spin kernel queued before them; matmat equals the per-batch
    hooks bit for bit."""
    csr = CASES["banded"]()
    X = np.random.default_rng(32).standard_normal(
        (csr.n_cols, 8)).astype(np.float32)
    eng = SpMVEngine(csr, device=cuda)
    want = eng.finalize(eng.dispatch(eng.stage(X)))
    want_v = eng.matvec(X[:, 0])
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    spun = torch.cuda.Event()
    spun.record()
    Y, y = eng.matmat(X), eng.matvec(X[:, 0])
    assert not spun.query()  # neither call waited behind the spin
    torch.cuda.synchronize()
    assert torch.equal(Y, want) and torch.equal(y, want_v)


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("microbatch", [8, 5])
def test_streamed_equals_sync_on_card(cuda, depth, microbatch):
    from repro_torch.core.runtime import StreamingExecutor

    csr = CASES["banded"]()
    X = np.random.default_rng(31).standard_normal(
        (csr.n_cols, 21)).astype(np.float32)
    eng = SpMVEngine(csr, device=cuda)
    streamer = StreamingExecutor(eng, microbatch=microbatch, depth=depth)
    _close(streamer.matmat(X), eng.matmat(X))
    handles = [streamer.submit(X[:, :k]) for k in (3, 21, 9)]
    outs = streamer.drain()
    assert outs.ok and all(h.done for h in handles)
    for k, got in zip((3, 21, 9), outs):
        _close(got, eng.matmat(X[:, :k]))
    staging = streamer.staging
    assert staging["microbatches"] == 2 * -(-21 // microbatch) + sum(
        -(-k // microbatch) for k in (3, 9))
    assert staging["copy_ms"] > 0


def test_pinned_ring_buffer_waits_for_its_copy(cuda):
    """A ring buffer is packed again only after the copy that last read it
    has completed; a stress of many batches at depth 2 with the copies held
    behind a spin stays equal to the synchronous result."""
    from repro_torch.core.runtime import PinnedRing, StreamingExecutor

    ring = PinnedRing(2, 64, 4, torch.float32)
    side = torch.cuda.Stream(device=cuda)
    src = torch.zeros((64, 4))
    with torch.cuda.stream(side):
        torch.cuda._sleep(SPIN_CYCLES)
        ev = torch.cuda.Event()
        ev.record()
    ring.note_copy(0, ev)
    ring.pack(0, src)
    assert ev.query()

    csr = CASES["random"]()
    rng = np.random.default_rng(32)
    batches = [rng.standard_normal((csr.n_cols, 8)).astype(np.float32)
               for _ in range(12)]
    eng = SpMVEngine(csr, device=cuda)
    streamer = StreamingExecutor(eng, microbatch=3, depth=2)
    with torch.cuda.stream(eng.copy_stream()):
        torch.cuda._sleep(SPIN_CYCLES)
    for B in batches:
        streamer.submit(B)
    outs = streamer.drain()
    assert outs.ok and len(outs) == len(batches)
    for B, got in zip(batches, outs):
        _close(got, eng.matmat(B))


def _solve(name, op, loop, b):
    from repro_torch.core import solvers

    if name == "cg":
        return solvers.cg(op, b, tol=1e-6, loop=loop, trace=True)
    if name == "jacobi":
        return solvers.jacobi(op, b, tol=1e-6, loop=loop, trace=True)
    if name == "pagerank":
        return solvers.pagerank(op, tol=1e-6, loop=loop, trace=True)
    return solvers.power_iteration(op, tol=1e-5, maxiter=500, loop=loop,
                                   trace=True)


@pytest.mark.parametrize("name", ["cg", "jacobi", "pagerank", "power"])
def test_graph_captured_solve_equals_python_loop_bitwise(cuda, name):
    """loop='while' (blocks of guarded steps, one CUDA graph) and the
    python-loop oracle agree bit for bit; every matvec of either went
    through sell_spmv (replays counted)."""
    from repro_torch.core.engine import get_engine
    from repro_torch.core.solvers import transition_matrix

    csr = matrices.spd(4000, 6, 0.6)(seed=40)
    op = transition_matrix(matrices.powerlaw(4000, 8)(seed=41)) \
        if name == "pagerank" else csr
    eng = get_engine(op, device=cuda)
    b = np.random.default_rng(42).standard_normal(4000).astype(np.float32)
    results = {}
    for loop in ("python", "while", "while"):  # capture, then replay
        before = sell_spmv_cuda.launches
        res = _solve(name, eng, loop, b)
        assert res.converged and res.loop == loop
        assert sell_spmv_cuda.launches - before == res.matvecs
        results.setdefault(loop, res)
        assert torch.equal(res.x, results[loop].x)
    py, wh = results["python"], results["while"]
    assert wh.iterations == py.iterations
    assert torch.equal(wh.x, py.x)
    assert np.array_equal(wh.residual_trace, py.residual_trace)
    assert py.matvecs == py.iterations + (name == "cg")


@pytest.mark.parametrize("name", ["cg", "jacobi"])
def test_graph_warm_solve_takes_each_right_hand_side(cuda, name):
    """A replayed graph reads the buffers it was captured with: b1, b2, b1
    on one warm engine must each solve their own system."""
    from repro_torch.core.engine import get_engine

    csr = matrices.spd(3000, 5, 0.6)(seed=43)
    eng = get_engine(csr, device=cuda)
    dense = csr.todense().astype(np.float64)
    rng = np.random.default_rng(44)
    b1, b2 = (rng.standard_normal(3000).astype(np.float32) for _ in range(2))
    for b in (b1, b2, b1):
        res = _solve(name, eng, "while", b)
        assert res.converged
        x = res.x.cpu().numpy().astype(np.float64)
        assert np.linalg.norm(b - dense @ x) / np.linalg.norm(b) <= 5e-6


def test_solve_whose_capture_fails_raises(cuda):
    """A matvec that synchronises the host cannot be captured: loop='while'
    raises instead of running uncaptured."""
    from repro_torch.core import solvers

    csr = matrices.spd(2000, 5, 0.6)(seed=45)
    eng = SpMVEngine(csr, device=cuda)
    mv = eng.device_matvec()

    class HostSyncing:
        n_rows = n_cols = csr.n_rows
        device = eng.device
        sell = eng.sell

        def matvec(self, x):
            return eng.matvec(x)

        def device_matvec(self):
            return lambda x: mv(x) * float(x.abs().max() > -1)

    b = np.ones(2000, np.float32)
    with pytest.raises(RuntimeError, match="could not capture"):
        solvers.jacobi(HostSyncing(), b, loop="while")
    assert solvers.jacobi(HostSyncing(), b, loop="python").converged


def test_float64_host_input_runs_through_the_kernel_as_float32(cuda):
    """ROADMAP C12: a float64 numpy right-hand side is staged as float32
    (what `jnp.asarray` makes of it) and launches the kernels, with the
    float32 input's result bit for bit."""
    csr = CASES["banded"]()
    X = np.random.default_rng(33).standard_normal((csr.n_cols, 8))
    eng = SpMVEngine(csr, device=cuda)
    ops.sell_spmv_cuda.launches = ops.sell_spmm_cuda.launches = 0
    y, Y = eng.matvec(X[:, 0]), eng.matmat(X)
    assert ops.sell_spmv_cuda.launches == ops.sell_spmm_cuda.launches == 1
    assert y.dtype == Y.dtype == torch.float32
    X32 = X.astype(np.float32)
    assert torch.equal(y, eng.matvec(X32[:, 0]))
    assert torch.equal(Y, eng.matmat(X32))


@pytest.mark.parametrize("partition", ["even", "nnz", "cost"])
def test_sharded_engine_on_one_card_matches_single_device(cuda, partition):
    """Four shards round-robined onto one card: every block launches the
    kernels, and matmat / matvec agree with the single-device engine within
    1e-5 + 1e-5·|y| (each shard pads to its own width, so the kernels sum
    in another order)."""
    from repro_torch.core.dist import ShardedSpMVEngine
    from repro_torch.launch.mesh import parse_mesh_spec

    csr = matrices.powerlaw(20000, 12, skew=2.0)(seed=34)
    X = np.random.default_rng(35).standard_normal(
        (csr.n_cols, 64)).astype(np.float32)
    sharded = ShardedSpMVEngine(csr, mesh=parse_mesh_spec("1,1"),
                                n_shards=4, partition=partition)
    single = SpMVEngine(csr, device=cuda)
    assert sharded.device == cuda and sharded.backend_resolved == "cuda"
    ops.sell_spmv_cuda.launches = ops.sell_spmm_cuda.launches = 0
    Y, y = sharded.matmat(X), sharded.matvec(X[:, 0])
    torch.cuda.synchronize()
    assert ops.sell_spmm_cuda.launches == ops.sell_spmv_cuda.launches == 4
    _close(Y, single.matmat(X))
    _close(y, single.matvec(X[:, 0]))
    parts = sharded.matvec_parts(X[:, 0])
    assert all(p.device == cuda and xd.device == cuda for p, xd, _ in parts)
    widths = [s["width"] for s in sharded.plan_report()["shards"]]
    assert max(widths) > min(widths)


def test_sharded_shard_fail_recovers_on_card(cuda):
    from repro_torch.core.dist import ShardedSpMVEngine
    from repro_torch.core.faults import FaultPlan

    csr = CASES["banded"]()
    X = np.random.default_rng(36).standard_normal(
        (csr.n_cols, 16)).astype(np.float32)
    sharded = ShardedSpMVEngine(csr, n_shards=3)
    want = sharded.matmat(X)
    with FaultPlan("shard_fail:after=1,count=1") as plan:
        got = sharded.matmat(X)
    assert plan.report()["unrecovered"] == 0
    assert sharded.recovery_report()["injected"] == 1
    _close(got, want)


def test_measure_search_over_four_candidates_on_card(cuda):
    """Measure mode times four geometries on the card in CUDA events and
    hands the winner's engine over; it agrees with the plain version."""
    from repro_torch.core import tune
    from repro_torch.kernels.sell_spmm import sell_spmm_plain

    tune.clear_tune_cache()
    csr = CASES["banded"]()
    space = {"cols_per_chunk": (4, 8), "block_rows": (4, 8), "k_tile": (8,),
             "packed": (1,), "buffer_depth": (2,),
             "value_dtype": ("native",)}
    log = []
    eng, plan = tune.get_tuned_engine(csr, k=32, mode="measure",
                                      space=space, rounds=2, trial_log=log)
    assert plan.backend == "cuda" and plan.trials == 8
    assert len(log) == 4 and all(t.error is None and t.us > 0 for t in log)
    assert plan.cost == min(t.us for t in log)
    assert (eng.cols_per_chunk, eng.block_rows) == (plan.cols_per_chunk,
                                                    plan.block_rows)
    X = torch.as_tensor(np.random.default_rng(37).standard_normal(
        (csr.n_cols, 32)).astype(np.float32), device=cuda)
    want = sell_spmm_plain(None, eng.plan_values(torch.float32), X,
                           plan=eng.device_plan,
                           cols_per_chunk=eng.cols_per_chunk,
                           block_rows=eng.block_rows)[:csr.n_rows]
    _close(eng.matmat(X), want)


# ---------------------------------------------------------------------------
# The model stack on the card
# ---------------------------------------------------------------------------

MODEL_TOL = 1e-4  # float32 on two devices: GEMM order, exp/log ulps


def _model_pair(name, cuda, dtype=None):
    """A reduced arch's model, its seeded parameters on the CPU and the
    same values on the card, and a seeded batch on each."""
    import copy
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.models import build_model, make_input_batch

    cfg = ARCHS[name].reduced()
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0), device="cpu")
    card = copy.deepcopy(cpu).to(cuda)
    batch = make_input_batch(cfg, 2, 24, torch.Generator().manual_seed(1),
                             device="cpu")
    return cfg, model, cpu, card, batch, {k: v.to(cuda)
                                          for k, v in batch.items()}


def _tol_close(got, want, tol=MODEL_TOL):
    err = (got.cpu().float() - want.float()).abs()
    assert torch.all(err <= tol + tol * want.float().abs()), float(err.max())


@pytest.mark.parametrize("name", [
    "deepseek-v2-lite-16b", "llama-3.2-vision-11b", "llama3-8b",
    "llama4-maverick-400b-a17b", "qwen2-1.5b", "smollm-360m",
    "tinyllama-1.1b", "whisper-large-v3", "xlstm-1.3b", "zamba2-1.2b"])
def test_reduced_models_on_card_match_the_cpu(cuda, name):
    """Forward logits, a prefill and a decode step through a float32 cache,
    and greedy tokens: the card against the port on the CPU, float32."""
    from repro_torch.launch.serve import generate
    from repro_torch.models import Runtime

    cfg, model, cpu, card, batch, batch_c = _model_pair(name, cuda)
    rt = Runtime(cache_dtype="float32")
    with torch.inference_mode():
        want, _ = model.forward(cpu, batch, rt)
        got, _ = model.forward(card, batch_c, rt)
        assert got.is_cuda
        _tol_close(got, want)
        caches = []
        for params, b, dev in ((cpu, batch, "cpu"), (card, batch_c, cuda)):
            c = model.init_cache(2, 30, rt, device=dev)
            if cfg.family == "audio":
                c["enc_out"] = model.extras["encode"](params, b["enc_input"],
                                                      rt)
            if cfg.family == "vlm":
                c["image_embeds"] = b["image_embeds"]
            caches.append(c)
        for toks in (batch["tokens"], batch["tokens"][:, :1]):
            want, caches[0] = model.decode_step(cpu, toks, caches[0], rt)
            got, caches[1] = model.decode_step(card, toks.to(cuda),
                                               caches[1], rt)
            _tol_close(got, want)
    want = generate(model, cpu, batch["tokens"][:, :8], max_new_tokens=4,
                    rt=rt, extras_batch=batch)
    got = generate(model, card, batch_c["tokens"][:, :8], max_new_tokens=4,
                   rt=rt, extras_batch=batch_c)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("width", [256, 4096])
def test_cuda_embedding_equals_index_bitwise(cuda, width):
    """`embed_backend="cuda"` launches the gather once a lookup and gives
    ``table[ids]``'s bytes on a bf16 table: 512 B rows (the unit path) and
    8 KB rows (llama3-8b's, the TMA bulk path)."""
    from repro_torch.models import layers as L

    gen = torch.Generator(device=cuda).manual_seed(3)
    table = torch.randn((5000, width), generator=gen, device=cuda).to(
        torch.bfloat16)
    ids = torch.randint(0, 5000, (4, 300), generator=gen, device=cuda)
    before = coalesced_gather_cuda.launches
    got = L.embedding_apply({"embed": table}, ids, backend="cuda")
    torch.cuda.synchronize()
    assert coalesced_gather_cuda.launches == before + 1
    want = L.embedding_apply({"embed": table}, ids, backend="index")
    assert got.shape == (4, 300, width)
    assert torch.equal(_bytes(got), _bytes(want))


def test_cuda_embedding_model_logits_equal_index_bitwise(cuda):
    """A bf16 reduced llama through both embeddings on the card: the same
    logits, bit for bit, and one gather launch a step."""
    from repro_torch.launch.serve import generate
    from repro_torch.models import Runtime

    cfg, model, _, card, _, batch = _model_pair("llama3-8b", cuda,
                                                dtype="bfloat16")
    with torch.inference_mode():
        want, _ = model.forward(card, batch, Runtime())
        before = coalesced_gather_cuda.launches
        got, _ = model.forward(card, batch, Runtime(embed_backend="cuda"))
        assert coalesced_gather_cuda.launches == before + 1
    assert torch.equal(_bytes(got), _bytes(want))
    before = coalesced_gather_cuda.launches
    toks = generate(model, card, batch["tokens"], max_new_tokens=3,
                    rt=Runtime(embed_backend="cuda"))
    assert coalesced_gather_cuda.launches == before + 4
    assert torch.equal(toks, generate(model, card, batch["tokens"],
                                      max_new_tokens=3, rt=Runtime()))


def _generate_recorded(model, params, batch, rt, capture, steps=5):
    """`generate` on the card with every step's kind and logits kept
    (cloned), and the gather launches it made."""
    from repro_torch.launch.serve import generate

    kinds, logits = [], []

    def hook(kind, ids, run):
        out = run()
        kinds.append(kind)
        if kind != "capture":
            logits.append(out.clone())
        return out

    before = coalesced_gather_cuda.launches
    toks = generate(model, params, batch["tokens"][:, :8],
                    max_new_tokens=steps, rt=rt, extras_batch=batch,
                    capture=capture, step_hook=hook)
    torch.cuda.synchronize()
    return toks, logits, kinds, coalesced_gather_cuda.launches - before


@pytest.mark.parametrize("name,backend", [
    ("llama3-8b", "index"), ("llama3-8b", "cuda"),
    ("deepseek-v2-lite-16b", "cuda"), ("xlstm-1.3b", "index")])
def test_captured_generate_equals_eager_bitwise(cuda, name, backend):
    """`generate` replays one captured graph a token after its warm-up step
    (a dense arch, an MoE arch with MLA, a recurrent arch): tokens equal
    and every step's logits bitwise equal to the same step run eagerly,
    the same kernels in the same order; the gather launches once a step
    either way, replays counted through `CapturedLaunches`."""
    from repro_torch.models import Runtime

    cfg, model, _, card, _, batch = _model_pair(name, cuda,
                                                dtype="bfloat16")
    rt = Runtime(embed_backend=backend)
    eager = _generate_recorded(model, card, batch, rt, capture=False)
    captured = _generate_recorded(model, card, batch, rt, capture=None)
    assert eager[2] == ["prefill"] + ["step"] * 5
    assert captured[2] == ["prefill", "step", "capture"] + ["replay"] * 4
    assert torch.equal(captured[0], eager[0])
    assert len(captured[1]) == len(eager[1]) == 6
    for got, want in zip(captured[1], eager[1]):
        assert torch.equal(_bytes(got), _bytes(want))
    launches = 6 if backend == "cuda" else 0
    assert captured[3] == eager[3] == launches


def test_a_replay_makes_no_host_sync(cuda):
    """Under ``torch.cuda.set_sync_debug_mode("error")``, from the first
    replay of the captured step (the cuda embedding planned in the step)
    to the end of `generate` (the argmax, the next token's copy, the
    other replays), nothing raises: nothing there waits for the card."""
    from repro_torch.launch.serve import generate
    from repro_torch.models import Runtime

    cfg, model, _, card, _, batch = _model_pair("tinyllama-1.1b", cuda,
                                                dtype="bfloat16")
    kinds = []

    def hook(kind, ids, run):
        if kind == "replay":
            torch.cuda.set_sync_debug_mode("error")
        kinds.append(kind)
        return run()

    try:
        toks = generate(model, card, batch["tokens"], max_new_tokens=4,
                        rt=Runtime(embed_backend="cuda"), step_hook=hook)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert kinds == ["prefill", "step", "capture"] + ["replay"] * 3
    assert toks.shape == (2, 4)


def test_generate_whose_capture_fails_raises(cuda):
    """A step that synchronises the host cannot be captured: `generate`
    raises, naming the model, rather than decode eagerly."""
    import dataclasses

    from repro_torch.launch.serve import generate
    from repro_torch.models import Runtime

    cfg, model, _, card, _, batch = _model_pair("smollm-360m", cuda)
    step = model.decode_step

    def syncing(p, toks, cache, rt):
        logits, cache = step(p, toks, cache, rt)
        return logits * float(logits.abs().max() > -1), cache

    with pytest.raises(RuntimeError, match="smollm-360m.*could not capture"):
        generate(dataclasses.replace(model, decode_step=syncing), card,
                 batch["tokens"], max_new_tokens=3, rt=Runtime())
    torch.cuda.synchronize()
    toks = generate(model, card, batch["tokens"], max_new_tokens=3,
                    rt=Runtime())
    assert toks.shape == (2, 3)


# ---------------------------------------------------------------------------
# Training on the card
# ---------------------------------------------------------------------------


def _train_pair(cuda, layers=2, dtype="float32"):
    """A reduced tinyllama cut to `layers`, the same numpy parameters on the
    CPU and the card, and a pipeline batch on each."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.core.interop import model_params_from_numpy, \
        model_params_to_numpy
    from repro_torch.data.pipeline import DataConfig, TokenPipeline, \
        device_put_batch
    from repro_torch.models import build_model

    cfg = dataclasses.replace(ARCHS["tinyllama-1.1b"].reduced(),
                              n_layers=layers, dtype=dtype)
    model = build_model(cfg)
    arrays = model_params_to_numpy(cfg, model.init(
        torch.Generator().manual_seed(0), device="cpu"))
    batch = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                     global_batch=4)).batch_at(2)
    return cfg, model, [
        (model_params_from_numpy(cfg, arrays, device=dev),
         device_put_batch(batch, dev)) for dev in ("cpu", cuda)]


@pytest.mark.parametrize("kw", [{}, {"microbatches": 2},
                                {"grad_compression": True}])
def test_train_step_on_card_matches_the_cpu(cuda, kw):
    """One `make_update_fn` update of a 2-layer float32 model: the loss
    within 1e-5 relative, every gradient leaf within 1e-4 * max|g| + 1e-6
    and the updated parameters within 1e-5 of the CPU's."""
    from repro_torch.models import Runtime, lm_loss
    from repro_torch.optim.compression import init_residual
    from repro_torch.optim.optimizer import OptConfig, init_opt_state
    from repro_torch.optim.tree import named_tensors
    from repro_torch.train.loop import TrainConfig, make_update_fn, \
        value_and_grad

    _, model, pairs = _train_pair(cuda)
    grads = [value_and_grad(lambda p, b=b: lm_loss(model, p, b, Runtime()),
                            p) for p, b in pairs]
    (lc, gc), (lg, gg) = grads
    assert abs(float(lg) - float(lc)) <= 1e-5 * abs(float(lc))
    gg = named_tensors(gg)
    for name, want in named_tensors(gc).items():
        err = (gg[name].cpu() - want).abs().max()
        assert err <= 1e-4 * want.abs().max() + 1e-6, name
    tcfg = TrainConfig(**kw)
    out = []
    for params, batch in pairs:
        res = init_residual(params) if tcfg.grad_compression else None
        update = make_update_fn(model, OptConfig(lr=1e-3, warmup_steps=0),
                                Runtime(), tcfg)
        _, _, _, m = update(params, init_opt_state(params), res, batch)
        out.append((float(m["loss"]), named_tensors(params)))
    (lc, pc), (lg, pg) = out
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for name, want in pc.items():
        torch.testing.assert_close(pg[name].detach().cpu(), want.detach(),
                                   rtol=1e-5, atol=1e-5)


def test_cuda_embedding_refuses_autograd_on_card(cuda):
    """C19: the gather kernel has no backward; under autograd the cuda
    backend (and auto, which picks it on the card) raises, and under
    no_grad it gives the index embedding's loss."""
    from repro_torch.models import Runtime, lm_loss

    _, model, pairs = _train_pair(cuda)
    params, batch = pairs[1]
    before = coalesced_gather_cuda.launches
    for backend in ("cuda", "auto"):
        with pytest.raises(NotImplementedError, match="no gradient"):
            lm_loss(model, params, batch, Runtime(embed_backend=backend))
    with pytest.raises(NotImplementedError):
        ops.coalesced_gather(params.tok.embed, batch["tokens"].reshape(-1))
    assert coalesced_gather_cuda.launches == before
    with torch.no_grad():
        got = lm_loss(model, params, batch, Runtime(embed_backend="cuda"))
        want = lm_loss(model, params, batch, Runtime())
    assert coalesced_gather_cuda.launches == before + 1
    assert float(got) == float(want)


def test_remat_modes_equal_on_card(cuda):
    from repro_torch.models import Runtime, lm_loss
    from repro_torch.train.loop import value_and_grad
    from repro_torch.optim.tree import named_tensors

    _, model, pairs = _train_pair(cuda)
    params, batch = pairs[1]
    out = {}
    for remat in ("none", "full", "dots"):
        loss, grads = value_and_grad(
            lambda p: lm_loss(model, p, batch, Runtime(remat=remat)), params)
        out[remat] = (float(loss), named_tensors(grads))
    loss, grads = out["none"]
    for remat in ("full", "dots"):
        assert abs(out[remat][0] - loss) <= 1e-6 * abs(loss)
        for name, g in grads.items():
            torch.testing.assert_close(out[remat][1][name], g, rtol=1e-6,
                                       atol=1e-6 * float(g.abs().max()))


def test_bf16_checkpoint_round_trip_on_card(cuda, tmp_path):
    """A bf16 model and its moments on the card, saved in `repro`'s layout
    and restored into another state on the card byte for byte (C21)."""
    import json

    from repro_torch.optim.optimizer import OptConfig, init_opt_state
    from repro_torch.optim.tree import named_tensors
    from repro_torch.models import Runtime
    from repro_torch.train.checkpoint import restore_latest, \
        save_checkpoint
    from repro_torch.train.loop import TrainConfig, make_update_fn

    cfg, model, pairs = _train_pair(cuda, dtype="bfloat16")
    params, batch = pairs[1]
    state = {"params": params, "opt": init_opt_state(params)}
    make_update_fn(model, OptConfig(), Runtime(), TrainConfig())(
        params, state["opt"], None, batch)
    path = save_checkpoint(tmp_path, 1, state)
    manifest = json.loads((path / "manifest.json").read_text())
    assert {e["dtype"] for e in manifest["leaves"]} == {"bfloat16",
                                                        "float32", "int32"}
    other = model.init(torch.Generator(device=cuda).manual_seed(9),
                       device=cuda)
    fresh = {"params": other, "opt": init_opt_state(other)}
    step, fresh = restore_latest(tmp_path, fresh)
    assert step == 1 and int(fresh["opt"].step) == 1
    for part in ("params", "mu", "nu"):
        a = named_tensors(state["params"] if part == "params"
                          else getattr(state["opt"], part))
        b = named_tensors(fresh["params"] if part == "params"
                          else getattr(fresh["opt"], part))
        for name, t in a.items():
            assert b[name].device == t.device and b[name].dtype == t.dtype
            assert torch.equal(b[name].view(torch.uint8)
                               if t.dtype == torch.bfloat16 else b[name],
                               t.view(torch.uint8)
                               if t.dtype == torch.bfloat16 else t), name



def test_sharded_step_on_a_one_card_mesh_equals_the_unsharded_step(cuda):
    """A 1x1 NCCL process mesh: the parameters become DTensors placed by
    `param_pspecs`, and one `make_update_fn` update on them equals the
    update of the same parameters as plain tensors on the card (loss and
    parameters within 1e-6 relative; the mesh's collectives are on one
    rank)."""
    import torch.distributed as dist

    from repro_torch.data.pipeline import DataConfig, TokenPipeline, \
        device_put_batch
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models import Runtime
    from repro_torch.optim.optimizer import OptConfig, init_opt_state
    from repro_torch.optim.tree import named_tensors
    from repro_torch.sharding.dtensor import distribute_module, full, \
        is_dtensor
    from repro_torch.sharding.rules import batch_pspecs, param_shardings, \
        to_shardings
    from repro_torch.train.loop import TrainConfig, make_update_fn

    cfg, model, pairs = _train_pair(cuda)
    plain, batch = pairs[1]
    sharded = _train_pair(cuda)[2][1][0]  # the same values, another copy
    update = make_update_fn(model, OptConfig(), Runtime(), TrainConfig())
    _, _, _, want = update(plain, init_opt_state(plain), None, batch)
    try:
        mesh = make_process_mesh(1, 1)
        distribute_module(sharded, param_shardings(sharded, mesh))
        assert all(is_dtensor(p) for p in sharded.parameters())
        host = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=32, global_batch=4)
                             ).batch_at(2)
        dbatch = device_put_batch(host, cuda, shardings=to_shardings(
            batch_pspecs(host, mesh), mesh))
        _, opt, _, got = update(sharded, init_opt_state(sharded), None,
                                dbatch)
        assert all(is_dtensor(m) for m in opt.mu.parameters())
        assert float(got["loss"]) == pytest.approx(float(want["loss"]),
                                                   rel=1e-6)
        ref = named_tensors(plain)
        for name, t in named_tensors(sharded).items():
            torch.testing.assert_close(full(t.detach()), ref[name].detach(),
                                       rtol=1e-6, atol=1e-6, msg=name)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The training update captured as one CUDA graph
# ---------------------------------------------------------------------------


def _tiny_cfg():
    """Reduced tinyllama (float32) cut to 2 layers."""
    import dataclasses

    from repro_torch.configs import ARCHS

    return dataclasses.replace(ARCHS["tinyllama-1.1b"].reduced(), n_layers=2)


def _train_on_card(cuda, capture, steps=4, remat="none", cfg=None, **kw):
    """`train()` of `cfg` (default `_tiny_cfg`) on the card for `steps`
    steps: (its output, each step's kind, each step's loss, grad norm and
    lr as its history read them from the step's outputs)."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import Runtime, build_model
    from repro_torch.optim.optimizer import OptConfig
    from repro_torch.train.loop import TrainConfig, train

    cfg = cfg or _tiny_cfg()
    out = train(build_model(cfg), rt=Runtime(remat=remat),
                opt_cfg=OptConfig(lr=1e-3, warmup_steps=2, total_steps=8),
                tcfg=TrainConfig(total_steps=steps, log_every=1, **kw),
                data_cfg=DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                    global_batch=4),
                device=cuda, capture=capture)
    hist = out["history"]
    return out, [h["kind"] for h in hist], [
        (h["loss"], h["grad_norm"], h["lr"]) for h in hist]


def _captured_update_on_card(cuda):
    """`update_over_buffers`' update of `_tiny_cfg` on the card, warmed up
    on a side stream and captured there (`core.capture`), as `train` does
    it: the `CapturedStep`."""
    from repro_torch.core.capture import CapturedStep, on_side_stream
    from repro_torch.data.pipeline import DataConfig, TokenPipeline, \
        device_put_batch
    from repro_torch.models import Runtime, build_model
    from repro_torch.optim.optimizer import OptConfig, init_opt_state
    from repro_torch.train.loop import TrainConfig, update_over_buffers

    cfg = _tiny_cfg()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    batch = device_put_batch(TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)).batch_at(0),
        cuda)
    step = update_over_buffers(model, OptConfig(), Runtime(), TrainConfig(),
                               params, init_opt_state(params), None, batch)
    side = torch.cuda.Stream(cuda)
    on_side_stream(side, step)
    return CapturedStep(step, side, "the training update")


@pytest.mark.parametrize("kw", [
    {}, {"microbatches": 2}, {"grad_compression": True},
    {"microbatches": 2, "grad_compression": True}, {"remat": "full"},
    {"remat": "dots"}])
def test_captured_update_equals_eager_bitwise(cuda, kw):
    """`train` on the card captures its update after one eager step on a
    side stream and replays it; from the same seed the replays give every
    step's loss, grad norm and lr and the final parameters and moments of
    the same steps run eagerly, bit for bit (the same kernels in the same
    order)."""
    from repro_torch.optim.tree import named_tensors

    (eo, ek, em), (co, ck, cm) = (_train_on_card(cuda, c, **kw)
                                  for c in (False, True))
    assert ek == ["step"] * 4
    assert ck == ["step"] + ["replay"] * 3
    assert co["captured"] and not eo["captured"]
    assert co["capture_seconds"] > 0
    assert cm == em
    for part in ("params", "mu", "nu"):
        a, b = (named_tensors(o["params"] if part == "params"
                              else getattr(o["opt_state"], part))
                for o in (co, eo))
        for name, t in b.items():
            assert torch.equal(a[name], t), (part, name)
    assert int(co["opt_state"].step) == int(eo["opt_state"].step) == 4


def _state_bits(out):
    from repro_torch.optim.tree import named_tensors

    return {(part, n): t for part in ("params", "mu", "nu")
            for n, t in named_tensors(
                out["params"] if part == "params"
                else getattr(out["opt_state"], part)).items()}


def test_moe_update_repeats_itself_and_its_replays_bitwise(cuda):
    """The MoE combine adds each token's expert rows in a fixed order (no
    atomics): reduced deepseek-v2-lite's eager update repeats itself bit
    for bit, and the captured update's replays equal it, every step's
    metrics and the final parameters and moments."""
    import dataclasses

    from repro_torch.configs import ARCHS

    cfg = dataclasses.replace(ARCHS["deepseek-v2-lite-16b"].reduced(),
                              dtype="bfloat16")
    runs = [_train_on_card(cuda, c, cfg=cfg) for c in (False, False, True)]
    (e1, _, m1), (e2, _, m2), (c, kinds, mc) = runs
    assert kinds == ["step"] + ["replay"] * 3 and c["captured"]
    assert m1 == m2 == mc
    want = _state_bits(e1)
    for got in (_state_bits(e2), _state_bits(c)):
        for key, t in want.items():
            assert torch.equal(got[key], t), key


def test_training_capture_that_fails_raises(cuda, monkeypatch):
    """A loss that synchronises the host cannot be captured: `train`
    raises, naming the model, after its eager first step, rather than
    train eagerly; without the sync the same run captures."""
    from repro_torch.train import loop as tloop

    real = tloop.lm_loss

    def syncing(model, params, batch, rt):
        loss = real(model, params, batch, rt)
        return loss * float(loss.detach().abs() > -1)

    monkeypatch.setattr(tloop, "lm_loss", syncing)
    with pytest.raises(RuntimeError, match="tinyllama.*could not capture "
                                           "the training update"):
        _train_on_card(cuda, None)
    monkeypatch.setattr(tloop, "lm_loss", real)
    torch.cuda.synchronize()
    out, kinds, _ = _train_on_card(cuda, None, steps=3)
    assert out["captured"] and kinds[-1] == "replay"


def test_captured_update_counts_launches_through_captured_launches(cuda):
    """The graph's launch counts come from `kernels.ops.CapturedLaunches`
    around the capture; the training update launches none of the three
    kernels (the index embedding; the cuda gather has no gradient), so
    the replays add nothing to the wrappers' counts."""
    from repro_torch.kernels.ops import KERNEL_WRAPPERS, CapturedLaunches

    before = {n: w.launches for n, w in KERNEL_WRAPPERS.items()}
    graph = _captured_update_on_card(cuda)
    for _ in range(3):
        graph()
    torch.cuda.synchronize()
    assert isinstance(graph.launches, CapturedLaunches)
    assert graph.launches.counts == {n: 0 for n in KERNEL_WRAPPERS}
    assert {n: w.launches for n, w in KERNEL_WRAPPERS.items()} == before


def test_a_training_replay_makes_no_host_sync(cuda):
    """Under ``torch.cuda.set_sync_debug_mode("error")`` each replay of
    the captured update runs without waiting for the card (the schedule's
    step, the clip and the bias corrections live on the card)."""
    graph = _captured_update_on_card(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            out = graph()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(out["loss"]).item()
