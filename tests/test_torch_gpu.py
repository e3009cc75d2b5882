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
