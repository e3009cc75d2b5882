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
from repro_torch.kernels.coalesced_gather import build_gather_plan, \
    coalesced_gather_cuda, coalesced_gather_plain
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


@pytest.mark.parametrize("k", [1, 7, 8, 33, 64, 65, 128, 200])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_sell_spmm_kernel_matches_plain(cuda, k, packed, dtype, depth):
    """Every k the column tile meets: one column (k = 1), k not a multiple
    of 4 or 8 (7, 33, 65: 4-byte copies, masked columns), k = 8 and the
    main path's 64 (whole rows in 16-byte pieces), one full 128-column
    tile, and k = 200 (two tiles)."""
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


def test_coalesced_gather_stages_long_windows_in_chunks(cuda):
    """A window longer than the elements a block stages at once (1,024) is
    copied chunk by chunk; a partial last window ends mid-chunk."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    table = torch.randn((5000, 12), generator=gen, device=cuda)
    idx = np.random.default_rng(9).integers(0, 5000, 2 * 2500 + 700)
    sched, _ = cached_block_schedule(idx, window=2500, block_rows=4,
                                     device=cuda)
    plan = build_gather_plan(sched)
    got = coalesced_gather_cuda(table, None, window=2500, block_rows=4,
                                plan=plan, n_out=len(idx))
    torch.cuda.synchronize()
    assert torch.equal(got, table[torch.as_tensor(idx, device=cuda).long()])
