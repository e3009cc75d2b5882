"""The port's CUDA kernels against their plain torch versions, on the card.

Marked `gpu`: each test asks for the `cuda` fixture, which skips with a
reason when torch finds no CUDA device. The file imports neither JAX nor
the JAX package, so it also runs where JAX is absent:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_gpu.py

Tolerance: ``|kernel - plain| <= 1e-5 + 1e-5 * |plain|`` elementwise — both
sum the same float32 products in different orders (and the kernel may fuse
multiply-adds).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import matrices
from repro_torch.core.engine import SpMVEngine, cached_block_schedule, \
    clear_engine_cache, clear_schedule_cache
from repro_torch.core.runtime import normalize_to_sell, pad_width
from repro_torch.core.spmv import _sell_padded
from repro_torch.kernels import _build, ops
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
def test_sell_spmv_kernel_matches_plain(cuda, family, packed, dtype):
    csr = CASES[family]()
    va, plan = _plan_case(csr, cpc=8, block_rows=8, packed=packed,
                          device=cuda)
    rng = np.random.default_rng(3)
    values = torch.as_tensor(va).to(dtype).to(cuda)
    x = torch.as_tensor(rng.standard_normal(csr.n_cols).astype(np.float32),
                        device=cuda)
    before = sell_spmv_cuda.launches
    y = ops.sell_spmv(None, values, x, plan=plan, cols_per_chunk=8)
    torch.cuda.synchronize()
    assert sell_spmv_cuda.launches == before + 1
    _close(y, sell_spmv_plain(None, values, x, plan=plan, cols_per_chunk=8))


@pytest.mark.parametrize("k", [1, 7, 8, 33])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sell_spmm_kernel_matches_plain(cuda, k, packed, dtype):
    va, plan = _plan_case(CASES["banded"](), cpc=4, block_rows=8,
                          packed=packed, device=cuda)
    rng = np.random.default_rng(4)
    values = torch.as_tensor(va).to(dtype).to(cuda)
    X = torch.as_tensor(rng.standard_normal((3000, k)).astype(np.float32),
                        device=cuda)
    before = sell_spmm_cuda.launches
    Y = ops.sell_spmm(None, values, X, plan=plan, cols_per_chunk=4, k_tile=8)
    torch.cuda.synchronize()
    assert sell_spmm_cuda.launches == before + 1
    _close(Y, sell_spmm_plain(None, values, X, plan=plan, cols_per_chunk=4,
                              k_tile=8))


def test_sell_spmm_stages_large_windows_in_groups(cuda):
    """A random plan at k_tile=32 needs more shared memory per window than a
    block may take, so the kernel stages each window in groups of warps."""
    va, plan = _plan_case(CASES["random"](), cpc=8, block_rows=8,
                          packed=True, device=cuda)
    limit = _build.max_dynamic_smem(cuda)
    _, group, _ = launch_config(
        n_slices=plan.n_slices, slice_height=32, k_tile=32,
        max_warps=plan.max_warps, block_rows=8, smem_limit=limit,
    )
    assert group < plan.max_warps  # the multi-pass path
    rng = np.random.default_rng(5)
    values = torch.as_tensor(va).to(torch.float32).to(cuda)
    X = torch.as_tensor(rng.standard_normal((16384, 64)).astype(np.float32),
                        device=cuda)
    Y = sell_spmm_cuda(None, values, X, plan=plan, k_tile=32)
    torch.cuda.synchronize()
    _close(Y, sell_spmm_plain(None, values, X, plan=plan, k_tile=32))


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
