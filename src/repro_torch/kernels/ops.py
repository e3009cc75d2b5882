"""Dispatch for the kernels (port of `repro.kernels.ops`).

The device of `values` (of `table` for the gather) decides: a CUDA tensor
launches the hand-written kernel (or raises — there is no fallback), a CPU
tensor runs the kernel's plain torch version on the same plan.
"""
from __future__ import annotations

from .coalesced_gather import coalesced_gather_cuda, coalesced_gather_plain
from .sell_spmm import sell_spmm_cuda, sell_spmm_plain
from .sell_spmv import sell_spmv_cuda, sell_spmv_plain


def sell_spmv(colidx, values, x, **kwargs):
    """y = A @ x over padded SELL (see `kernels.sell_spmv`)."""
    fn = sell_spmv_cuda if values.is_cuda else sell_spmv_plain
    return fn(colidx, values, x, **kwargs)


def sell_spmm(colidx, values, X, **kwargs):
    """Fused multi-column Y = A @ X: one pass over the plan and the SELL
    values per `k_tile` right-hand-side columns (see `kernels.sell_spmm`)."""
    fn = sell_spmm_cuda if values.is_cuda else sell_spmm_plain
    return fn(colidx, values, X, **kwargs)


def coalesced_gather(table, indices=None, **kwargs):
    """``table[indices]`` through the coalesced plan (see
    `kernels.coalesced_gather`)."""
    fn = coalesced_gather_cuda if table.is_cuda else coalesced_gather_plain
    return fn(table, indices, **kwargs)
