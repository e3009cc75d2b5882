"""Dispatch for the kernels (port of `repro.kernels.ops`).

The device of `values` (of `table` for the gather) decides: a CUDA tensor
launches the hand-written kernel (or raises — there is no fallback), a CPU
tensor runs the kernel's plain torch version on the same plan. Neither
kernel has a backward: the gather refuses a table that requires grad while
autograd records, on both devices.
`CapturedLaunches` carries the wrappers' launch counts across CUDA graphs.
"""
from __future__ import annotations

from typing import Dict

from .coalesced_gather import check_no_grad, coalesced_gather_cuda, \
    coalesced_gather_plain
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
    `kernels.coalesced_gather`); raises NotImplementedError on a table that
    requires grad while autograd records (`check_no_grad`)."""
    check_no_grad(table)
    fn = coalesced_gather_cuda if table.is_cuda else coalesced_gather_plain
    return fn(table, indices, **kwargs)


KERNEL_WRAPPERS = {
    "sell_spmv": sell_spmv_cuda,
    "sell_spmm": sell_spmm_cuda,
    "coalesced_gather": coalesced_gather_cuda,
}


class CapturedLaunches:
    """The kernel launches one CUDA graph holds: wrap the capture in
    ``with CapturedLaunches() as launches:``, then call
    ``launches.replayed()`` after each replay of the graph, which adds them
    to each wrapper's ``launches`` (a replay launches the captured kernels
    without calling the wrappers)."""

    def __enter__(self) -> "CapturedLaunches":
        self._before = {n: w.captured for n, w in KERNEL_WRAPPERS.items()}
        return self

    def __exit__(self, *exc) -> None:
        self.counts: Dict[str, int] = {
            n: w.captured - self._before[n] for n, w in KERNEL_WRAPPERS.items()
        }

    def replayed(self) -> None:
        for name, n in self.counts.items():
            KERNEL_WRAPPERS[name].launches += n
