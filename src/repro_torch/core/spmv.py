"""SpMV library ops: CSR and SELL, with plain-torch and coalesced data paths
(port of `repro.core.spmv`).

`spmv_sell_coalesced` executes the SELL SpMV the way the paper's VPC +
adapter does — windowed column-index stream, coalesced wide-block warps,
offset extraction — through the engine's reference backend; `spmv_csr` and
`spmv_sell` are the direct references.
"""
from __future__ import annotations

import numpy as np
import torch

from .formats import CSRMatrix, SELLMatrix


def spmv_csr(csr: CSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """Reference CSR SpMV: y = A @ x via a segment sum (index_add_)."""
    row_of_nnz = torch.as_tensor(
        np.repeat(np.arange(csr.n_rows), np.diff(csr.indptr)), device=x.device
    )
    idx = torch.as_tensor(csr.indices.astype(np.int64), device=x.device)
    data = torch.as_tensor(csr.data, device=x.device).to(x.dtype)
    y = torch.zeros(csr.n_rows, dtype=x.dtype, device=x.device)
    return y.index_add_(0, row_of_nnz, x[idx] * data)


def _sell_padded(sell: SELLMatrix):
    """Pad all slices to a common width -> dense (n_slices, W, H) arrays.
    Host-side restructuring for the vectorized references/kernels."""
    H = sell.slice_height
    W = int(sell.slice_widths.max()) if sell.n_slices else 1
    ci = np.zeros((sell.n_slices, W, H), dtype=np.int32)
    va = np.zeros((sell.n_slices, W, H), dtype=sell.values.dtype)
    for s in range(sell.n_slices):
        c, v = sell.slice_arrays(s)
        ci[s, : c.shape[0]] = c
        va[s, : v.shape[0]] = v
    return ci, va, W


def spmv_sell(sell: SELLMatrix, x: torch.Tensor) -> torch.Tensor:
    """Reference SELL SpMV (padded-dense gather)."""
    ci, va, _ = _sell_padded(sell)
    ci_t = torch.as_tensor(ci.astype(np.int64), device=x.device)
    va_t = torch.as_tensor(va, device=x.device).to(x.dtype)
    # (n_slices, W, H): y[s*H + h] = sum_w va[s,w,h] * x[ci[s,w,h]]
    y = torch.sum(va_t * x[ci_t], dim=1)
    return y.reshape(-1)[: sell.n_rows]


def spmv_sell_coalesced(
    sell: SELLMatrix,
    x: torch.Tensor,
    *,
    window: int = 256,
    block_rows: int = 8,
) -> torch.Tensor:
    """SELL SpMV through the coalesced indirect-stream data path: identical
    result to `spmv_sell`, but every x access goes through window->warp
    coalescing + wide-block fetch + offset extraction. Routed through the
    engine cache on the reference backend, on x's device."""
    from .engine import get_engine  # local import: engine builds on this module

    return get_engine(
        sell, window=window, block_rows=block_rows, backend="reference",
        device=x.device,
    ).matvec(x)
