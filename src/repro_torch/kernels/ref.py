"""Plain-torch oracles over `colidx` (port of `repro.kernels.ref`).

Each oracle defines the semantics a kernel must reproduce. The kernels'
own plain versions (`sell_spmv_plain`, `sell_spmm_plain`) follow the plan
instead of `colidx`; both must agree with these.
"""
from __future__ import annotations

import torch


def coalesced_gather_ref(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Gather rows: (R, D) x (n,) -> (n, D)."""
    return table[indices.to(torch.int64)]


def sell_spmv_ref(
    colidx: torch.Tensor,  # (n_slices, W, H) int32
    values: torch.Tensor,  # (n_slices, W, H)
    x: torch.Tensor,  # (n_cols,)
) -> torch.Tensor:
    """Padded SELL SpMV: y[s, h] = sum_w values[s, w, h] * x[colidx[s, w, h]].
    Returns (n_slices * H,)."""
    y = torch.sum(values * x[colidx.to(torch.int64)], dim=1)
    return y.reshape(-1)


def sell_spmm_ref(
    colidx: torch.Tensor,  # (n_slices, W, H) int32
    values: torch.Tensor,  # (n_slices, W, H)
    X: torch.Tensor,  # (n_cols, k)
) -> torch.Tensor:
    """Padded SELL SpMM: Y[s*H + h, j] = sum_w values[s, w, h] * X[colidx[
    s, w, h], j]. Returns (n_slices * H, k)."""
    y = torch.sum(values[..., None] * X[colidx.to(torch.int64)], dim=1)
    return y.reshape(values.shape[0] * values.shape[2], X.shape[1])
