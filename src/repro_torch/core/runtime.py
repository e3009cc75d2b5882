"""Plan and batch geometry shared by the engine (port of the geometry part of
`repro.core.runtime`).

`normalize_to_sell` is the one CSR->SELL normalization every engine entry
point shares, `pad_width` the width padding of the width-aware planner, and
`column_groups`/`microbatch_slices` the contiguous RHS column splits.
`resolve_device` picks the device of an engine or a plan (the card unless
the caller asks for the CPU), and `stage_rhs` places a right-hand side
there; it takes the place of `repro`'s `device_put_rhs`.
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from .formats import CSRMatrix, SELLMatrix, csr_to_sell


def normalize_to_sell(
    matrix: Union[CSRMatrix, SELLMatrix],
    *,
    slice_height: Optional[int] = None,
    width_multiple: int = 1,
    validate: bool = True,
) -> SELLMatrix:
    """CSR inputs are validated and converted (the offline preprocessing
    step); SELL inputs are checked against the requested conversion
    parameters. ``validate=False`` skips the O(nnz) SELL well-formedness scan
    for hot cache-lookup paths (`get_engine`), where construction on a miss
    validates anyway."""
    if isinstance(matrix, CSRMatrix):
        matrix.validate()
        kw = {} if slice_height is None else {"slice_height": slice_height}
        return csr_to_sell(matrix, width_multiple=width_multiple, **kw)
    if isinstance(matrix, SELLMatrix):
        if slice_height is not None and slice_height != matrix.slice_height:
            raise ValueError(
                f"matrix is already SELL with slice_height="
                f"{matrix.slice_height}; cannot re-slice to {slice_height} "
                f"(convert from CSR instead)"
            )
        if width_multiple != 1 and np.any(
            np.asarray(matrix.slice_widths) % width_multiple
        ):
            raise ValueError(
                f"matrix is already SELL and its slice widths are not "
                f"multiples of {width_multiple} (convert from CSR instead)"
            )
        if validate:
            matrix.validate()
        return matrix
    raise TypeError(f"expected CSRMatrix or SELLMatrix, got {type(matrix)}")


def pad_width(
    ci: np.ndarray, va: np.ndarray, *, multiple: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Zero-pad (n_slices, W, H) colidx/value arrays up to the next multiple
    of ``multiple`` columns (colidx 0 / value 0 — safe for SpMV). Returns
    ``(ci_plan, va_plan, W_plan)``; when W already satisfies the multiple the
    inputs pass through unchanged."""
    ns, W, H = ci.shape
    m = int(multiple)
    if m < 1:
        raise ValueError(f"width multiple must be >= 1, got {multiple}")
    W_plan = max(-(-W // m) * m, m)
    if W_plan == W:
        return ci, va, W
    ci_plan = np.zeros((ns, W_plan, H), dtype=ci.dtype)
    va_plan = np.zeros((ns, W_plan, H), dtype=va.dtype)
    ci_plan[:, :W] = ci
    va_plan[:, :W] = va
    return ci_plan, va_plan, W_plan


def column_groups(k: int, n_groups: int) -> List[slice]:
    """Balanced contiguous split of `k` RHS columns into at most `n_groups`
    non-empty slices."""
    n_groups = max(1, min(n_groups, k)) if k else 1
    bounds = np.linspace(0, k, n_groups + 1).astype(int)
    return [
        slice(int(bounds[j]), int(bounds[j + 1]))
        for j in range(n_groups)
        if bounds[j + 1] > bounds[j]
    ]


def microbatch_slices(k: int, microbatch: int) -> List[slice]:
    """Fixed-size contiguous split of `k` RHS columns into micro-batches of
    ``microbatch`` columns (the last one may be short)."""
    if microbatch < 1:
        raise ValueError(f"microbatch must be >= 1, got {microbatch}")
    return [slice(j, min(j + microbatch, k)) for j in range(0, k, microbatch)]


def resolve_device(device=None) -> torch.device:
    """The device of an engine or a plan: ``None`` means the card. A CUDA
    device without a card raises — nothing carries on on the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default, but torch "
                "finds none; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be a CUDA device or 'cpu', got {dev}")
    return dev


def stage_rhs(X, device) -> torch.Tensor:
    """Place a right-hand side (numpy array or tensor) on `device`. A host
    numpy batch is copied; a tensor already there passes through."""
    if torch.is_tensor(X):
        return X.to(device)
    return torch.as_tensor(np.asarray(X), device=device)
