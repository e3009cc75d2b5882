"""State carried between the JAX package and this one, as numpy arrays.

For this system the "weights" are the matrix and its coalescer plan, and on
the serving side the paged KV cache. These helpers rebuild them on the torch
side from plain arrays (and back), so a matrix, a `BlockSchedule` or a paged
cache produced by `repro` can be handed to the port's plan lowering, kernels
and decode path without either package importing the other.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .coalescer import BlockSchedule
from .formats import CSRMatrix
from .runtime import resolve_device

SCHEDULE_FIELDS = ("tags", "n_warps", "elem_warp", "elem_offset", "elem_valid")


def csr_from_arrays(
    n_rows: int, n_cols: int, indptr, indices, data
) -> CSRMatrix:
    """A validated `CSRMatrix` from its three arrays (copied to numpy)."""
    csr = CSRMatrix(
        n_rows=int(n_rows),
        n_cols=int(n_cols),
        indptr=np.array(indptr),
        indices=np.array(indices),
        data=np.array(data),
    )
    csr.validate()
    return csr


def schedule_from_arrays(
    arrays: Dict[str, np.ndarray], *, window: int, block_rows: int, device=None
) -> BlockSchedule:
    """A `BlockSchedule` on `device` (default: the card, see
    `runtime.resolve_device`) from a dict of numpy arrays keyed by
    `SCHEDULE_FIELDS` (e.g. the fields of a `repro` schedule, converted with
    ``np.asarray``). Integer fields become int32, `elem_valid` bool."""
    device = resolve_device(device)
    missing = [f for f in SCHEDULE_FIELDS if f not in arrays]
    if missing:
        raise ValueError(f"schedule arrays lack {missing}")
    fields = {}
    for name in SCHEDULE_FIELDS:
        dtype = torch.bool if name == "elem_valid" else torch.int32
        fields[name] = torch.as_tensor(
            np.array(arrays[name]), device=device
        ).to(dtype)
    n_windows = fields["tags"].shape[0]
    for name in ("elem_warp", "elem_offset", "elem_valid"):
        if tuple(fields[name].shape) != (n_windows, int(window)):
            raise ValueError(
                f"{name} has shape {tuple(fields[name].shape)}, expected "
                f"({n_windows}, {window})"
            )
    return BlockSchedule(
        **fields, window=int(window), block_rows=int(block_rows)
    )


def schedule_to_arrays(schedule: BlockSchedule) -> Dict[str, np.ndarray]:
    """The inverse of `schedule_from_arrays`: each field as a host array."""
    return {
        name: getattr(schedule, name).cpu().numpy() for name in SCHEDULE_FIELDS
    }


def paged_kv_from_arrays(k_pages, v_pages, page_table, lengths, block: int,
                         device=None):
    """A `models.paged_kv.PagedKV` on `device` (default: the card) from the
    four arrays of a paged cache (e.g. the fields of a `repro` cache,
    converted with ``np.asarray``): pools (n_pages, block, n_kv, hd) in
    their own dtype (torch reads no numpy bfloat16: carry such pools as
    float32 and cast the result's), the page table and the lengths as
    int32."""
    from repro_torch.models.paged_kv import PagedKV

    device = resolve_device(device)
    k = torch.as_tensor(np.array(k_pages), device=device)
    v = torch.as_tensor(np.array(v_pages), device=device)
    if k.shape != v.shape or k.dim() != 4 or k.shape[1] != int(block):
        raise ValueError(
            f"k/v pools must share a (n_pages, block={block}, n_kv, hd) "
            f"shape, got {tuple(k.shape)} and {tuple(v.shape)}"
        )
    table = torch.as_tensor(np.array(page_table), device=device).to(
        torch.int32)
    lens = torch.as_tensor(np.array(lengths), device=device).to(torch.int32)
    if table.dim() != 2 or tuple(lens.shape) != (table.shape[0],):
        raise ValueError(
            f"page table must be (B, max_pages) and lengths (B,), got "
            f"{tuple(table.shape)} and {tuple(lens.shape)}"
        )
    return PagedKV(k_pages=k, v_pages=v, page_table=table, lengths=lens,
                   block=int(block))
