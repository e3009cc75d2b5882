"""State carried between the JAX package and this one, as numpy arrays.

For this system the "weights" are the matrix and its coalescer plan. These
helpers rebuild them on the torch side from plain arrays (and back), so a
matrix or a `BlockSchedule` produced by `repro` can be handed to the port's
plan lowering and kernels without either package importing the other.
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
