"""Fused multi-column SELL SpMM: one indirect stream, k columns (port of
`repro.kernels.sell_spmm`).

Each coalesced wide fetch grabs a ``(block_rows, k_tile)`` tile of the dense
X, so the metadata stream and the SELL values are read once per `k_tile`
columns instead of once per column. `k_tile` is clamped to k so narrow
batches never pay padding work, and a short last tile (``k % k_tile != 0``)
is masked.

The kernel (`csrc/sell_spmm.cu`) replaces the TPU kernel
`repro/kernels/sell_spmm.py:sell_spmm_pallas`. It is bound by device-memory
bytes: values and metadata are re-read once per k-tile and X is read
through the wide fetches, against two operations per element and column.
One thread block owns one (slice, k-tile) pair, or a few slices of one
k-tile when the tile is narrow; the TPU grid's sequential chunk and warp
axes become a loop inside the block. Per chunk the block copies each
unique tag's ``(block_rows, k_tile)`` tile of X into shared memory, then
thread (row h, column j) walks the chunk's columns, decodes the metadata
and accumulates ``value * tile[warp][offset][j]`` in a float32 register.
A window whose tiles exceed the shared-memory budget is staged in groups
of warps, one pass per group. `buffer_depth` is validated but not yet
honoured.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from repro_torch.core.coalescer import BlockSchedule

from . import _build
from .sell_spmv import (
    DEFAULT_BUFFER_DEPTH,
    DevicePlan,
    _check_kernel_inputs,
    _check_width,
    _launch_args,
    _validate_buffer_depth,
    launch_config,
    plan_gather,
    resolve_device_plan,
)

_MAX_GRID_Y = 65535


def _check_args(X: torch.Tensor, W: int, cols_per_chunk: int, k_tile: int):
    if X.dim() != 2:
        raise ValueError(f"sell_spmm expects X of shape (n_cols, k), got "
                         f"{tuple(X.shape)}")
    _check_width(W, cols_per_chunk, "sell_spmm")
    if k_tile < 1:
        raise ValueError(f"k_tile must be >= 1, got {k_tile}")


def sell_spmm_cuda(
    colidx: Optional[torch.Tensor],  # (n_slices, W, H) int32, or None with a plan
    values: torch.Tensor,  # (n_slices, W, H) float32 | bfloat16, CUDA
    X: torch.Tensor,  # (n_cols, k) float32, CUDA
    *,
    cols_per_chunk: int = 8,
    block_rows: int = 8,
    k_tile: int = 8,
    max_warps: Optional[int] = None,
    schedule: Optional[BlockSchedule] = None,
    plan: Optional[DevicePlan] = None,
    packed: Union[bool, str, None] = None,
    buffer_depth: int = DEFAULT_BUFFER_DEPTH,
) -> torch.Tensor:
    """Returns Y = A @ X, Y: (n_slices * H, k) float32, computed by the CUDA
    kernel on the current stream. Semantics: ref.sell_spmm_ref. Each call
    that launches adds one to ``sell_spmm_cuda.launches``."""
    n_slices, W, H = values.shape
    _check_args(X, W, cols_per_chunk, k_tile)
    _validate_buffer_depth(buffer_depth)
    k = int(X.shape[1])
    if k == 0:
        return torch.zeros((n_slices * H, 0), dtype=torch.float32,
                           device=values.device)
    dplan = resolve_device_plan(
        colidx, n_slices=n_slices, W=W, slice_height=H,
        cols_per_chunk=cols_per_chunk, block_rows=block_rows,
        max_warps=max_warps, schedule=schedule, plan=plan, packed=packed,
    )
    _check_kernel_inputs(values, X, dplan, "sell_spmm_cuda")
    kt = min(int(k_tile), k)
    if -(-k // kt) > _MAX_GRID_Y:
        raise ValueError(f"k={k} at k_tile={kt} needs more than "
                         f"{_MAX_GRID_Y} k-tiles; raise k_tile")
    values = values.contiguous()
    X = X.contiguous()
    Y = torch.empty((n_slices * H, k), dtype=torch.float32,
                    device=values.device)
    if n_slices == 0:
        return Y
    lib = _build.library()
    slices, group, smem = launch_config(
        n_slices=n_slices, slice_height=H, k_tile=kt,
        max_warps=dplan.max_warps, block_rows=block_rows,
        smem_limit=_build.max_dynamic_smem(values.device),
    )
    with torch.cuda.device(values.device):
        rc = lib.sell_spmm_launch(
            *_launch_args(values, X, dplan),
            ctypes.c_void_p(Y.data_ptr()),
            int(values.dtype == torch.bfloat16), int(dplan.packed),
            n_slices, dplan.n_chunks, cols_per_chunk, H, dplan.max_warps,
            block_rows, int(X.shape[0]), k, kt, slices, group, smem,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    _build.check(rc, "sell_spmm")
    sell_spmm_cuda.launches += 1
    return Y


sell_spmm_cuda.launches = 0


def sell_spmm_plain(
    colidx: Optional[torch.Tensor],
    values: torch.Tensor,
    X: torch.Tensor,
    *,
    cols_per_chunk: int = 8,
    block_rows: int = 8,
    k_tile: int = 8,
    max_warps: Optional[int] = None,
    schedule: Optional[BlockSchedule] = None,
    plan: Optional[DevicePlan] = None,
    packed: Union[bool, str, None] = None,
    buffer_depth: int = DEFAULT_BUFFER_DEPTH,
) -> torch.Tensor:
    """The kernel's plain-torch version: the same plan and the same k-tiles
    (clamped to k, short last tile), one gather per tile. Output in the
    promoted dtype."""
    n_slices, W, H = values.shape
    _check_args(X, W, cols_per_chunk, k_tile)
    _validate_buffer_depth(buffer_depth)
    k = int(X.shape[1])
    out_dtype = torch.promote_types(values.dtype, X.dtype)
    if k == 0:
        return torch.zeros((n_slices * H, 0), dtype=out_dtype,
                           device=values.device)
    dplan = resolve_device_plan(
        colidx, n_slices=n_slices, W=W, slice_height=H,
        cols_per_chunk=cols_per_chunk, block_rows=block_rows,
        max_warps=max_warps, schedule=schedule, plan=plan, packed=packed,
    )
    kt = min(int(k_tile), k)
    vals = values.reshape(
        n_slices, dplan.n_chunks, cols_per_chunk, H, 1
    ).to(out_dtype)
    Y = torch.empty((n_slices * H, k), dtype=out_dtype, device=values.device)
    for q0 in range(0, k, kt):
        g = plan_gather(dplan, X[:, q0:q0 + kt]).to(out_dtype)
        Y[:, q0:q0 + kt] = torch.sum(vals * g, dim=(1, 2)).reshape(
            n_slices * H, -1
        )
    return Y
