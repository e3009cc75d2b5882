"""Fused multi-column SELL SpMM: one indirect stream, k columns (port of
`repro.kernels.sell_spmm`).

In the JAX package each coalesced wide fetch grabs a ``(block_rows,
k_tile)`` tile of the dense X, so the metadata stream and the SELL values
are read once per `k_tile` columns. On Hopper `k_tile` keeps its
validation and its place in signatures and engine keys, but it shapes
neither the kernel's grid nor the plain version's float64 sums:
`launch_config` picks the Hopper column tile from k (all of k up to 128
columns), so at the main path's k = 64 values and metadata are read once
per launch.

The kernel (`csrc/sell_spmm.cu`) replaces the TPU kernel
`repro/kernels/sell_spmm.py:sell_spmm_pallas`. It is bound by device-memory
bytes: values and metadata once per column tile, X once through the wide
fetches and Y once, against two operations per element and column. Each
persistent thread block (as many as fit on the card) walks the plan's work
items (`sell_spmv.DevicePlan`), one at a time at 32 rows and k <= 128; the
TPU grid's sequential chunk and warp axes become a loop inside the block,
fed by a `buffer_depth`-stage `cp.async` ring in shared memory that holds
each window's unique ``(block_rows, col_tile)`` tiles of X (padding tag
slots skipped), its values and its metadata words, and runs on from item
to item. Thread (row h, q) keeps row h's sums for 8 columns in float32
registers, reading each element's value and metadata word once and its X
row as two float4; columns past k are masked. A window whose tiles exceed
the budget of one stage is staged in groups of warps, each a step of the
same ring; a slice cut into several items is added up from their partial
rows after the kernel.
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
    _launch_args,
    _validate_buffer_depth,
    _plan_config,
    _ring_args,
    call_geometry,
    partial_rows,
    plan_sums,
    resolve_device_plan,
)

_MAX_GRID_Y = 65535


def _check_args(X: torch.Tensor, values: torch.Tensor,
                plan: Optional[DevicePlan], cols_per_chunk: int,
                k_tile: int):
    """The call's (n_slices, W, H), after checking X and k_tile."""
    if X.dim() != 2:
        raise ValueError(f"sell_spmm expects X of shape (n_cols, k), got "
                         f"{tuple(X.shape)}")
    geometry = call_geometry(values, plan, cols_per_chunk, "sell_spmm")
    if k_tile < 1:
        raise ValueError(f"k_tile must be >= 1, got {k_tile}")
    return geometry


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
    that launches adds one to ``sell_spmm_cuda.launches`` (to ``.captured``
    while a CUDA graph is captured: `_build.count_launch`)."""
    n_slices, W, H = _check_args(X, values, plan, cols_per_chunk, k_tile)
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
    values = values.contiguous()
    X = X.contiguous()
    Y = torch.empty((n_slices * H, k), dtype=torch.float32,
                    device=values.device)
    if n_slices == 0 or dplan.n_windows == 0:  # no window: every row is 0
        return Y.zero_()
    lib = _build.library()
    cfg = _plan_config(values, dplan, k=k, cols_per_thread=8,
                       buffer_depth=buffer_depth)
    if cfg.col_tiles > _MAX_GRID_Y:
        raise ValueError(f"k={k} needs {cfg.col_tiles} column tiles of "
                         f"{cfg.col_tile}, more than {_MAX_GRID_Y}")
    scratch = partial_rows(dplan, Y)
    with torch.cuda.device(values.device):
        rc = lib.sell_spmm_launch(
            *_launch_args(values, X, dplan, Y, scratch),
            cols_per_chunk, H, dplan.max_warps, block_rows, int(X.shape[0]),
            k, cfg.quads,
            *_ring_args(values, dplan, cfg, k, X, Y), cfg.smem_bytes,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    _build.check(rc, "sell_spmm")
    _build.count_launch(sell_spmm_cuda)
    return Y


sell_spmm_cuda.launches = 0
sell_spmm_cuda.captured = 0


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
    """The kernel's plain-torch version: the same plan, summed in float64
    (`sell_spmv.plan_sums`), where `k_tile` changes no sum. Output in the
    promoted dtype."""
    n_slices, W, H = _check_args(X, values, plan, cols_per_chunk, k_tile)
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
    return plan_sums(dplan, values, X, out_dtype)
