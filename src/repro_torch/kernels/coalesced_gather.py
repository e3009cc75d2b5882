"""Block-coalesced row gather: plan lowering, the Hopper kernel's wrapper and
its plain version (port of `repro.kernels.coalesced_gather`).

The gather consumes the same `DevicePlan` as the SELL kernels, in the
degenerate gather geometry: ``n_slices = n_windows``, one chunk of
``cols_per_chunk = 1`` x ``slice_height = window`` per window
(`build_gather_plan`). Element e of window w reads table row
``tags[w, warp] * block_rows + offset``; rows at or past the table's end read
as zeros. Plan-owning callers (`core.gather_engine.GatherEngine`) build the
plan once and pass it per call; with a plan, `indices` may be None and
`n_out` trims the padded output.

The kernel (`csrc/coalesced_gather.cu`) replaces the TPU kernel
`repro/kernels/coalesced_gather.py:coalesced_gather_pallas`. Semantics are
exactly ``table[indices]`` (`ref.coalesced_gather_ref`) for every dtype: the
kernel copies bytes. The TPU kernel extracts rows with a one-hot matmul, so
it returns ``+0.0`` for ``-0.0`` and spreads an ``inf`` in a fetched block
into ``nan`` across the window; the port does neither.

On a CUDA tensor `coalesced_gather_cuda` launches the kernel or raises; on a
CPU tensor `kernels.ops.coalesced_gather` takes `coalesced_gather_plain`,
which follows the same plan in plain torch.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from repro_torch.core.coalescer import BlockSchedule, resolve_schedule

from . import _build
from .sell_spmv import DevicePlan, build_device_plan, plan_gather

#: Threads of one gather block.
_THREADS = 256
#: Plan elements whose source rows a block stages in shared memory at once.
_ELEM_CHUNK = 1024
#: Vector units the kernel copies with, widest first (bytes).
_UNITS = (16, 8, 4, 2, 1)
#: A column tile is a multiple of this many units (a warp's worth).
_TILE_QUANTUM = 32
#: Blocks per SM the tiling aims for.
_BLOCKS_PER_SM = 8
_MAX_GRID_Y = 65535


def build_gather_plan(
    schedule: BlockSchedule, *, packed: Union[bool, str] = "auto"
) -> DevicePlan:
    """Lower a flat-stream `BlockSchedule` to the gather kernel's `DevicePlan`
    (on the schedule's device): one chunk per window, ``n_slices =
    n_windows``, ``cols_per_chunk = 1``, ``slice_height = window``."""
    return build_device_plan(
        schedule,
        n_slices=schedule.n_windows,
        cols_per_chunk=1,
        slice_height=schedule.window,
        packed=packed,
    )


def resolve_gather_plan(
    indices,
    *,
    window: int,
    block_rows: int,
    max_warps: Optional[int] = None,
    schedule: Optional[BlockSchedule] = None,
    plan: Optional[DevicePlan] = None,
    packed: Union[bool, str, None] = None,
    device=None,
) -> DevicePlan:
    """Plan resolution for the gather kernel, mirroring
    `sell_spmv.resolve_device_plan`: a prebuilt `plan` wins (validated
    against the call geometry), else a prebuilt `schedule` is lowered, else
    the plan is built from `indices` (only then required) on `device`."""
    if plan is not None:
        if (
            plan.window != window
            or plan.cols_per_chunk != 1
            or plan.n_chunks != 1
        ):
            raise ValueError(
                f"gather plan was built for (window={plan.window}, "
                f"cols_per_chunk={plan.cols_per_chunk}, "
                f"n_chunks={plan.n_chunks}), call expects window={window} "
                f"with the gather geometry (cols_per_chunk=1, n_chunks=1); "
                f"rebuild with build_gather_plan"
            )
        if plan.block_rows != block_rows:
            raise ValueError(
                f"gather plan was built for block_rows={plan.block_rows}, "
                f"call expects block_rows={block_rows}"
            )
        if packed not in (None, "auto") and bool(packed) != plan.packed:
            raise ValueError(
                f"gather plan was built with packed={plan.packed}, call "
                f"expects packed={bool(packed)}; rebuild the plan to change "
                f"the metadata encoding"
            )
        return plan
    if indices is not None:
        flat = indices.reshape(-1)
        sched, _ = resolve_schedule(
            flat, window=window, block_rows=block_rows, max_warps=max_warps,
            schedule=schedule, device=device,
        )
    elif schedule is not None:
        # No stream to length-check against; geometry must still agree.
        if schedule.window != window or schedule.block_rows != block_rows:
            raise ValueError(
                f"schedule was planned for (window={schedule.window}, "
                f"block_rows={schedule.block_rows}), call expects "
                f"(window={window}, block_rows={block_rows})"
            )
        sched = schedule
    else:
        raise ValueError(
            "indices are required to build a plan; pass schedule= or plan= "
            "to run without the index array"
        )
    return build_gather_plan(sched, packed="auto" if packed is None else packed)


def _resolve_call(
    table: torch.Tensor, indices, *, window, block_rows, max_warps, schedule,
    plan, packed, n_out,
) -> Tuple[DevicePlan, int]:
    """The call's plan (built on the table's device when it must be built)
    and its checked output length."""
    if table.dim() != 2:
        raise ValueError(f"table must be (rows, row_width), got shape "
                         f"{tuple(table.shape)}")
    if indices is not None and not torch.is_tensor(indices):
        indices = torch.as_tensor(indices)
    dplan = resolve_gather_plan(
        indices, window=window, block_rows=block_rows, max_warps=max_warps,
        schedule=schedule, plan=plan, packed=packed, device=table.device,
    )
    padded = dplan.n_slices * window
    if n_out is None:
        n_out = int(indices.numel()) if indices is not None else padded
    if not 0 <= n_out <= padded:
        raise ValueError(
            f"n_out={n_out} does not fit the plan's {dplan.n_slices} windows "
            f"of {window} ({padded} padded elements)"
        )
    return dplan, int(n_out)


def coalesced_gather_plain(
    table: torch.Tensor,
    indices=None,
    *,
    window: int = 256,
    block_rows: int = 8,
    max_warps: Optional[int] = None,
    schedule: Optional[BlockSchedule] = None,
    plan: Optional[DevicePlan] = None,
    packed: Union[bool, str, None] = None,
    n_out: Optional[int] = None,
) -> torch.Tensor:
    """The kernel's plain-torch version: each output element reads row
    ``tags[w, warp] * block_rows + offset`` through the plan
    (`sell_spmv.plan_gather`); rows at or past the table's end read as
    zeros. Bitwise ``table[idx]``."""
    dplan, n_out = _resolve_call(
        table, indices, window=window, block_rows=block_rows,
        max_warps=max_warps, schedule=schedule, plan=plan, packed=packed,
        n_out=n_out,
    )
    return plan_gather(dplan, table).reshape(-1, table.shape[1])[:n_out]


def gather_unit(row_bytes: int, *pointers: int) -> int:
    """The widest vector unit (16, 8, 4, 2 or 1 bytes) that divides a row's
    bytes and every base address."""
    for unit in _UNITS:
        if row_bytes % unit == 0 and all(p % unit == 0 for p in pointers):
            return unit
    return 1


def gather_tile_units(n_windows: int, units_per_row: int, n_sms: int) -> int:
    """Units of a row one block copies: the whole row, split into column
    tiles (multiples of a warp's 32 units) until the grid has about
    `_BLOCKS_PER_SM` blocks per SM."""
    max_tiles = max(1, -(-units_per_row // _TILE_QUANTUM))
    want = max(1, -(-_BLOCKS_PER_SM * n_sms // max(n_windows, 1)))
    n_tiles = min(max_tiles, want)
    tile = -(-units_per_row // n_tiles)
    if units_per_row >= _TILE_QUANTUM:
        tile = -(-tile // _TILE_QUANTUM) * _TILE_QUANTUM
    while -(-units_per_row // tile) > _MAX_GRID_Y:
        tile *= 2
    return tile


def gather_smem_bytes(plan: DevicePlan) -> int:
    """Shared memory of one block: the staged source rows (int64) of up to
    `_ELEM_CHUNK` elements, then the window's tags (int32)."""
    return min(plan.window, _ELEM_CHUNK) * 8 + plan.max_warps * 4


def _check_kernel_inputs(table: torch.Tensor, plan: DevicePlan) -> None:
    if plan.device != table.device:
        raise ValueError(
            f"gather plan lives on {plan.device}, the table on {table.device}"
        )
    meta_shape = (plan.n_slices, 1) + (
        (plan.window,) if plan.packed else (2, plan.window))
    for arr, shape in ((plan.tags, (plan.n_slices, plan.max_warps)),
                       (plan.elem_meta, meta_shape)):
        if (arr.dtype != torch.int32 or not arr.is_contiguous()
                or tuple(arr.shape) != shape):
            raise ValueError(
                f"gather plan arrays must be contiguous int32 of shapes "
                f"{shape}, got {arr.dtype} {tuple(arr.shape)}"
            )


def coalesced_gather_cuda(
    table: torch.Tensor,
    indices=None,
    *,
    window: int = 256,
    block_rows: int = 8,
    max_warps: Optional[int] = None,
    schedule: Optional[BlockSchedule] = None,
    plan: Optional[DevicePlan] = None,
    packed: Union[bool, str, None] = None,
    n_out: Optional[int] = None,
) -> torch.Tensor:
    """``table[indices]`` (n_out, D) in the table's dtype, copied by the CUDA
    kernel on the current stream through the plan. Each call that launches
    adds one to ``coalesced_gather_cuda.launches``."""
    if not table.is_cuda:
        raise ValueError(
            f"coalesced_gather_cuda launches a CUDA kernel: the table must "
            f"be a CUDA tensor, got one on {table.device} (kernels.ops "
            f"dispatches CPU tensors to the plain version)"
        )
    dplan, n_out = _resolve_call(
        table, indices, window=window, block_rows=block_rows,
        max_warps=max_warps, schedule=schedule, plan=plan, packed=packed,
        n_out=n_out,
    )
    _check_kernel_inputs(table, dplan)
    table = table.contiguous()
    R, D = table.shape
    out = torch.empty((n_out, D), dtype=table.dtype, device=table.device)
    row_bytes = D * table.element_size()
    if out.numel() == 0:
        return out
    if max(R, n_out, row_bytes) >= 2**31:
        raise ValueError(
            f"coalesced_gather_cuda takes rows, outputs and row bytes below "
            f"2**31, got R={R}, n_out={n_out}, row_bytes={row_bytes}"
        )
    smem = gather_smem_bytes(dplan)
    limit = _build.max_dynamic_smem(table.device)
    if smem > limit:
        raise ValueError(
            f"a gather block stages {smem} bytes of plan (window "
            f"{dplan.window}, {dplan.max_warps} warps), beyond the "
            f"{limit}-byte shared-memory limit"
        )
    unit = gather_unit(row_bytes, table.data_ptr(), out.data_ptr())
    units_per_row = row_bytes // unit
    tile = gather_tile_units(
        dplan.n_slices, units_per_row,
        torch.cuda.get_device_properties(table.device).multi_processor_count,
    )
    lib = _build.library()
    with torch.cuda.device(table.device):
        rc = lib.coalesced_gather_launch(
            ctypes.c_void_p(table.data_ptr()),
            ctypes.c_void_p(dplan.tags.data_ptr()),
            ctypes.c_void_p(dplan.elem_meta.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            int(dplan.packed), unit, dplan.n_slices, dplan.window,
            dplan.max_warps, dplan.block_rows, R, n_out, units_per_row, tile,
            min(dplan.window, _ELEM_CHUNK), _THREADS, smem,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    _build.check(rc, "coalesced_gather")
    coalesced_gather_cuda.launches += 1
    return out


coalesced_gather_cuda.launches = 0
