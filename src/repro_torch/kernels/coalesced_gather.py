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
into ``nan`` across the window; the port does neither. Like the TPU kernel,
it reads each distinct row of a window once and writes it to every output
that names it; `gather_launch_config` chooses between its two paths (TMA
bulk copies through a shared-memory ring, or vector units for rows that
are not 16-byte multiples) and splits the work into items of about equal
bytes.

On a CUDA tensor `coalesced_gather_cuda` launches the kernel or raises; on a
CPU tensor `kernels.ops.coalesced_gather` takes `coalesced_gather_plain`,
which follows the same plan in plain torch.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core.coalescer import BlockSchedule, resolve_schedule

from . import _build
from .sell_spmv import DevicePlan, build_device_plan, plan_gather

#: Threads of one gather block (the bulk path's warp 0 drives the ring).
_THREADS = 256
#: Vector units the unit path copies with, widest first (bytes).
_UNITS = (16, 8, 4, 2, 1)
#: The widest column tile of a row one work item covers (bytes): one stage
#: of the bulk path's ring.
MAX_TILE_BYTES = 16384
#: Narrower rows take the unit path even where 16-byte aligned: the bulk
#: path keeps ``depth - 1`` row loads in flight a block, too few bytes for
#: narrow rows, while every thread of the unit path keeps a load in flight.
#: Timed in `chip_smoke.py` phase 4 (both paths on aligned rows of 64 B to
#: 8 KB): on an H100 the two are level at 4 KB, the unit path is ahead
#: below it and the bulk path above it.
BULK_MIN_ROW_BYTES = 4096
#: Bounds of the bulk path's ring: ``depth - 1`` stages are loading while
#: one is being stored.
MIN_GATHER_DEPTH, MAX_GATHER_DEPTH = 2, 8
#: Bytes of row tiles a block keeps loading ahead of its stores, which sets
#: the ring's depth where shared memory allows it.
IN_FLIGHT_BYTES = 49152
#: A window longer than this is taken in element chunks where its fan-out
#: tables and the ring do not fit together: the ring is sized first, beside
#: the tables of a chunk this long, and the chunk then takes what is left.
MIN_CHUNK = 256
#: The least bytes of output rows a work item aims for: building an item's
#: fan-out tables costs a few block-wide passes over its window.
MIN_ITEM_BYTES = 65536
#: Work items a block takes on average: blocks take items from a counter as
#: they finish, so items finer than one a block even out blocks that the
#: memory system serves at different rates.
ITEMS_PER_BLOCK = 4
#: Blocks a path aims to keep on each SM.
_BLOCKS_PER_SM = {"bulk": 2, "unit": 8}
#: Shared memory the hardware reserves per block, beside the dynamic part.
_SMEM_RESERVED = 1024
_I32_MAX = 2**31 - 1


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


def auto_path(row_bytes: int, unit: int) -> str:
    """The path `gather_launch_config` takes by default for rows of
    `row_bytes` whose bytes and bases allow `unit`-byte units: ``"bulk"``
    where the unit is 16 and a row has at least `BULK_MIN_ROW_BYTES`, else
    ``"unit"``."""
    return "bulk" if unit == 16 and row_bytes >= BULK_MIN_ROW_BYTES else "unit"


def _align(n: int, to: int) -> int:
    return -(-n // to) * to


def fanout_smem_bytes(*, chunk: int, max_warps: int, block_rows: int,
                      depth: int = 0, stage_bytes: int = 0) -> int:
    """Shared memory of one gather block, section by section as
    `csrc/coalesced_gather.cu:layout` lays it out: the ring's stages and
    their barriers (bulk path), the block scan's 64-bit word for each of a
    chunk's elements, the first occurrence of each of the window's
    ``max_warps * block_rows`` keys, the window's tags, and nine int32
    tables over the chunk's elements (keys, rows, first occurrences,
    counts, cursors, output lists, slot rows, real slots, list offsets)."""
    per = _align(4 * chunk, 16)
    return (depth * stage_bytes + _align(8 * depth, 16)
            + _align(8 * chunk, 16) + 8 * 34
            + _align(4 * max_warps * block_rows, 16)
            + _align(4 * max_warps, 16) + 8 * per
            + _align(4 * (chunk + 1), 16) + 16)


def _largest_chunk(limit: int, window: int, **keys) -> int:
    """The most elements of a window, at most `window`, whose fan-out
    tables fit `limit` bytes beside the other sections (0 if none); `keys`
    are `fanout_smem_bytes`' other arguments."""
    fixed = fanout_smem_bytes(chunk=0, **keys)
    chunk = max(0, min(window, (limit - fixed) // 44))  # 44 B an element
    while chunk and fanout_smem_bytes(chunk=chunk, **keys) > limit:
        chunk -= 1
    return chunk


@dataclasses.dataclass(frozen=True)
class GatherLaunch:
    """Launch geometry of the gather kernel (`csrc/coalesced_gather.cu`).

    Path ``"bulk"`` copies row tiles of `tile` bytes with TMA bulk copies
    through a ring of `depth` stages of `stage_bytes`; path ``"unit"``
    copies `unit`-byte vector units, `tile` of them an item (``depth =
    stage_bytes = 0``). A row is `row_units` units (bytes on the bulk path)
    in `n_tiles` column tiles. Each of the `windows` that hold outputs is
    taken in `chunks` chunks of `chunk` elements (one chunk of the whole
    window where its fan-out tables fit; each distinct row is read once a
    chunk). Each chunk is split into `groups_full` groups of distinct rows
    of about equal bytes, the last chunk of the last window into
    `groups_last`. `grid` persistent blocks of `threads`, each with
    `smem_bytes` of shared memory, take the `items` (window, chunk, group,
    tile) work items: the first by block index, the rest from a counter
    they share."""

    path: str
    unit: int
    row_units: int
    tile: int
    n_tiles: int
    depth: int
    stage_bytes: int
    windows: int
    chunk: int
    chunks: int
    groups_full: int
    groups_last: int
    items: int
    grid: int
    threads: int
    smem_bytes: int


def gather_launch_config(
    *, n_out: int, window: int, max_warps: int, block_rows: int,
    row_bytes: int, unit: int, n_sms: int, smem_limit: int,
    path: str = "auto",
) -> GatherLaunch:
    """Launch geometry of one gather call.

    `unit` is `gather_unit` of the row's bytes and both base addresses.
    ``path="auto"`` takes `auto_path`; ``"bulk"`` raises where the unit is
    not 16, ``"unit"`` is always possible. A column tile is at most
    `MAX_TILE_BYTES`. On the bulk path the ring is sized beside the fan-out
    tables of ``min(window, MIN_CHUNK)`` elements: as many stages as keep
    `IN_FLIGHT_BYTES` loading ahead of the stage being stored, fewer (down
    to `MIN_GATHER_DEPTH`) where shared memory is short, then narrower
    tiles. A window whose tables do not fit beside the ring is taken in
    the longest element chunks that do. Groups per chunk are chosen so
    that the items, of about equal bytes, number about `ITEMS_PER_BLOCK`
    for each block that fits the card but hold at least `MIN_ITEM_BYTES` of
    output rows (the last chunk gets groups in proportion to its
    elements). Raises `ValueError` where the key and tag tables alone, or
    the smallest ring beside them, pass `smem_limit`."""
    if path not in ("auto", "bulk", "unit"):
        raise ValueError(f"path must be 'auto', 'bulk' or 'unit', got "
                         f"{path!r}")
    if window < 1 or n_out < 1 or row_bytes < 1:
        raise ValueError(f"the gather kernel takes window >= 1, n_out >= 1 "
                         f"and row_bytes >= 1, got window={window}, "
                         f"n_out={n_out}, row_bytes={row_bytes}")
    if path == "auto":
        path = auto_path(row_bytes, unit)
    elif path == "bulk" and unit != 16:
        raise ValueError(
            f"the bulk path copies 16-byte multiples from 16-byte aligned "
            f"bases; this row of {row_bytes} B and its bases allow "
            f"{unit}-byte units (take path='unit')")
    keys = dict(max_warps=max_warps, block_rows=block_rows)
    tables = fanout_smem_bytes(chunk=1, **keys)
    if tables > smem_limit:
        raise ValueError(
            f"the fan-out tables of {max_warps} x {block_rows} keys take "
            f"{tables} bytes, beyond the {smem_limit}-byte shared-memory "
            f"limit; lower window or block_rows")
    n_tiles = -(-row_bytes // MAX_TILE_BYTES)
    depth = stage = 0
    if path == "bulk":
        c0 = min(window, MIN_CHUNK)
        while True:
            tile = _align(-(-row_bytes // n_tiles), 16)
            stage = _align(tile, 128)
            most = max(MIN_GATHER_DEPTH, min(MAX_GATHER_DEPTH,
                                             1 + IN_FLIGHT_BYTES // stage))
            depth = next((d for d in range(most, MIN_GATHER_DEPTH - 1, -1)
                          if fanout_smem_bytes(chunk=c0, depth=d,
                                               stage_bytes=stage, **keys)
                          <= smem_limit), 0)
            if depth:
                break
            if tile == 16:
                least = fanout_smem_bytes(chunk=c0, depth=MIN_GATHER_DEPTH,
                                          stage_bytes=stage, **keys)
                raise ValueError(
                    f"a ring of {MIN_GATHER_DEPTH} stages of 16 bytes beside "
                    f"the fan-out tables of {c0} elements takes {least} "
                    f"bytes, beyond the {smem_limit}-byte shared-memory "
                    f"limit")
            n_tiles *= 2
        row_units, unit = row_bytes, 16
    else:
        row_units = row_bytes // unit
        tile = -(-row_units // n_tiles)
    ring = dict(depth=depth, stage_bytes=stage, **keys)
    chunk = _largest_chunk(smem_limit, window, **ring)
    smem = fanout_smem_bytes(chunk=chunk, **ring)
    n_tiles = -(-row_units // tile)
    per_sm = max(1, min(_BLOCKS_PER_SM[path],
                        (smem_limit + _SMEM_RESERVED)
                        // (smem + _SMEM_RESERVED)))
    max_blocks = per_sm * n_sms
    windows = -(-n_out // window)
    n_last = n_out - (windows - 1) * window
    chunks, chunks_last = -(-window // chunk), -(-n_last // chunk)
    last = n_last - (chunks_last - 1) * chunk  # elements of the last chunk
    groups_full = max(1, min(
        chunk, ITEMS_PER_BLOCK * max_blocks * chunk // (n_tiles * n_out),
        chunk * row_bytes // MIN_ITEM_BYTES))
    groups_last = max(1, min(last, -(-groups_full * last // chunk)))
    items = (((windows - 1) * chunks + chunks_last - 1) * groups_full
             + groups_last) * n_tiles
    if items > _I32_MAX:
        raise ValueError(f"{items} work items pass the kernel's int32 index")
    return GatherLaunch(
        path=path, unit=unit, row_units=row_units, tile=tile,
        n_tiles=n_tiles, depth=depth, stage_bytes=stage, windows=windows,
        chunk=chunk, chunks=chunks, groups_full=groups_full,
        groups_last=groups_last, items=items, grid=min(items, max_blocks),
        threads=_THREADS, smem_bytes=smem,
    )


_queues: Dict[Tuple[int, int], torch.Tensor] = {}


def _work_queue(device: torch.device, stream) -> torch.Tensor:
    """The kernel's work counter for launches on `stream`: two int32 words
    that each launch leaves at zero (its last block resets them), so
    launches queued on one stream share them in turn, while launches on
    two streams, which may overlap, never share one. The set of counters
    is bounded because torch's streams are: `torch.cuda.Stream()` hands
    out the streams of a fixed pool per device and priority, so a server
    that makes a stream per request reuses the same few handles; only
    `torch.cuda.ExternalStream`, one per foreign handle, adds more."""
    key = (device.index, stream.cuda_stream)
    if key not in _queues:
        _queues[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return _queues[key]


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
    path: str = "auto",
) -> torch.Tensor:
    """``table[indices]`` (n_out, D) in the table's dtype, copied by the CUDA
    kernel on the current stream through the plan, with the geometry that
    `gather_launch_config` gives for `path`. Each call that launches adds
    one to ``coalesced_gather_cuda.launches``."""
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
    cfg = gather_launch_config(
        n_out=n_out, window=dplan.window, max_warps=dplan.max_warps,
        block_rows=dplan.block_rows, row_bytes=row_bytes,
        unit=gather_unit(row_bytes, table.data_ptr(), out.data_ptr()),
        n_sms=torch.cuda.get_device_properties(
            table.device).multi_processor_count,
        smem_limit=_build.max_dynamic_smem(table.device), path=path,
    )
    lib = _build.library()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream()
        rc = lib.coalesced_gather_launch(
            ctypes.c_void_p(table.data_ptr()),
            ctypes.c_void_p(dplan.tags.data_ptr()),
            ctypes.c_void_p(dplan.elem_meta.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(_work_queue(table.device, stream).data_ptr()),
            int(dplan.packed), 0 if cfg.path == "bulk" else cfg.unit,
            dplan.window, dplan.max_warps, dplan.block_rows, R, n_out,
            cfg.chunk, cfg.windows, cfg.row_units, cfg.tile, cfg.n_tiles,
            cfg.groups_full, cfg.groups_last, cfg.items, cfg.depth,
            cfg.stage_bytes, cfg.grid, cfg.threads, cfg.smem_bytes,
            ctypes.c_void_p(stream.cuda_stream),
        )
    _build.check(rc, "coalesced_gather")
    _build.count_launch(coalesced_gather_cuda)
    return out


coalesced_gather_cuda.launches = 0
coalesced_gather_cuda.captured = 0
