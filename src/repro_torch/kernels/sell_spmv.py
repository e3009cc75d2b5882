"""SELL SpMV fused with the coalesced indirect x-access: plan lowering, the
Hopper kernel's wrapper and its plain version (port of
`repro.kernels.sell_spmv`).

Layout: SELL with slice height H, each slice's width a multiple of
`cols_per_chunk`. One *window* of the indirect stream = one (slice, chunk) =
cols_per_chunk * H indices, in storage order (column-major within the
slice), so element e of a window is the chunk's column ``e // H``, row
``e % H``. A plan covers the slices' windows end to end: the engine's cuda
plan each slice at its own width, a plan built without per-slice counts
every slice at one width W ((n_slices, W, H) SELL, the same bytes).

`DevicePlan` is the kernel-ready, device-resident form of a `BlockSchedule`:
the SENTINEL-sanitized tag matrix plus the per-window metadata words,
packed ``(warp << 16) | offset`` into one int32 (4 bytes/element) whenever
lossless, else two int32 lanes, and the work list the kernels walk: items
of (slice, first window, window count), a slice cut into several items only
where it holds more than a balanced share of the windows, each such item
summing into a partial row that a fixed-order combine adds up. Plan-owning
callers (`core.engine.SpMVEngine`) build it once and share it between this
kernel and the fused matmat kernel (`kernels.sell_spmm`); with a plan,
`colidx` may be None.

The kernel (`csrc/sell_spmv.cu`) replaces the TPU kernel
`repro/kernels/sell_spmv.py:sell_spmv_pallas`. It is bound by device-memory
bytes: per element it reads one value and one metadata word and does one
multiply-add. The TPU kernel extracts elements with a one-hot matmul on the
MXU; here persistent thread blocks (as many as fit on the card) hold a few
slots each, and a slot walks items through a `buffer_depth`-stage
`cp.async` ring in shared memory: each stage holds one window's unique wide
blocks of x (the coalesced wide fetch; padding tag slots are skipped), its
values and its metadata words, and the next windows' copies are in flight
while a thread per row reads its elements at ``stage[warp][offset]``.
`launch_config` sizes the ring; a window whose wide blocks exceed the
budget of one stage is split into groups of warps, each a step of the same
ring. The shared body (`csrc/sell_common.cuh`) is also the SpMM kernel's:
SpMV is its one-column instance.

On a CUDA tensor `sell_spmv_cuda` launches the kernel or raises; on a CPU
tensor `kernels.ops.sell_spmv` takes `sell_spmv_plain`, which follows the
same plan (tags plus decoded metadata) in plain torch.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core.coalescer import (
    BlockSchedule,
    META_BYTES_PACKED,
    META_BYTES_UNPACKED,
    PACK_LIMIT,
    SENTINEL,
    packable_schedule,
    resolve_schedule,
)
from repro_torch.core.spans import span

from . import _build

#: Default pipeline depth of both SELL kernels: the stages of their
#: `cp.async` ring (as in the JAX package, where it is the Pallas ring's).
DEFAULT_BUFFER_DEPTH = 2

#: Upper bound on the pipeline depth.
MAX_BUFFER_DEPTH = 8

#: Value dtypes the kernels take (x/X must be float32); they accumulate in
#: float32.
KERNEL_VALUE_DTYPES = (torch.float32, torch.bfloat16)

#: Threads a block aims for: 256 (eight warps) keeps several blocks per SM.
_TARGET_THREADS = 256
_MAX_THREADS = 1024
#: Widest column tile of X a block covers: 16 threads of 8 columns a row.
MAX_COL_TILE = 128
#: Float64 products the plain versions form in one pass (`plan_sums`).
_PLAIN_PASS_PRODUCTS = 1 << 24
#: SMs and resident threads an SM holds, where the plan's device has none
#: (the CPU, where the plain versions run): the H100 the kernels target.
_H100_SMS, _H100_THREADS_PER_SM = 132, 2048


@dataclasses.dataclass
class DevicePlan:
    """Kernel-ready coalescer plan: what both SELL kernels consume.

    tags:      (n_windows, max_warps) int32 — per-window wide-block ids with
               SENTINEL slots remapped to 0 (a SENTINEL tag is never hit by
               any `elem_warp`, so block 0 is a safe dummy fetch target).
    elem_meta: the per-element indirect-stream words, one row a window:
               packed=True  -> (n_windows, window) int32, each word
                               ``(elem_warp << 16) | elem_offset``;
               packed=False -> (n_windows, 2, window) int32, lane 0
                               elem_warp, lane 1 elem_offset.
    slice_chunk_ptr: (n_slices + 1,) int32 — the first window of each slice
               (the last entry is n_windows).
    items:     (n_items, 4) int32 — the work list: (slice, first window,
               window count, partial row or -1), heaviest first. A slice is
               one item (partial -1: it stores its rows) unless it holds
               more than `item_share` windows; then it is cut into near-equal
               items, each of which stores a partial row.
    combine:   (split_slices, 3) int32 — (slice, first partial row,
               partial rows) of each cut slice: its rows are the sum of
               those partial rows in order.
    n_chunks:  the widest slice's chunk count (the padded grid's bound);
               `n_windows` counts the windows the kernels walk.

    The gather's plans (`coalesced_gather.build_gather_plan`) walk no work
    list: their `slice_chunk_ptr`, `items` and `combine` are None.
    """

    tags: torch.Tensor
    elem_meta: torch.Tensor
    window: int
    block_rows: int
    cols_per_chunk: int
    slice_height: int
    n_slices: int
    n_chunks: int
    n_windows: int
    packed: bool
    slice_chunk_ptr: Optional[torch.Tensor] = None
    items: Optional[torch.Tensor] = None
    combine: Optional[torch.Tensor] = None
    split_slices: int = 0
    n_partials: int = 0
    item_share: int = 0

    @property
    def max_warps(self) -> int:
        return int(self.tags.shape[1])

    @property
    def n_items(self) -> int:
        return int(self.items.shape[0])

    @property
    def meta_shape(self) -> tuple:
        return (self.n_windows,) + ((self.window,) if self.packed
                                    else (2, self.window))

    @property
    def elem_warp(self) -> torch.Tensor:
        """(n_windows, window) int32 warp ids, whatever the encoding."""
        return _decode_meta(self.elem_meta, packed=self.packed)[0]

    @property
    def elem_offset(self) -> torch.Tensor:
        """(n_windows, window) int32 offsets, whatever the encoding."""
        return _decode_meta(self.elem_meta, packed=self.packed)[1]

    @property
    def meta_bytes_per_element(self) -> int:
        return META_BYTES_PACKED if self.packed else META_BYTES_UNPACKED

    @property
    def device(self) -> torch.device:
        return self.tags.device


def resident_slots(device, slice_height: int) -> int:
    """The most slices the one-column kernel can walk at once on `device`:
    one slot of `slice_height` threads a slice, as many as its SMs hold
    threads (shared memory admits fewer, so a share sized from this cuts
    items finer than the kernel needs, never coarser)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        sms = props.multi_processor_count
        threads = getattr(props, "max_threads_per_multi_processor",
                          _H100_THREADS_PER_SM)
    else:
        sms, threads = _H100_SMS, _H100_THREADS_PER_SM
    return sms * max(1, threads // int(slice_height))


def item_share(slice_windows: np.ndarray, slots: int) -> int:
    """The most windows one work item holds: the mean walk of `slots`
    slots, ``ceil(n_windows / slots)``, but never below the lightest
    slice, which is an item of its own (no walk is shorter than it, so
    items cut finer would not shorten the longest walk). A plan whose
    slices all hold the same windows is never cut."""
    counts = np.asarray(slice_windows, dtype=np.int64)
    if counts.size == 0:
        return 1
    return max(1, -(-int(counts.sum()) // max(1, int(slots))),
               int(counts.min()))


def work_list(slice_windows: np.ndarray, share: int):
    """The work list of slices holding `slice_windows` windows each, laid
    end to end: ``(items, combine)`` as `DevicePlan` holds them (numpy
    int32). A slice of more than `share` windows is cut into
    ``ceil(windows / share)`` items whose sizes differ by at most one;
    partial rows are numbered slice by slice, in window order. Items are
    ordered heaviest first (stably, so equal items keep slice order), which
    a slot walking items ``slot, slot + slots, ...`` balances to within
    one item."""
    counts = np.asarray(slice_windows, dtype=np.int64)
    ns = counts.size
    pieces = np.maximum(1, -(-counts // int(share)))
    slice_ptr = np.zeros(ns + 1, dtype=np.int64)
    slice_ptr[1:] = np.cumsum(counts)
    item_slice = np.repeat(np.arange(ns, dtype=np.int64), pieces)
    first_item = np.cumsum(pieces) - pieces
    j = np.arange(item_slice.size, dtype=np.int64) - first_item[item_slice]
    base, extra = counts // pieces, counts % pieces
    size = base[item_slice] + (j < extra[item_slice])
    first = (slice_ptr[:-1][item_slice] + j * base[item_slice]
             + np.minimum(j, extra[item_slice]))
    is_part = (pieces > 1)[item_slice]
    part = np.where(is_part, np.cumsum(is_part) - 1, -1)
    split = np.flatnonzero(pieces > 1)
    combine = np.stack([split, part[first_item[split]], pieces[split]],
                       axis=1) if split.size else np.zeros((0, 3), np.int64)
    order = np.argsort(-size, kind="stable")
    items = np.stack([item_slice, first, size, part], axis=1)[order]
    return items.astype(np.int32), combine.astype(np.int32)


def resolve_packing(packed: Union[bool, str], schedule: BlockSchedule) -> bool:
    """Resolve a packing request against a schedule's geometry: ``"auto"``
    packs whenever lossless; ``True`` demands packing and raises if the
    geometry overflows the narrow encoding; ``False`` always unpacks."""
    if packed == "auto":
        return packable_schedule(schedule)
    if packed and not packable_schedule(schedule):
        raise ValueError(
            f"packed metadata needs elem_warp < {PACK_LIMIT} and "
            f"elem_offset < {PACK_LIMIT}, but the schedule has "
            f"max_warps={schedule.max_warps}, "
            f"block_rows={schedule.block_rows}; use packed='auto' to fall "
            f"back to the unpacked int32 encoding"
        )
    return bool(packed)


def lower_schedule(
    schedule: BlockSchedule,
    *,
    n_slices: int,
    cols_per_chunk: int,
    slice_height: int,
    packed: Union[bool, str] = "auto",
) -> DevicePlan:
    """The tags and metadata words of a `BlockSchedule` as a `DevicePlan`
    with no work list, on the schedule's device, from device operations
    alone (the gather lowers its streams inside captured steps:
    `coalesced_gather.build_gather_plan`). `n_chunks` is the windows per
    slice where they tile `n_slices`."""
    window = int(cols_per_chunk) * int(slice_height)
    if schedule.window != window:
        raise ValueError(
            f"schedule was planned for window={schedule.window}, but "
            f"cols_per_chunk={cols_per_chunk} x slice_height={slice_height} "
            f"needs window={window}"
        )
    use_packed = resolve_packing(packed, schedule)
    ew = schedule.elem_warp.to(torch.int32)
    eo = schedule.elem_offset.to(torch.int32)
    if use_packed:
        # Both halves fit 16 bits; warp >= 2**15 carries into the int32
        # sign bit. Pack in int64 and wrap explicitly to the
        # two's-complement word.
        word = (ew.to(torch.int64) << 16) | eo.to(torch.int64)
        elem_meta = torch.where(word >= 2**31, word - 2**32, word).to(
            torch.int32
        )
    else:
        elem_meta = torch.stack([ew, eo], dim=-2)
    tags = torch.where(
        schedule.tags == SENTINEL, torch.zeros_like(schedule.tags),
        schedule.tags,
    )
    n_windows = int(schedule.n_windows)
    return DevicePlan(
        tags=tags.to(torch.int32).contiguous(),
        elem_meta=elem_meta.contiguous(),
        window=window,
        block_rows=int(schedule.block_rows),
        cols_per_chunk=int(cols_per_chunk),
        slice_height=int(slice_height),
        n_slices=int(n_slices),
        n_chunks=n_windows // max(1, int(n_slices)),
        n_windows=n_windows,
        packed=use_packed,
    )


def build_device_plan(
    schedule: BlockSchedule,
    *,
    n_slices: int,
    cols_per_chunk: int,
    slice_height: int,
    packed: Union[bool, str] = "auto",
    slice_windows=None,
) -> DevicePlan:
    """Lower a `BlockSchedule` to the `DevicePlan` both SELL kernels consume,
    on the schedule's device. Validates that the schedule was built for
    exactly this (slice, chunk) geometry.

    The schedule covers slice s's ``slice_windows[s]`` windows, the slices
    end to end; without `slice_windows` every slice holds as many (SELL
    padded to one width). The work list cuts a slice holding more than
    `item_share` windows (sized from `resident_slots` of the schedule's
    device) into items. Recorded as the ``repro.plan.schedule`` span of
    stage ``device_plan``, with the windows walked, the slices cut and the
    share as attributes."""
    if slice_windows is None:
        if n_slices < 1 or schedule.n_windows % n_slices != 0:
            raise ValueError(
                f"schedule covers {schedule.n_windows} windows, which does "
                f"not tile {n_slices} slices"
            )
        counts = np.full(n_slices, schedule.n_windows // n_slices,
                         dtype=np.int64)
    else:
        counts = np.asarray(slice_windows, dtype=np.int64).reshape(-1)
        if (n_slices < 1 or counts.size != n_slices or counts.min() < 0
                or int(counts.sum()) != schedule.n_windows):
            raise ValueError(
                f"slice_windows must give each of the {n_slices} slices its "
                f"windows, {schedule.n_windows} in all, got {counts.size} "
                f"slices and {int(counts.sum())} windows"
            )
    with span("repro.plan.schedule", stage="device_plan") as rec:
        plan = lower_schedule(schedule, n_slices=n_slices,
                              cols_per_chunk=cols_per_chunk,
                              slice_height=slice_height, packed=packed)
        dev = plan.device
        share = item_share(counts, resident_slots(dev, slice_height))
        items, combine = work_list(counts, share)
        slice_ptr = np.zeros(n_slices + 1, dtype=np.int32)
        slice_ptr[1:] = np.cumsum(counts)
        plan = dataclasses.replace(
            plan,
            n_chunks=int(counts.max()),
            slice_chunk_ptr=torch.as_tensor(slice_ptr).to(dev),
            items=torch.as_tensor(items).to(dev),
            combine=torch.as_tensor(combine).to(dev),
            split_slices=len(combine),
            n_partials=int(combine[:, 2].sum()),
            item_share=int(share),
        )
        if rec is not None:
            rec.attrs.update(n_windows=plan.n_windows,
                             split_slices=plan.split_slices,
                             item_share=plan.item_share)
        return plan


def resolve_device_plan(
    colidx: Optional[torch.Tensor],
    *,
    n_slices: int,
    W: int,
    slice_height: int,
    cols_per_chunk: int,
    block_rows: int,
    max_warps: Optional[int],
    schedule: Optional[BlockSchedule],
    plan: Optional[DevicePlan],
    packed: Union[bool, str, None] = None,
) -> DevicePlan:
    """Shared plan resolution for both SELL kernels: a prebuilt `plan` wins
    (validated against the call geometry), else a prebuilt `schedule` is
    lowered, else the plan is built from `colidx` (which is only then
    required). The values array is the geometry of record."""
    n_chunks = W // cols_per_chunk
    if plan is not None:
        if (
            plan.n_slices != n_slices
            or plan.n_chunks != n_chunks
            or plan.slice_height != slice_height
            or plan.cols_per_chunk != cols_per_chunk
        ):
            raise ValueError(
                f"device plan was built for (n_slices={plan.n_slices}, "
                f"n_chunks={plan.n_chunks}, cols_per_chunk="
                f"{plan.cols_per_chunk}, slice_height={plan.slice_height}), "
                f"call expects (n_slices={n_slices}, n_chunks={n_chunks}, "
                f"cols_per_chunk={cols_per_chunk}, "
                f"slice_height={slice_height})"
            )
        if plan.block_rows != block_rows:
            raise ValueError(
                f"device plan was built for block_rows={plan.block_rows}, "
                f"call expects block_rows={block_rows}"
            )
        if packed not in (None, "auto") and bool(packed) != plan.packed:
            raise ValueError(
                f"device plan was built with packed={plan.packed}, call "
                f"expects packed={bool(packed)}; rebuild the plan "
                f"(build_device_plan) to change the metadata encoding"
            )
        if plan.items is None:
            raise ValueError(
                "device plan has no work list (a gather plan); build it "
                "with build_device_plan"
            )
        return plan
    if colidx is not None and tuple(colidx.shape) != (
        n_slices, W, slice_height
    ):
        raise ValueError(
            f"colidx shape {tuple(colidx.shape)} disagrees with the values "
            f"geometry ({n_slices}, {W}, {slice_height}); pad colidx and "
            f"values together (core.runtime.pad_width)"
        )
    if schedule is None:
        if colidx is None:
            raise ValueError(
                "colidx is required to build a plan; pass schedule= or "
                "plan= to run without the column-index array"
            )
        schedule, _ = resolve_schedule(
            colidx.reshape(-1),
            window=cols_per_chunk * slice_height,
            block_rows=block_rows,
            max_warps=max_warps,
        )
    else:
        expected = n_slices * n_chunks
        if schedule.n_windows != expected:
            raise ValueError(
                f"schedule covers {schedule.n_windows} windows but this "
                f"geometry has {expected}"
            )
        if schedule.block_rows != block_rows:
            raise ValueError(
                f"schedule was planned for block_rows={schedule.block_rows}, "
                f"call expects block_rows={block_rows}"
            )
    return build_device_plan(
        schedule,
        n_slices=n_slices,
        cols_per_chunk=cols_per_chunk,
        slice_height=slice_height,
        packed="auto" if packed is None else packed,
    )


def _decode_meta(meta: torch.Tensor, *, packed: bool):
    """Split metadata into (elem_warp, elem_offset) along its last axis
    (packed: (..., window); unpacked: (..., 2, window)). Torch's ``>>`` on
    int32 is arithmetic — warp ids >= 2**15 set the sign bit — so the high
    half is masked after the shift, which makes it the logical shift the
    JAX package uses."""
    if packed:
        return (meta >> 16) & 0xFFFF, meta & 0xFFFF
    return meta[..., 0, :], meta[..., 1, :]


def _validate_buffer_depth(buffer_depth: int) -> int:
    depth = int(buffer_depth)
    if not 1 <= depth <= MAX_BUFFER_DEPTH:
        raise ValueError(
            f"buffer_depth must be in [1, {MAX_BUFFER_DEPTH}], got "
            f"{buffer_depth}"
        )
    return depth


def _check_width(W: int, cols_per_chunk: int, name: str) -> None:
    if W % cols_per_chunk != 0:
        raise ValueError(
            f"{name} consumes SELL in chunks of {cols_per_chunk} columns "
            f"but the padded width is {W}; plan width-aware — pad W to a "
            f"multiple of cols_per_chunk (core.engine.SpMVEngine with "
            f"backend='cuda' does this at planning time)"
        )


def call_geometry(values: torch.Tensor, plan: Optional[DevicePlan],
                  cols_per_chunk: int, name: str):
    """A call's ``(n_slices, W, H)``. Without a plan, values are SELL padded
    to one width, (n_slices, W, H). With one, they are the plan's windows
    end to end, shaped (n_windows, cols_per_chunk, H) as
    `SpMVEngine.plan_values` gives them, or (n_slices, W, H) where every
    slice holds W / cols_per_chunk windows; W is the widest slice's."""
    if values.dim() != 3:
        raise ValueError(f"{name} takes values of 3 dimensions, got "
                         f"{tuple(values.shape)}")
    _check_width(int(values.shape[1]), cols_per_chunk, name)
    if plan is None:
        return tuple(int(d) for d in values.shape)
    if (values.numel() != plan.n_windows * plan.window
            or values.shape[2] != plan.slice_height):
        raise ValueError(
            f"the plan walks {plan.n_windows} windows of ("
            f"{plan.cols_per_chunk}, {plan.slice_height}) values, got "
            f"values of shape {tuple(values.shape)}"
        )
    return (plan.n_slices, plan.n_chunks * plan.cols_per_chunk,
            plan.slice_height)


def plan_gather(plan: DevicePlan, X: torch.Tensor) -> torch.Tensor:
    """Every plan element's operand rows of X (n_cols, kk), gathered through
    the plan: row ``tags[window, warp] * block_rows + offset``, with rows
    past n_cols reading as 0. Returns (n_windows, C, H, kk), windows in
    plan order."""
    ew, eo = _decode_meta(plan.elem_meta, packed=plan.packed)
    row = torch.gather(plan.tags.to(torch.int64), 1,
                       ew.to(torch.int64)) * plan.block_rows + eo
    n_cols, kk = X.shape
    n_blocks = -(-n_cols // plan.block_rows)
    X_p = torch.nn.functional.pad(X, (0, 0, 0, n_blocks * plan.block_rows
                                      - n_cols))
    # index_select rather than X_p[row]: on the CPU advanced indexing opens
    # a thread team even for a small gather, which stalls when processes
    # share the cores
    return X_p.index_select(0, row.reshape(-1)).reshape(
        plan.n_windows, plan.cols_per_chunk, plan.slice_height, kk
    )


def plan_sums(plan: DevicePlan, values: torch.Tensor, X: torch.Tensor,
              out_dtype: torch.dtype) -> torch.Tensor:
    """Rows ``(n_slices * H, k)`` of A @ X over the plan: every element's
    product added to its slice's row by a weighted `bincount`. The sums run
    in float64 (exact for the products of two float32 numbers, and far past
    float32 in the adding) and are rounded to `out_dtype` once, so how a
    kernel cuts a slice into items and adds its partial rows shows only as
    the kernel's own rounding. A pass takes as many columns as keep it near
    `_PLAIN_PASS_PRODUCTS` products (all of X at test sizes): at a million
    rows and 128 columns one pass would need ~40 GiB of indices alone."""
    H, k = plan.slice_height, X.shape[1]
    dev = X.device
    acc = torch.float64
    vals = values.reshape(-1, 1).to(acc)
    # element cc * H + h of a window of slice s adds to row s * H + h
    win_slice = torch.repeat_interleave(
        torch.arange(plan.n_slices, device=dev),
        plan.slice_chunk_ptr.diff().to(device=dev, dtype=torch.int64),
        output_size=plan.n_windows)
    h = torch.arange(H, device=dev).repeat(plan.cols_per_chunk)
    rows = (win_slice[:, None] * H + h[None, :]).reshape(-1, 1)
    step = max(1, _PLAIN_PASS_PRODUCTS // max(1, vals.shape[0]))
    out = []
    for q0 in range(0, k, step):
        kk = min(step, k - q0)
        prod = vals * plan_gather(plan, X[:, q0:q0 + kk].to(acc)).reshape(
            -1, kk)
        idx = rows * kk + torch.arange(kk, device=dev)
        out.append(torch.bincount(
            idx.reshape(-1), weights=prod.reshape(-1),
            minlength=plan.n_slices * H * kk).reshape(-1, kk))
    return torch.cat(out, dim=1).to(out_dtype)


def _align128(nbytes: int) -> int:
    """Shared-memory sections start on 128-byte lines (csrc/sell_common.cuh:
    align128)."""
    return -(-nbytes // 128) * 128


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    """Launch geometry of the shared SELL body (`csrc/sell_common.cuh`).

    A slot takes ``slice_height * quads`` threads: thread (h, q) owns row h
    of the item it walks and `cols_per_thread` columns of the block's
    column tile, which is
    ``col_tile = cols_per_thread * quads`` columns of X wide; the grid has
    `col_tiles` columns, one where k <= col_tile. Each of a block's
    `slices_per_block` slots has a ring of `depth` stages of `stage_bytes`:
    `group` warps' (block_rows, col_tile) tiles of X, then a window's values
    and metadata words; the rings follow one zero row of col_tile floats."""

    cols_per_thread: int
    quads: int
    col_tile: int
    col_tiles: int
    slices_per_block: int
    group: int
    depth: int
    stage_bytes: int
    smem_bytes: int
    threads: int


def launch_config(
    *, n_slices: int, slice_height: int, k: int, cols_per_thread: int,
    max_warps: int, block_rows: int, cols_per_chunk: int, value_bytes: int,
    packed: bool, buffer_depth: int, smem_limit: int,
) -> LaunchConfig:
    """Launch geometry of both kernels (SpMV: ``k = cols_per_thread = 1``;
    SpMM: ``cols_per_thread = 8``).

    The column tile is all of k up to `MAX_COL_TILE`, so values and
    metadata are read once per launch there, and once per tile beyond. A
    slice takes ``slice_height * quads`` threads; where that passes a
    block's 1,024 threads, fewer columns a row are taken, and a slice
    taller than 1,024 rows raises. The ring has `buffer_depth` stages; a
    stage stages all of a window's warps when ``buffer_depth`` of them fit
    `smem_limit`, else the largest group that does (one step of the ring a
    group); if not even one warp's tile fits, it raises. A block then takes
    as many slots (each walking work items, `n_slices` items in all: the
    plan's `n_items`) as keep it near 256 threads and inside
    `smem_limit`."""
    nc = int(cols_per_thread)
    H = int(slice_height)
    depth = _validate_buffer_depth(buffer_depth)
    if H > _MAX_THREADS:
        raise ValueError(
            f"slice_height = {H} threads exceeds a block's {_MAX_THREADS} "
            f"threads; lower slice_height"
        )
    quads = max(1, min(-(-int(k) // nc), MAX_COL_TILE // nc,
                       _MAX_THREADS // H))
    col_tile = nc * quads
    tps = H * quads
    per_warp = int(block_rows) * col_tile * 4
    window = int(cols_per_chunk) * H
    fixed = (_align128(window * int(value_bytes))
             + _align128(window * (1 if packed else 2) * 4))
    zero_row = _align128(col_tile * 4)
    budget = (smem_limit - zero_row) // depth
    if _align128(per_warp) + fixed > budget:
        raise ValueError(
            f"one stage of one wide block ({int(block_rows)} x {col_tile} "
            f"floats) plus a window's values and metadata ({fixed} B) "
            f"exceeds the {smem_limit}-byte shared-memory limit at "
            f"buffer_depth={depth}"
        )
    # whole 128-byte lines of tiles, so that the aligned stage fits too
    group = min(int(max_warps), (budget - fixed) // 128 * 128 // per_warp)
    stage = _align128(group * per_warp) + fixed
    slices = max(1, min(
        _TARGET_THREADS // tps,
        _MAX_THREADS // tps,
        int(n_slices),
        (smem_limit - zero_row) // (depth * stage),
    ))
    return LaunchConfig(
        cols_per_thread=nc, quads=quads, col_tile=col_tile,
        col_tiles=-(-int(k) // col_tile), slices_per_block=slices,
        group=group, depth=depth, stage_bytes=stage,
        smem_bytes=zero_row + slices * depth * stage,
        threads=slices * tps,
    )


def copy_unit(nbytes: int, *ptrs: int) -> int:
    """The widest piece (16, 4 or 2 bytes) that divides `nbytes` and every
    address in `ptrs`: the unit in which the kernels stage a window's
    values or metadata."""
    for unit in (16, 4, 2):
        if nbytes % unit == 0 and all(p % unit == 0 for p in ptrs):
            return unit
    raise ValueError(f"{nbytes} bytes at {ptrs} are not 2-byte aligned")


def _check_kernel_inputs(values, x, plan: DevicePlan, name: str) -> None:
    if not (values.is_cuda and x.is_cuda and values.device == x.device):
        raise ValueError(
            f"{name} launches a CUDA kernel: values and the right-hand side "
            f"must be CUDA tensors on one device, got {values.device} and "
            f"{x.device} (kernels.ops dispatches CPU tensors to the plain "
            f"version)"
        )
    if values.dtype not in KERNEL_VALUE_DTYPES or x.dtype != torch.float32:
        raise TypeError(
            f"{name} takes float32 or bfloat16 values with a float32 "
            f"right-hand side, got {values.dtype} and {x.dtype}"
        )
    if plan.device != values.device:
        raise ValueError(
            f"device plan lives on {plan.device}, values on {values.device}"
        )
    for arr, shape in ((plan.tags, (plan.n_windows, plan.max_warps)),
                       (plan.elem_meta, plan.meta_shape),
                       (plan.items, (plan.n_items, 4)),
                       (plan.combine, (plan.split_slices, 3))):
        if (arr.dtype != torch.int32 or not arr.is_contiguous()
                or tuple(arr.shape) != shape or arr.device != plan.device):
            raise ValueError(
                f"device plan arrays must be contiguous int32 of shapes "
                f"{shape}, got {arr.dtype} {tuple(arr.shape)}"
            )
    if values.numel() != plan.n_windows * plan.window:
        raise ValueError(
            f"the plan walks {plan.n_windows} windows of {plan.window} "
            f"values, but {values.numel()} values were given"
        )


def partial_rows(plan: DevicePlan, y: torch.Tensor) -> Optional[torch.Tensor]:
    """The scratch buffer a launch writes its cut slices' partial rows to,
    (n_partials, H, k) float32 on y's device and the current stream (None
    without cut slices): the combine adds them up in order into y."""
    if not plan.n_partials:
        return None
    k = y.shape[1] if y.dim() == 2 else 1
    return torch.empty((plan.n_partials, plan.slice_height, k),
                       dtype=torch.float32, device=y.device)


def _launch_args(values, x, plan: DevicePlan, y: torch.Tensor,
                 scratch: Optional[torch.Tensor]):
    """The pointer and work-list arguments both C launch functions start
    with: values, x/X, tags, meta, items, combine, y/Y, the partial rows
    (`partial_rows`), then values_bf16, packed, n_slices, n_items,
    n_windows, split_slices, n_partials."""
    return (
        ctypes.c_void_p(values.data_ptr()),
        ctypes.c_void_p(x.data_ptr()),
        ctypes.c_void_p(plan.tags.data_ptr()),
        ctypes.c_void_p(plan.elem_meta.data_ptr()),
        ctypes.c_void_p(plan.items.data_ptr()),
        ctypes.c_void_p(plan.combine.data_ptr()),
        ctypes.c_void_p(y.data_ptr()),
        ctypes.c_void_p(None if scratch is None else scratch.data_ptr()),
        int(values.dtype == torch.bfloat16), int(plan.packed),
        plan.n_slices, plan.n_items, plan.n_windows, plan.split_slices,
        plan.n_partials,
    )


def _plan_config(values, plan: DevicePlan, *, k: int, cols_per_thread: int,
                 buffer_depth: int) -> LaunchConfig:
    return launch_config(
        n_slices=plan.n_items, slice_height=plan.slice_height, k=k,
        cols_per_thread=cols_per_thread, max_warps=plan.max_warps,
        block_rows=plan.block_rows, cols_per_chunk=plan.cols_per_chunk,
        value_bytes=values.element_size(), packed=plan.packed,
        buffer_depth=buffer_depth,
        smem_limit=_build.max_dynamic_smem(values.device),
    )


def _ring_args(values, plan: DevicePlan, cfg: LaunchConfig, x_width: int,
               *rhs: torch.Tensor):
    """slices_per_block, group, depth, then the units in which a window's
    values, its metadata and its wide blocks of X are staged: X in 16-byte
    pieces when a copy row's `x_width` floats and every `rhs` address
    allow it, else 4-byte."""
    lanes = 1 if plan.packed else 2
    x16 = x_width % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in rhs)
    return (
        cfg.slices_per_block, cfg.group, cfg.depth,
        copy_unit(plan.window * values.element_size(), values.data_ptr()),
        copy_unit(plan.window * lanes * 4, plan.elem_meta.data_ptr()),
        16 if x16 else 4,
    )


def sell_spmv_cuda(
    colidx: Optional[torch.Tensor],  # (n_slices, W, H) int32, or None with a plan
    values: torch.Tensor,  # (n_slices, W, H) float32 | bfloat16, CUDA
    x: torch.Tensor,  # (n_cols,) float32, CUDA
    *,
    cols_per_chunk: int = 8,
    block_rows: int = 8,
    max_warps: Optional[int] = None,
    schedule: Optional[BlockSchedule] = None,
    plan: Optional[DevicePlan] = None,
    packed: Union[bool, str, None] = None,
    buffer_depth: int = DEFAULT_BUFFER_DEPTH,
) -> torch.Tensor:
    """Returns y = A @ x, y: (n_slices * H,) float32, computed by the CUDA
    kernel on the current stream. Semantics: ref.sell_spmv_ref. Each call
    that launches adds one to ``sell_spmv_cuda.launches`` (to ``.captured``
    while a CUDA graph is captured: `_build.count_launch`)."""
    n_slices, W, H = call_geometry(values, plan, cols_per_chunk, "sell_spmv")
    _validate_buffer_depth(buffer_depth)
    dplan = resolve_device_plan(
        colidx, n_slices=n_slices, W=W, slice_height=H,
        cols_per_chunk=cols_per_chunk, block_rows=block_rows,
        max_warps=max_warps, schedule=schedule, plan=plan, packed=packed,
    )
    _check_kernel_inputs(values, x, dplan, "sell_spmv_cuda")
    if x.dim() != 1:
        raise ValueError(f"sell_spmv expects x of shape (n_cols,), got "
                         f"{tuple(x.shape)}")
    values = values.contiguous()
    x = x.contiguous()
    y = torch.empty(n_slices * H, dtype=torch.float32, device=values.device)
    if y.numel() == 0 or dplan.n_windows == 0:  # no window: every row is 0
        return y.zero_()
    lib = _build.library()
    cfg = _plan_config(values, dplan, k=1, cols_per_thread=1,
                       buffer_depth=buffer_depth)
    scratch = partial_rows(dplan, y)
    with torch.cuda.device(values.device):
        rc = lib.sell_spmv_launch(
            *_launch_args(values, x, dplan, y, scratch),
            cols_per_chunk, H, dplan.max_warps, block_rows, int(x.shape[0]),
            *_ring_args(values, dplan, cfg, block_rows, x), cfg.smem_bytes,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    _build.check(rc, "sell_spmv")
    _build.count_launch(sell_spmv_cuda)
    return y


sell_spmv_cuda.launches = 0
sell_spmv_cuda.captured = 0


def sell_spmv_plain(
    colidx: Optional[torch.Tensor],
    values: torch.Tensor,
    x: torch.Tensor,
    *,
    cols_per_chunk: int = 8,
    block_rows: int = 8,
    max_warps: Optional[int] = None,
    schedule: Optional[BlockSchedule] = None,
    plan: Optional[DevicePlan] = None,
    packed: Union[bool, str, None] = None,
    buffer_depth: int = DEFAULT_BUFFER_DEPTH,
) -> torch.Tensor:
    """The kernel's plain-torch version: the same plan, the same function,
    summed in float64 (`plan_sums`). Output in the promoted dtype (bf16
    values x f32 x -> f32)."""
    n_slices, W, H = call_geometry(values, plan, cols_per_chunk, "sell_spmv")
    _validate_buffer_depth(buffer_depth)
    dplan = resolve_device_plan(
        colidx, n_slices=n_slices, W=W, slice_height=H,
        cols_per_chunk=cols_per_chunk, block_rows=block_rows,
        max_warps=max_warps, schedule=schedule, plan=plan, packed=packed,
    )
    out_dtype = torch.promote_types(values.dtype, x.dtype)
    return plan_sums(dplan, values, x[:, None], out_dtype).reshape(-1)
