"""SELL SpMV fused with the coalesced indirect x-access: plan lowering, the
Hopper kernel's wrapper and its plain version (port of
`repro.kernels.sell_spmv`).

Layout: padded SELL (n_slices, W, H) with H = slice height, W a multiple of
`cols_per_chunk`. One *window* of the indirect stream = one (slice, chunk) =
cols_per_chunk * H indices, in storage order (column-major within the
slice), so element e of a window is SELL column ``e // H``, row ``e % H``.

`DevicePlan` is the kernel-ready, device-resident form of a `BlockSchedule`:
the SENTINEL-sanitized tag matrix plus the per-(slice, chunk) metadata
words, packed ``(warp << 16) | offset`` into one int32 (4 bytes/element)
whenever lossless, else two int32 lanes. Plan-owning callers
(`core.engine.SpMVEngine`) build it once and share it between this kernel
and the fused matmat kernel (`kernels.sell_spmm`); with a plan, `colidx` may
be None.

The kernel (`csrc/sell_spmv.cu`) replaces the TPU kernel
`repro/kernels/sell_spmv.py:sell_spmv_pallas`. It is bound by device-memory
bytes: per element it reads one value and one metadata word and does one
multiply-add. The TPU kernel extracts elements with a one-hot matmul on the
MXU; here persistent thread blocks (as many as fit on the card) each walk
groups of a few slices through a `buffer_depth`-stage `cp.async` ring in
shared memory: each stage holds one window's unique wide blocks of x (the
coalesced wide fetch; padding tag slots are skipped), its values and its
metadata words, and the next windows' copies are in flight while a thread
per row reads its elements at ``stage[warp][offset]``. `launch_config`
sizes the ring; a window whose wide blocks exceed the budget of one stage
is split into groups of warps, each a step of the same ring. The shared
body (`csrc/sell_common.cuh`) is also the SpMM kernel's: SpMV is its
one-column instance.

On a CUDA tensor `sell_spmv_cuda` launches the kernel or raises; on a CPU
tensor `kernels.ops.sell_spmv` takes `sell_spmv_plain`, which follows the
same plan (tags plus decoded metadata) in plain torch.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Union

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


@dataclasses.dataclass
class DevicePlan:
    """Kernel-ready coalescer plan: what both SELL kernels consume.

    tags:      (n_windows, max_warps) int32 — per-window wide-block ids with
               SENTINEL slots remapped to 0 (a SENTINEL tag is never hit by
               any `elem_warp`, so block 0 is a safe dummy fetch target).
    elem_meta: the per-element indirect-stream words, shaped to the
               (slice, chunk) grid the kernels iterate.
               packed=True  -> (n_slices, n_chunks, window) int32, each word
                               ``(elem_warp << 16) | elem_offset``;
               packed=False -> (n_slices, n_chunks, 2, window) int32, lane 0
                               elem_warp, lane 1 elem_offset.
    """

    tags: torch.Tensor
    elem_meta: torch.Tensor
    window: int
    block_rows: int
    cols_per_chunk: int
    slice_height: int
    n_slices: int
    n_chunks: int
    packed: bool

    @property
    def max_warps(self) -> int:
        return int(self.tags.shape[1])

    @property
    def elem_warp(self) -> torch.Tensor:
        """(n_slices, n_chunks, window) int32 warp ids, whatever the encoding."""
        return _decode_meta(self.elem_meta, packed=self.packed)[0]

    @property
    def elem_offset(self) -> torch.Tensor:
        """(n_slices, n_chunks, window) int32 offsets, whatever the encoding."""
        return _decode_meta(self.elem_meta, packed=self.packed)[1]

    @property
    def meta_bytes_per_element(self) -> int:
        return META_BYTES_PACKED if self.packed else META_BYTES_UNPACKED

    @property
    def device(self) -> torch.device:
        return self.tags.device


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


def build_device_plan(
    schedule: BlockSchedule,
    *,
    n_slices: int,
    cols_per_chunk: int,
    slice_height: int,
    packed: Union[bool, str] = "auto",
) -> DevicePlan:
    """Lower a `BlockSchedule` to the `DevicePlan` both SELL kernels consume,
    on the schedule's device. Validates that the schedule was built for
    exactly this (slice, chunk) geometry."""
    window = int(cols_per_chunk) * int(slice_height)
    if schedule.window != window:
        raise ValueError(
            f"schedule was planned for window={schedule.window}, but "
            f"cols_per_chunk={cols_per_chunk} x slice_height={slice_height} "
            f"needs window={window}"
        )
    if n_slices < 1 or schedule.n_windows % n_slices != 0:
        raise ValueError(
            f"schedule covers {schedule.n_windows} windows, which does not "
            f"tile {n_slices} slices"
        )
    with span("repro.plan.schedule", stage="device_plan"):
        n_chunks = schedule.n_windows // n_slices
        use_packed = resolve_packing(packed, schedule)
        shape = (n_slices, n_chunks, window)
        ew = schedule.elem_warp.to(torch.int32).reshape(shape)
        eo = schedule.elem_offset.to(torch.int32).reshape(shape)
        if use_packed:
            # Both halves fit 16 bits; warp >= 2**15 carries into the int32
            # sign bit. Pack in int64 and wrap explicitly to the
            # two's-complement word.
            word = (ew.to(torch.int64) << 16) | eo.to(torch.int64)
            elem_meta = torch.where(word >= 2**31, word - 2**32, word).to(
                torch.int32
            )
        else:
            elem_meta = torch.stack([ew, eo], dim=2)
        tags = torch.where(
            schedule.tags == SENTINEL, torch.zeros_like(schedule.tags),
            schedule.tags,
        )
        return DevicePlan(
            tags=tags.to(torch.int32).contiguous(),
            elem_meta=elem_meta.contiguous(),
            window=window,
            block_rows=int(schedule.block_rows),
            cols_per_chunk=int(cols_per_chunk),
            slice_height=int(slice_height),
            n_slices=int(n_slices),
            n_chunks=int(n_chunks),
            packed=use_packed,
        )


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
    if colidx is not None and tuple(colidx.shape) != (
        n_slices, W, slice_height
    ):
        raise ValueError(
            f"colidx shape {tuple(colidx.shape)} disagrees with the values "
            f"geometry ({n_slices}, {W}, {slice_height}); pad colidx and "
            f"values together (core.runtime.pad_width)"
        )
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
        return plan
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


def plan_gather(plan: DevicePlan, X: torch.Tensor) -> torch.Tensor:
    """Every plan element's operand rows of X (n_cols, kk), gathered through
    the plan: row ``tags[window, warp] * block_rows + offset``, with rows
    past n_cols reading as 0. Returns (n_slices, n_chunks, C, H, kk)."""
    ew, eo = _decode_meta(plan.elem_meta, packed=plan.packed)
    tags = plan.tags.to(torch.int64).reshape(
        plan.n_slices, plan.n_chunks, plan.max_warps
    )
    row = torch.gather(tags, 2, ew.to(torch.int64)) * plan.block_rows + eo
    n_cols, kk = X.shape
    n_blocks = -(-n_cols // plan.block_rows)
    X_p = torch.zeros((n_blocks * plan.block_rows, kk), dtype=X.dtype,
                      device=X.device)
    X_p[:n_cols] = X
    return X_p[row].reshape(
        plan.n_slices, plan.n_chunks, plan.cols_per_chunk, plan.slice_height,
        kk,
    )


def _align128(nbytes: int) -> int:
    """Shared-memory sections start on 128-byte lines (csrc/sell_common.cuh:
    align128)."""
    return -(-nbytes // 128) * 128


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    """Launch geometry of the shared SELL body (`csrc/sell_common.cuh`).

    A slice takes ``slice_height * quads`` threads: thread (h, q) owns row h
    and `cols_per_thread` columns of the block's column tile, which is
    ``col_tile = cols_per_thread * quads`` columns of X wide; the grid has
    `col_tiles` columns, one where k <= col_tile. Each slice has a ring of
    `depth` stages of `stage_bytes`: `group` warps' (block_rows, col_tile)
    tiles of X, then a window's values and metadata words; the rings follow
    one zero row of col_tile floats."""

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
    as many slices as keep it near 256 threads and inside `smem_limit`."""
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
    meta_shape = (plan.n_slices, plan.n_chunks) + (
        (plan.window,) if plan.packed else (2, plan.window))
    for arr, shape in ((plan.tags, (plan.n_slices * plan.n_chunks,
                                    plan.max_warps)),
                       (plan.elem_meta, meta_shape)):
        if (arr.dtype != torch.int32 or not arr.is_contiguous()
                or tuple(arr.shape) != shape):
            raise ValueError(
                f"device plan arrays must be contiguous int32 of shapes "
                f"{shape}, got {arr.dtype} {tuple(arr.shape)}"
            )


def _launch_args(values, x, plan: DevicePlan):
    """The pointer and flag arguments both C launch functions start with."""
    return (
        ctypes.c_void_p(values.data_ptr()),
        ctypes.c_void_p(x.data_ptr()),
        ctypes.c_void_p(plan.tags.data_ptr()),
        ctypes.c_void_p(plan.elem_meta.data_ptr()),
    )


def _plan_config(values, plan: DevicePlan, *, k: int, cols_per_thread: int,
                 buffer_depth: int) -> LaunchConfig:
    return launch_config(
        n_slices=plan.n_slices, slice_height=plan.slice_height, k=k,
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
    n_slices, W, H = values.shape
    _check_width(W, cols_per_chunk, "sell_spmv")
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
    if y.numel() == 0:
        return y
    lib = _build.library()
    cfg = _plan_config(values, dplan, k=1, cols_per_thread=1,
                       buffer_depth=buffer_depth)
    with torch.cuda.device(values.device):
        rc = lib.sell_spmv_launch(
            *_launch_args(values, x, dplan),
            ctypes.c_void_p(y.data_ptr()),
            int(values.dtype == torch.bfloat16), int(dplan.packed),
            n_slices, dplan.n_chunks, cols_per_chunk, H, dplan.max_warps,
            block_rows, int(x.shape[0]),
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
    another summation order. Output in the promoted dtype (bf16 values x f32
    x -> f32)."""
    n_slices, W, H = values.shape
    _check_width(W, cols_per_chunk, "sell_spmv")
    _validate_buffer_depth(buffer_depth)
    dplan = resolve_device_plan(
        colidx, n_slices=n_slices, W=W, slice_height=H,
        cols_per_chunk=cols_per_chunk, block_rows=block_rows,
        max_warps=max_warps, schedule=schedule, plan=plan, packed=packed,
    )
    out_dtype = torch.promote_types(values.dtype, x.dtype)
    g = plan_gather(dplan, x[:, None])[..., 0].to(out_dtype)
    vals = values.reshape(n_slices, dplan.n_chunks, cols_per_chunk, H)
    y = torch.sum(vals.to(out_dtype) * g, dim=(1, 2))
    return y.reshape(-1)
