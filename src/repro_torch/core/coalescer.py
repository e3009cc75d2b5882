"""Functional model of the paper's parallel request coalescer (Sec. II-B).

Port of `repro.core.coalescer`. Three layers, all semantics-equivalent on
*what* gets fetched:

1. `cshr_reference_trace` — slow, step-exact emulation of the CSHR policy
   (numpy, identical to the JAX package's). Ground truth for tests.
2. `window_unique_counts` / `coalesce_stats` — vectorized numpy trace
   statistics (drive the perf model).
3. `build_block_schedule` and friends — torch schedule construction on the
   engine's device: per window, the padded list of unique wide-block tags
   ("request warps"), plus per-element (warp, offset) coordinates = the CSHR
   Hitmap/Offsets metadata. The JAX package vmaps one window at a time; here
   every operation is written as a batch over the window axis.

Terminology (paper -> here):
  wide DRAM block  -> `block` of `block_rows` consecutive table rows
  window (W reqs)  -> `window` consecutive indices
  CSHR tag         -> entry of `tags[w, :]`
  Hitmap           -> `elem_warp[w, :] == warp_id`
  Offsets          -> `elem_offset[w, :]`
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from .runtime import resolve_device

SENTINEL = int(np.iinfo(np.int32).max)

#: 16-bit halfword bound for the packed (warp << 16 | offset) plan encoding:
#: a schedule packs losslessly iff both elem_warp and elem_offset stay below
#: this (see `packable_schedule` / kernels.sell_spmv.build_device_plan).
PACK_LIMIT = 1 << 16

#: Metadata bytes per trace element each DevicePlan encoding ships: one int32
#: word packed, two (warp + offset) unpacked.
META_BYTES_PACKED = 4
META_BYTES_UNPACKED = 8


# ---------------------------------------------------------------------------
# 1. Step-exact CSHR reference (ground truth for tests)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CSHRTrace:
    """Per-issued-wide-access record of the CSHR policy on one window stream."""

    tags: List[int]  # wide-block address of each issued access, in issue order
    hitmaps: List[np.ndarray]  # bool (W,) — which window slots were served
    offsets: List[np.ndarray]  # int (hits,) — row offset within block per hit
    cycles: int  # coalescer-side cycles consumed (1 tag scan per cycle)


def cshr_reference_trace(
    indices: np.ndarray, *, window: int, block_rows: int
) -> CSHRTrace:
    """Emulate Sec. II-B exactly: windows of `window` oldest requests; each
    cycle the request watcher scans the window in parallel against one CSHR
    tag, absorbs all hits, issues the wide access, and the oldest remaining
    miss seeds the next tag. Partial final window = watchdog flush."""
    tags: List[int] = []
    hitmaps: List[np.ndarray] = []
    offsets: List[np.ndarray] = []
    cycles = 0
    n = len(indices)
    for lo in range(0, n, window):
        win = np.asarray(indices[lo : lo + window], dtype=np.int64)
        blocks = win // block_rows
        pending = np.ones(len(win), dtype=bool)
        while pending.any():
            first = int(np.argmax(pending))  # oldest pending request
            tag = int(blocks[first])
            hit = pending & (blocks == tag)
            tags.append(tag)
            hitmaps.append(hit.copy())
            offsets.append((win[hit] % block_rows).astype(np.int64))
            pending &= ~hit
            cycles += 1
    return CSHRTrace(tags=tags, hitmaps=hitmaps, offsets=offsets, cycles=cycles)


# ---------------------------------------------------------------------------
# 2. Vectorized trace statistics (perf model fast path)
# ---------------------------------------------------------------------------


def window_unique_counts(
    indices: np.ndarray, *, window: int, block_rows: int
) -> np.ndarray:
    """Per-window count of unique wide blocks (= wide accesses the parallel
    coalescer issues for that window). Fully vectorized; safe for 10^8 nnz."""
    idx = np.asarray(indices, dtype=np.int64)
    n = idx.size
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    blocks = idx // block_rows
    win_id = np.arange(n, dtype=np.int64) // window
    n_win = int(win_id[-1]) + 1
    # Unique (window, block) pairs via sort of a combined key.
    key = win_id * (blocks.max() + 1) + blocks
    key.sort()
    new = np.empty(n, dtype=bool)
    new[0] = True
    np.not_equal(key[1:], key[:-1], out=new[1:])
    uniq_win = key[new] // (blocks.max() + 1)
    counts = np.zeros(n_win, dtype=np.int64)
    np.add.at(counts, uniq_win, 1)
    return counts


def coalesce_stats(
    indices: np.ndarray, *, window: int, block_rows: int
) -> Tuple[int, float]:
    """(total wide element accesses, coalesce rate).

    Coalesce rate per the paper: effective indirect elements / data requested
    from downstream, in elements — i.e. nnz / (wide_accesses * block_rows)."""
    counts = window_unique_counts(indices, window=window, block_rows=block_rows)
    wide = int(counts.sum())
    if wide == 0:
        return 0, 0.0
    return wide, float(len(indices)) / float(wide * block_rows)


# ---------------------------------------------------------------------------
# 3. Torch schedule construction (kernels + engine), batched over windows
# ---------------------------------------------------------------------------


def _unique_padded(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise sorted unique values of 2-D `x` (n_windows, window), padded to
    k columns with SENTINEL. Returns (uniques (n_windows, k), counts).
    Values beyond k are dropped, as the JAX scatter's ``mode="drop"`` does:
    torch has no such mode, so the scatter writes into k + 1 slots with
    every out-of-range rank sent to the spare last slot, which is then cut."""
    s, _ = torch.sort(x, dim=1)
    is_new = torch.ones_like(s, dtype=torch.bool)
    is_new[:, 1:] = s[:, 1:] != s[:, :-1]
    rank = torch.cumsum(is_new.to(torch.int64), dim=1) - 1
    slot = torch.where(is_new & (rank < k), rank, torch.full_like(rank, k))
    out = torch.full((x.shape[0], k + 1), SENTINEL, dtype=x.dtype,
                     device=x.device)
    out.scatter_(1, slot, torch.where(is_new, s, torch.full_like(s, SENTINEL)))
    return out[:, :k].contiguous(), is_new.sum(dim=1)


@dataclasses.dataclass
class BlockSchedule:
    """Coalescer metadata for a whole index stream, kernel-ready.

    tags:        (n_windows, max_warps) int32 — unique block ids per window,
                 SENTINEL-padded ("request warp" tags, sorted within window).
    n_warps:     (n_windows,) int32 — valid warps per window.
    elem_warp:   (n_windows, window) int32 — which warp serves each element
                 (the inverse Hitmap).
    elem_offset: (n_windows, window) int32 — row offset within the wide block
                 (the CSHR Offsets field).
    elem_valid:  (n_windows, window) bool — False on stream-tail padding.
    Padding elements never allocate warps of their own: a partial final
    window issues exactly the wide accesses the CSHR watchdog flush would
    (pad lanes are remapped onto the window's first valid block, offset 0).
    All tensors live on one device (the engine's).
    """

    tags: torch.Tensor
    n_warps: torch.Tensor
    elem_warp: torch.Tensor
    elem_offset: torch.Tensor
    elem_valid: torch.Tensor
    window: int
    block_rows: int

    @property
    def n_windows(self) -> int:
        return int(self.tags.shape[0])

    @property
    def max_warps(self) -> int:
        return int(self.tags.shape[1])

    @property
    def device(self) -> torch.device:
        return self.tags.device


def _schedule_windows(
    win: torch.Tensor, valid: torch.Tensor, block_rows: int, max_warps: int
):
    """`repro`'s `_schedule_one_window`, written out over all windows at once.
    win/valid: (n_windows, window) int32/bool."""
    blocks = torch.div(win, block_rows, rounding_mode="floor")
    # Tail-padding lanes must not mint warps: remap invalid lanes onto the
    # window's first valid block before tag generation (argmax of a bool
    # mask needs an int cast in torch; ties resolve to the first index).
    first_pos = torch.argmax(valid.to(torch.int32), dim=1, keepdim=True)
    first = torch.gather(blocks, 1, first_pos)
    blocks = torch.where(valid, blocks, first)
    tags, n = _unique_padded(blocks, max_warps)
    # warp id of each element = position of its block in the sorted tags
    elem_warp = torch.searchsorted(tags, blocks).to(torch.int32)
    elem_offset = torch.where(
        valid, torch.remainder(win, block_rows), torch.zeros_like(win)
    ).to(torch.int32)
    return tags.to(torch.int32), n.to(torch.int32), elem_warp, elem_offset


def plan_device(indices, device=None) -> torch.device:
    """Where a schedule of `indices` lives: `device` if given, else a
    tensor's own device, else the card (`runtime.resolve_device`)."""
    if device is None and torch.is_tensor(indices):
        return indices.device
    return resolve_device(device)


def build_block_schedule(
    indices,
    *,
    window: int,
    block_rows: int,
    max_warps: Optional[int] = None,
    device=None,
) -> BlockSchedule:
    """Vectorized schedule over all windows. `indices` is 1-D (numpy or a
    tensor); the schedule lives on `device` (see `plan_device`). The tail is
    padded (valid=False) without contributing warps, so `n_warps` agrees
    with the CSHR trace even on partial final windows."""
    dev = plan_device(indices, device)
    idx = torch.as_tensor(np.asarray(indices) if not torch.is_tensor(indices)
                          else indices)
    idx = idx.to(dev).to(torch.int32).reshape(-1)
    n = int(idx.shape[0])
    n_windows = max(1, -(-n // window))
    total = n_windows * window
    idx_p = torch.zeros(total, dtype=torch.int32, device=idx.device)
    idx_p[:n] = idx
    valid = (torch.arange(total, device=idx.device) < n).reshape(
        n_windows, window
    )
    if max_warps is None:
        max_warps = window  # always sufficient
    tags, n_warps, elem_warp, elem_offset = _schedule_windows(
        idx_p.reshape(n_windows, window), valid, block_rows, max_warps
    )
    return BlockSchedule(
        tags=tags,
        n_warps=n_warps,
        elem_warp=elem_warp,
        elem_offset=elem_offset,
        elem_valid=valid,
        window=window,
        block_rows=block_rows,
    )


def trim_schedule_warps(schedule: BlockSchedule) -> BlockSchedule:
    """Drop all-SENTINEL warp columns from a built schedule: trim the tag
    matrix to the stream's true per-window maximum warp count. `elem_warp`
    always indexes below `n_warps`, so dropped columns were never reachable."""
    used = max(int(schedule.n_warps.max()) if schedule.n_warps.numel() else 1,
               1)
    if used >= schedule.max_warps:
        return schedule
    return dataclasses.replace(
        schedule, tags=schedule.tags[:, :used].contiguous()
    )


def packable_schedule(schedule: BlockSchedule) -> bool:
    """True iff this schedule's metadata fits the packed 16/16-bit encoding.
    `elem_warp < max_warps` and `elem_offset < block_rows`, so the geometry
    bounds are sufficient — no element scan needed."""
    return schedule.max_warps <= PACK_LIMIT and schedule.block_rows <= PACK_LIMIT


def schedule_meta_bytes(schedule: BlockSchedule, *, packed: bool) -> int:
    """Total device metadata bytes a kernel streams for this schedule: the
    per-window tag matrix plus one (packed) or two (unpacked) int32 words per
    trace element."""
    per_elem = META_BYTES_PACKED if packed else META_BYTES_UNPACKED
    n_elems = schedule.n_windows * schedule.window
    return int(schedule.tags.numel()) * 4 + n_elems * per_elem


def resolve_schedule(
    indices,
    *,
    window: int,
    block_rows: int,
    max_warps: Optional[int] = None,
    schedule: Optional[BlockSchedule] = None,
    device=None,
) -> Tuple[BlockSchedule, int]:
    """Shared prebuilt-vs-build schedule resolution. Returns
    ``(schedule, max_warps)``. A prebuilt `schedule` must have been built for
    this exact plan geometry *and* this stream's length — mismatches raise.
    A schedule built here lives on `device` (see `plan_device`)."""
    n = int(indices.shape[0])
    if schedule is not None:
        if schedule.window != window or schedule.block_rows != block_rows:
            raise ValueError(
                f"schedule was planned for (window={schedule.window}, "
                f"block_rows={schedule.block_rows}), call expects "
                f"(window={window}, block_rows={block_rows})"
            )
        expected_windows = max(1, -(-n // window))
        if schedule.n_windows != expected_windows:
            raise ValueError(
                f"schedule covers {schedule.n_windows} windows but a "
                f"{n}-element stream needs {expected_windows}"
            )
        return schedule, schedule.max_warps
    if max_warps is None:
        max_warps = window
    return (
        build_block_schedule(
            indices, window=window, block_rows=block_rows,
            max_warps=max_warps, device=device,
        ),
        max_warps,
    )


def schedule_gather_reference(
    table: torch.Tensor, schedule: BlockSchedule, n_out: int
) -> torch.Tensor:
    """Execute a schedule against a (rows, d) table the way the data path
    does — each element reads its warp's wide block at its offset — and
    return elements in original stream order. Exact (a pure gather); the
    reference executor and the kernels' oracle. Rows past the table's end
    read as 0, like the JAX package's zero-padded blocks."""
    rows, d = table.shape
    br = schedule.block_rows
    n_blocks = -(-rows // br)
    padded = torch.zeros((n_blocks * br, d), dtype=table.dtype,
                         device=table.device)
    padded[:rows] = table
    safe_tags = torch.where(
        schedule.tags == SENTINEL, torch.zeros_like(schedule.tags),
        schedule.tags,
    ).to(torch.int64)
    elem_tag = torch.gather(safe_tags, 1, schedule.elem_warp.to(torch.int64))
    row = elem_tag * br + schedule.elem_offset.to(torch.int64)
    return padded[row.reshape(-1)[:n_out]]
