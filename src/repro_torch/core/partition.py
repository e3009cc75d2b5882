"""Cost-model-driven contiguous partitioning of SELL row slices.

SparseP (Giannoula et al., PAPERS.md) shows that *how* a sparse matrix is
split across near-memory banks is the decisive design axis for scaled-out
SpMV, and Serpens earns its HBM bandwidth only by striping rows so no
channel straggles. `core.dist.ShardedSpMVEngine` originally split by slice
*count* (`np.linspace`), which on the powerlaw family concentrates nnz in a
few shards while the rest idle behind one straggler. This module balances
the split by *predicted cost* instead:

  * `slice_costs` — a per-slice cycle estimate built from the same terms
    `perfmodel.spmv_perf` charges: padded nnz (value stream + VMAC compute),
    metadata bytes at the plan's real ``meta_bytes_per_elem``, and the
    slice's estimated wide accesses from `coalescer.window_unique_counts`
    (the paper's Sec. II-B statistic, attributed to the slice each window
    starts in).
  * `balanced_bounds` — the classic contiguous min-max partition: binary
    search on the max-shard-cost cap, greedy feasibility over prefix sums,
    then boundary construction with exactly ``n_shards`` non-empty parts.
  * `shard_costs_for_bounds` / `_cost_balanced_bounds` — the ``"cost"``
    strategy's width-aware variant. Per-shard width padding makes a
    shard's padded nnz ``n_slices * max_slice_width * H`` — a *monotone*
    but non-additive function of the slice range — so the cost objective
    is evaluated on the shard directly (running max width + wide-access
    sum) inside the same greedy-feasibility bisection; greedy stays exact
    for min-max under any extension-monotone cost.
  * `shard_bounds` — strategy front door. ``"even"`` keeps the legacy
    slice-count split, ``"nnz"`` balances padded nonzeros, ``"cost"``
    (what ``"auto"`` resolves to) balances the full cycle estimate, and
    ``"cost2d"`` refines the cost vector over a row x column-segment grid
    (SparseP-style): a shard's charge is its *densest* column segment
    scaled to the full stream, which penalizes slices whose nnz pile into
    one hub segment — the extreme-skew failure mode a 1D nnz balance
    cannot see. Execution stays row-sharded for every strategy (each shard
    is a contiguous slice range and a valid `SELLMatrix`), so the
    decomposition remains bit-identical to the single-device engine; the
    column-segment grid shapes the *objective*, not the data movement.

Shards are always contiguous slice ranges: boundaries live on slice
boundaries so every shard is a well-formed SELL matrix and the row ranges
tile ``[0, n_rows)`` exactly — the property the partition tests pin for
every strategy.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .coalescer import window_unique_counts
from .formats import SELLMatrix, sell_index_stream
from .perfmodel import DEFAULT_HW, HWConfig

PARTITION_STRATEGIES = ("even", "nnz", "cost", "cost2d")
DEFAULT_COL_SEGMENTS = 8


def resolve_partition(partition: str) -> str:
    """``"auto"`` -> ``"cost"``; anything else must name a strategy."""
    if partition == "auto":
        return "cost"
    if partition not in PARTITION_STRATEGIES:
        raise ValueError(
            f"partition must be one of {('auto',) + PARTITION_STRATEGIES}, "
            f"got {partition!r}"
        )
    return partition


def even_bounds(n_slices: int, n_shards: int) -> np.ndarray:
    """The legacy slice-count split (np.linspace semantics, so existing
    even-partition shard boundaries are unchanged)."""
    return np.linspace(0, n_slices, n_shards + 1).astype(np.int64)


def slice_nnz(sell: SELLMatrix) -> np.ndarray:
    """Padded nonzeros per slice (width * slice height) — the ``"nnz"``
    balance objective."""
    widths = np.asarray(sell.slice_widths, dtype=np.int64)
    return widths * int(sell.slice_height)


def _slice_wide_accesses(
    sell: SELLMatrix, *, window: int, block_rows: int
) -> np.ndarray:
    """Estimated wide accesses attributed per slice.

    The coalescer windows the flat index stream, and windows may straddle
    slice boundaries; each window's unique-block count is charged to the
    slice its first element lives in — exact for window-aligned slices
    (the pallas geometry) and a faithful estimate otherwise.
    """
    stream = sell_index_stream(sell)
    counts = window_unique_counts(
        stream, window=window, block_rows=block_rows
    )
    if counts.size == 0:
        return np.zeros(sell.n_slices, dtype=np.float64)
    win_starts = np.arange(counts.size, dtype=np.int64) * int(window)
    ptrs = np.asarray(sell.slice_ptrs, dtype=np.int64)
    owner = np.searchsorted(ptrs, win_starts, side="right") - 1
    owner = np.clip(owner, 0, sell.n_slices - 1)
    out = np.zeros(sell.n_slices, dtype=np.float64)
    np.add.at(out, owner, counts.astype(np.float64))
    return out


def slice_costs(
    sell: SELLMatrix,
    *,
    window: int,
    block_rows: int,
    meta_bytes_per_elem: Optional[float] = None,
    value_bytes_per_elem: Optional[float] = None,
    hw: HWConfig = DEFAULT_HW,
) -> np.ndarray:
    """Per-slice cycle estimate — `perfmodel.spmv_perf`'s charge decomposed
    to slice granularity so a contiguous partition can balance it.

    Per slice: VMAC compute on the padded nnz, the contiguous value +
    metadata streams at their real widths, and the slice's wide accesses
    (x-gather traffic) at DRAM access granularity. Compute and DRAM overlap
    under the prefetcher, so the slice costs ``max(compute, dram)`` — the
    same roofline `spmv_perf` takes, minus whole-matrix constants that
    cancel in a balance objective.
    """
    nnz_p = slice_nnz(sell).astype(np.float64)
    meta_bpe = (
        float(hw.index_bytes) if meta_bytes_per_elem is None
        else float(meta_bytes_per_elem)
    )
    value_bpe = (
        float(hw.elem_bytes) if value_bytes_per_elem is None
        else float(value_bytes_per_elem)
    )
    wide = _slice_wide_accesses(sell, window=window, block_rows=block_rows)
    compute = nnz_p * hw.vpc_cycles_per_nnz + 8.0
    stream_bytes = (
        nnz_p * (value_bpe + meta_bpe) + wide * hw.wide_access_bytes
    )
    dram = stream_bytes / hw.channel_bytes_per_cycle
    return np.maximum(compute, dram)


def _shard_cycle_cost(
    n_slices: float,
    max_width: float,
    wide: float,
    *,
    slice_height: int,
    meta_bpe: float,
    value_bpe: float,
    hw: HWConfig,
) -> float:
    """Cycle estimate for one contiguous shard padded to its own max slice
    width — the exact footprint `row_shard_sells` materializes: padded nnz
    is ``n_slices * max_width * H``, value + metadata stream at that width,
    plus the shard's wide accesses; compute and DRAM overlap (roofline
    max), matching `perfmodel.spmv_perf`'s dominant terms."""
    nnz_p = n_slices * max_width * slice_height
    compute = nnz_p * hw.vpc_cycles_per_nnz + n_slices * 8.0
    stream_bytes = nnz_p * (value_bpe + meta_bpe) + wide * hw.wide_access_bytes
    return max(compute, stream_bytes / hw.channel_bytes_per_cycle)


def shard_costs_for_bounds(
    sell: SELLMatrix,
    bounds: np.ndarray,
    *,
    window: int = 256,
    block_rows: int = 8,
    meta_bytes_per_elem: Optional[float] = None,
    value_bytes_per_elem: Optional[float] = None,
    hw: HWConfig = DEFAULT_HW,
) -> np.ndarray:
    """Width-aware cycle cost of each shard a ``bounds`` array induces —
    the ``"cost"`` strategy's objective, evaluable for *any* strategy's
    bounds so tests and reports can compare partitions in one unit."""
    bounds = np.asarray(bounds, dtype=np.int64)
    widths = np.asarray(sell.slice_widths, dtype=np.float64)
    wide = _slice_wide_accesses(sell, window=window, block_rows=block_rows)
    meta_bpe = (
        float(hw.index_bytes) if meta_bytes_per_elem is None
        else float(meta_bytes_per_elem)
    )
    value_bpe = (
        float(hw.elem_bytes) if value_bytes_per_elem is None
        else float(value_bytes_per_elem)
    )
    out = np.empty(bounds.size - 1, dtype=np.float64)
    for k in range(bounds.size - 1):
        a, b = int(bounds[k]), int(bounds[k + 1])
        out[k] = _shard_cycle_cost(
            b - a, widths[a:b].max(initial=0.0), wide[a:b].sum(),
            slice_height=sell.slice_height, meta_bpe=meta_bpe,
            value_bpe=value_bpe, hw=hw,
        )
    return out


def _cost_balanced_bounds(
    widths: np.ndarray,
    wide: np.ndarray,
    n_shards: int,
    *,
    slice_height: int,
    meta_bpe: float,
    value_bpe: float,
    hw: HWConfig,
) -> np.ndarray:
    """Min-max contiguous partition under the width-aware shard cost.

    The cost of extending a shard is monotone non-decreasing (slice count,
    running max width, and wide-access sum all grow), so the greedy
    take-maximal-prefix feasibility check stays exact for the min-max
    objective and bisection on the cap converges to the optimum; splitting
    parts afterwards (to hit exactly ``n_shards``) can only lower a
    monotone cost, so the final max never exceeds the cap."""
    n = widths.size
    if not 1 <= n_shards <= n:
        raise ValueError(
            f"need 1 <= n_shards <= n_slices, got n_shards={n_shards}, "
            f"n_slices={n}"
        )

    def cost(nsl, maxw, w):
        return _shard_cycle_cost(
            nsl, maxw, w, slice_height=slice_height,
            meta_bpe=meta_bpe, value_bpe=value_bpe, hw=hw,
        )

    def cuts_at(cap):
        cuts = [0]
        count, maxw, acc = 0, 0.0, 0.0
        for s in range(n):
            tc = cost(count + 1, max(maxw, widths[s]), acc + wide[s])
            if count > 0 and tc > cap:
                cuts.append(s)
                count, maxw, acc = 1, float(widths[s]), float(wide[s])
            else:
                count, maxw, acc = (
                    count + 1, max(maxw, float(widths[s])), acc + float(wide[s])
                )
        cuts.append(n)
        return cuts

    lo = max(cost(1, float(widths[s]), float(wide[s])) for s in range(n))
    hi = cost(n, float(widths.max(initial=0.0)), float(wide.sum()))
    for _ in range(64):
        mid = 0.5 * (lo + hi)
        if len(cuts_at(mid)) - 1 <= n_shards:
            hi = mid
        else:
            lo = mid
    cuts = cuts_at(hi)

    def part_cost(a, b):
        return cost(b - a, float(widths[a:b].max(initial=0.0)),
                    float(wide[a:b].sum()))

    while len(cuts) - 1 < n_shards:
        part_costs = [part_cost(cuts[p], cuts[p + 1])
                      for p in range(len(cuts) - 1)]
        for p in np.argsort(part_costs)[::-1]:
            a, b = cuts[p], cuts[p + 1]
            if b - a > 1:
                # best interior split: minimize the max of the two halves
                best_m, best_c = a + 1, float("inf")
                for m in range(a + 1, b):
                    c = max(part_cost(a, m), part_cost(m, b))
                    if c < best_c:
                        best_m, best_c = m, c
                cuts.insert(p + 1, best_m)
                break
        else:
            raise AssertionError("unsplittable partition state")
    return np.asarray(cuts, dtype=np.int64)


def _greedy_cuts(prefix: np.ndarray, cap: float) -> list:
    """Greedy cut points packing slices into parts of cost <= cap (every
    part takes at least one slice, so a single slice heavier than the cap
    still forms its own part). Returns the cut list including both ends."""
    n = prefix.size - 1
    cuts = [0]
    while cuts[-1] < n:
        nxt = int(
            np.searchsorted(prefix, prefix[cuts[-1]] + cap, side="right") - 1
        )
        nxt = max(nxt, cuts[-1] + 1)
        cuts.append(min(nxt, n))
    return cuts


def balanced_bounds(costs: np.ndarray, n_shards: int) -> np.ndarray:
    """Contiguous min-max partition of ``costs`` into ``n_shards`` parts:
    binary search on the max-shard-cost cap with a greedy feasibility
    check over the prefix sums, then split the heaviest parts until exactly
    ``n_shards`` non-empty parts remain (always possible for
    ``n_shards <= len(costs)``)."""
    costs = np.asarray(costs, dtype=np.float64)
    n = costs.size
    if not 1 <= n_shards <= n:
        raise ValueError(
            f"need 1 <= n_shards <= n_slices, got n_shards={n_shards}, "
            f"n_slices={n}"
        )
    if np.any(costs < 0):
        raise ValueError("slice costs must be non-negative")
    prefix = np.concatenate([[0.0], np.cumsum(costs)])
    lo, hi = float(costs.max(initial=0.0)), float(prefix[-1])
    for _ in range(64):
        mid = 0.5 * (lo + hi)
        if len(_greedy_cuts(prefix, mid)) - 1 <= n_shards:
            hi = mid
        else:
            lo = mid
    cuts = _greedy_cuts(prefix, hi)
    # Greedy at the optimum may use fewer parts than requested; split the
    # heaviest splittable part at its balanced interior point until exact.
    while len(cuts) - 1 < n_shards:
        part_costs = np.diff(prefix[cuts])
        order = np.argsort(part_costs)[::-1]
        for p in order:
            a, b = cuts[p], cuts[p + 1]
            if b - a > 1:
                target = 0.5 * (prefix[a] + prefix[b])
                m = int(np.searchsorted(prefix, target, side="right") - 1)
                m = min(max(m, a + 1), b - 1)
                cuts.insert(p + 1, m)
                break
        else:  # every part is a single slice — cannot happen (n_shards <= n)
            raise AssertionError("unsplittable partition state")
    return np.asarray(cuts, dtype=np.int64)


def _col_segment_costs(
    sell: SELLMatrix,
    *,
    n_segments: int,
    window: int,
    block_rows: int,
    meta_bytes_per_elem: Optional[float],
    value_bytes_per_elem: Optional[float],
    hw: HWConfig,
) -> np.ndarray:
    """(n_slices, n_segments) cost grid: each slice's stream traffic split
    by which column segment its indices land in (wide accesses estimated at
    segment granularity: distinct ``block_rows`` blocks per slice-segment).
    The SparseP-style 2D view — per-bank column locality — of the same
    stream `slice_costs` charges in 1D."""
    stream = np.asarray(sell_index_stream(sell), dtype=np.int64)
    ptrs = np.asarray(sell.slice_ptrs, dtype=np.int64)
    n_slices = sell.n_slices
    seg_width = max(1, -(-sell.n_cols // n_segments))
    seg = np.clip(stream // seg_width, 0, n_segments - 1)
    owner = (
        np.searchsorted(ptrs, np.arange(stream.size, dtype=np.int64),
                        side="right") - 1
    )
    owner = np.clip(owner, 0, n_slices - 1)
    meta_bpe = (
        float(hw.index_bytes) if meta_bytes_per_elem is None
        else float(meta_bytes_per_elem)
    )
    value_bpe = (
        float(hw.elem_bytes) if value_bytes_per_elem is None
        else float(value_bytes_per_elem)
    )
    # Element traffic per (slice, segment).
    flat = owner * n_segments + seg
    elems = np.bincount(flat, minlength=n_slices * n_segments).astype(
        np.float64
    ).reshape(n_slices, n_segments)
    # Distinct wide blocks per (slice, segment) — the segment-local gather
    # footprint (unique (slice, block) pairs, vectorized via sorted keys).
    blocks = stream // int(block_rows)
    key = flat.astype(np.int64) * (blocks.max(initial=0) + 1) + blocks
    key = np.sort(key)
    new = np.empty(key.size, dtype=bool)
    if key.size:
        new[0] = True
        np.not_equal(key[1:], key[:-1], out=new[1:])
    uniq_cell = key[new] // (blocks.max(initial=0) + 1) if key.size else key
    wide = np.bincount(
        uniq_cell.astype(np.int64), minlength=n_slices * n_segments
    ).astype(np.float64).reshape(n_slices, n_segments)
    stream_bytes = elems * (value_bpe + meta_bpe) + wide * hw.wide_access_bytes
    dram = stream_bytes / hw.channel_bytes_per_cycle
    compute = elems * hw.vpc_cycles_per_nnz
    return np.maximum(compute, dram)


def _balanced_bounds_2d(grid: np.ndarray, n_shards: int) -> np.ndarray:
    """Contiguous row partition minimizing the max *per-segment straggler*
    shard cost: a shard's charge is ``n_segments * max_g(sum_slices
    grid[s, g])`` — its densest column segment sets the pace when segments
    map to independent banks. Binary search on the cap; greedy extension
    keeps per-segment running sums (O(n_slices * n_segments) per probe)."""
    n, n_seg = grid.shape
    if not 1 <= n_shards <= n:
        raise ValueError(
            f"need 1 <= n_shards <= n_slices, got n_shards={n_shards}, "
            f"n_slices={n}"
        )

    def shard_cost(acc: np.ndarray) -> float:
        return float(acc.max()) * n_seg

    def cuts_at(cap: float) -> list:
        cuts = [0]
        acc = np.zeros(n_seg)
        for s in range(n):
            trial = acc + grid[s]
            if s > cuts[-1] and shard_cost(trial) > cap:
                cuts.append(s)
                acc = grid[s].copy()
            else:
                acc = trial
        cuts.append(n)
        return cuts

    lo = max(shard_cost(grid[s]) for s in range(n))
    hi = shard_cost(grid.sum(axis=0))
    for _ in range(48):
        mid = 0.5 * (lo + hi)
        if len(cuts_at(mid)) - 1 <= n_shards:
            hi = mid
        else:
            lo = mid
    cuts = cuts_at(hi)
    prefix = np.concatenate([[0.0], np.cumsum(grid.sum(axis=1))])
    while len(cuts) - 1 < n_shards:
        part_costs = np.diff(prefix[cuts])
        for p in np.argsort(part_costs)[::-1]:
            a, b = cuts[p], cuts[p + 1]
            if b - a > 1:
                cuts.insert(p + 1, (a + b) // 2)
                break
        else:
            raise AssertionError("unsplittable partition state")
    return np.asarray(cuts, dtype=np.int64)


def shard_bounds(
    sell: SELLMatrix,
    n_shards: int,
    *,
    partition: str = "auto",
    window: int = 256,
    block_rows: int = 8,
    meta_bytes_per_elem: Optional[float] = None,
    value_bytes_per_elem: Optional[float] = None,
    n_col_segments: int = DEFAULT_COL_SEGMENTS,
    hw: HWConfig = DEFAULT_HW,
) -> Tuple[np.ndarray, Dict[str, object]]:
    """Slice boundaries for ``n_shards`` contiguous row shards under one
    partition strategy, plus an info dict with the balance diagnostics
    `ShardedSpMVEngine.plan_report()` surfaces.

    Returns ``(bounds, info)``: ``bounds`` has ``n_shards + 1`` entries
    with ``bounds[0] == 0`` and ``bounds[-1] == n_slices``; ``info`` holds
    the resolved strategy, the per-shard summed cost vector (in the
    strategy's own units: slices, padded nnz, or estimated cycles), and the
    resulting ``imbalance`` (max/mean shard cost).
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    strategy = resolve_partition(partition)
    n_shards = min(int(n_shards), sell.n_slices) or 1
    meta_bpe = (
        float(hw.index_bytes) if meta_bytes_per_elem is None
        else float(meta_bytes_per_elem)
    )
    value_bpe = (
        float(hw.elem_bytes) if value_bytes_per_elem is None
        else float(value_bytes_per_elem)
    )
    if strategy == "even":
        bounds = even_bounds(sell.n_slices, n_shards)
    elif strategy == "nnz":
        bounds = balanced_bounds(slice_nnz(sell).astype(np.float64), n_shards)
    elif strategy == "cost":
        widths = np.asarray(sell.slice_widths, dtype=np.float64)
        wide = _slice_wide_accesses(
            sell, window=window, block_rows=block_rows
        )
        bounds = _cost_balanced_bounds(
            widths, wide, n_shards, slice_height=sell.slice_height,
            meta_bpe=meta_bpe, value_bpe=value_bpe, hw=hw,
        )
    else:  # cost2d
        grid = _col_segment_costs(
            sell, n_segments=int(n_col_segments), window=window,
            block_rows=block_rows, meta_bytes_per_elem=meta_bytes_per_elem,
            value_bytes_per_elem=value_bytes_per_elem, hw=hw,
        )
        bounds = _balanced_bounds_2d(grid, n_shards)
    # Diagnostics in one shared unit — the width-aware cycle estimate —
    # regardless of which objective produced the boundaries, so strategies
    # are directly comparable in reports and tests.
    shard_costs = shard_costs_for_bounds(
        sell, bounds, window=window, block_rows=block_rows,
        meta_bytes_per_elem=meta_bytes_per_elem,
        value_bytes_per_elem=value_bytes_per_elem, hw=hw,
    )
    mean = float(shard_costs.mean()) if shard_costs.size else 0.0
    info: Dict[str, object] = {
        "strategy": strategy,
        "requested": partition,
        "n_shards": int(n_shards),
        "shard_costs": [float(c) for c in shard_costs],
        "max_shard_cost": float(shard_costs.max(initial=0.0)),
        "mean_shard_cost": mean,
        "cost_imbalance": (
            float(shard_costs.max(initial=0.0) / mean) if mean else 1.0
        ),
    }
    if strategy == "cost2d":
        info["n_col_segments"] = int(n_col_segments)
    return bounds, info
