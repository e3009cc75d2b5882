"""Sharded SpMV: row-slice partitioning over a device grid (port of
`repro.core.dist`).

  * **Row shards over the ``data`` axis.** The SELL matrix is partitioned by
    row slices into contiguous shards; *where* the boundaries fall is the
    ``partition`` strategy (`core.partition`: ``"even"``, ``"nnz"``,
    ``"cost"`` — what ``"auto"`` resolves to — or ``"cost2d"``). Every
    shard pads to its *own* max slice width, not the global one; the
    reference executor's width reduction is a padding-invariant tree
    (`engine._width_tree_sum`), so on the reference backend the sharded
    result is bit-identical to the single-device engine for every
    strategy.
  * **One plan per shard.** Each shard is a `SELLMatrix` owned by an engine
    from `get_engine`, so plans, the schedule store and the digests compose
    per shard.
  * **RHS columns over the ``model`` axis.** `matmat` splits the right-hand
    sides into balanced column groups; block (shard ``i``, group ``j``) runs
    on grid device ``(i % data, j)``. More shards than grid rows
    round-robin, which is how one card runs several shards. A staged
    right-hand side is copied once per distinct device, every block is
    dispatched before any host sync, and the rows meet on the grid's first
    device.

The grid comes from `launch.mesh` (`core.runtime.DeviceMesh`, a numpy object
array of `torch.device`s). Like `SpMVEngine` this engine implements the
`runtime.Executor` protocol (``matmat`` is ``finalize(dispatch(stage(X)))``),
so `runtime.StreamingExecutor` can wrap it.

Degraded mode: a shard whose dispatch is failed at the ``shard_fail`` fault
site is recomputed in `finalize` by the reference executor on a surviving
grid row, and logged in `recovery_report`; ``serve --chaos`` reports it.
A real failure (a kernel that does not build, a geometry the card refuses,
a CUDA error) is raised, never recomputed: on the card the reference
executor would be the plain version in the kernel's place.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from . import faults
from .coalescer import META_BYTES_PACKED, META_BYTES_UNPACKED, \
    coalesce_stats, schedule_meta_bytes
from .engine import DEFAULT_BUFFER_DEPTH, DEFAULT_COLS_PER_CHUNK, \
    DEFAULT_K_TILE, DEFAULT_WINDOW, get_engine, resolve_backend, \
    resolve_packed
from .formats import CSRMatrix, SELLMatrix
from .partition import resolve_partition, shard_bounds
from .perfmodel import matmat_spmv_perf, sharded_spmv_perf, \
    streaming_spmv_perf
from .runtime import DeviceMesh, Staged, column_groups, host_tensor, \
    microbatch_slices, normalize_to_sell, on_compute_stream, proper_slice, \
    stage_async

# Columns a degraded-mode recompute takes at a time.
RECOVERY_COLUMNS = 8


def device_str(dev: torch.device) -> str:
    """Stable, JSON-serializable device name (``"cuda:0"``, ``"cpu:0"``)."""
    return f"{dev.type}:{0 if dev.index is None else int(dev.index)}"


def row_shard_sells(
    sell: SELLMatrix,
    n_shards: int,
    *,
    partition: str = "even",
    window: Optional[int] = None,
    block_rows: int = 8,
    bounds: Optional[np.ndarray] = None,
) -> List[Tuple[SELLMatrix, int, int]]:
    """Partition a SELL matrix into `n_shards` contiguous row-slice shards.

    Returns ``[(shard_sell, row_lo, row_hi), ...]`` with ``row_lo/row_hi``
    the half-open global row range the shard owns. Boundaries come from the
    ``partition`` strategy (`core.partition.shard_bounds`; default
    ``"even"``) or from an explicit ``bounds`` array (slice indices,
    ``n_shards + 1`` entries). Each shard pads to its *own* maximum slice
    width."""
    from .spmv import _sell_padded  # local: spmv routes via engine

    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    n_shards = min(n_shards, sell.n_slices) or 1
    if bounds is None:
        bounds, _ = shard_bounds(
            sell, n_shards, partition=partition,
            window=DEFAULT_WINDOW if window is None else int(window),
            block_rows=block_rows,
        )
    bounds = np.asarray(bounds, dtype=np.int64)
    n_shards = bounds.size - 1
    ci, va, _ = _sell_padded(sell)  # (n_slices, W, H)
    H = sell.slice_height
    widths = np.asarray(sell.slice_widths, dtype=np.int64)
    shards: List[Tuple[SELLMatrix, int, int]] = []
    for k in range(n_shards):
        s0, s1 = int(bounds[k]), int(bounds[k + 1])
        nsl = s1 - s0
        # A shard of empty slices keeps one zero column (colidx 0 / value 0)
        # so its engine still has a well-formed stream to plan against —
        # unless the whole matrix is width-0, which stays width-0.
        Ws = int(widths[s0:s1].max(initial=0))
        Ws = min(max(Ws, 1), ci.shape[1]) if ci.shape[1] else 0
        shard = SELLMatrix(
            n_rows=min(sell.n_rows, s1 * H) - s0 * H,
            n_cols=sell.n_cols,
            slice_height=H,
            slice_ptrs=np.arange(nsl + 1, dtype=np.int64) * (Ws * H),
            slice_widths=np.full(nsl, Ws, dtype=np.int32),
            colidx=np.ascontiguousarray(ci[s0:s1, :Ws].reshape(-1)),
            values=np.ascontiguousarray(va[s0:s1, :Ws].reshape(-1)),
        )
        shard.validate()
        shards.append((shard, s0 * H, min(sell.n_rows, s1 * H)))
    return shards


class _Copies:
    """Every copy of one staged batch, as one event: `synchronize` waits for
    all of them (what `runtime.PinnedRing` waits on before packing its
    buffer again)."""

    def __init__(self, events) -> None:
        self.events = [e for e in events if e is not None]

    def synchronize(self) -> None:
        for e in self.events:
            e.synchronize()


@dataclasses.dataclass
class _StagedRHS:
    """A RHS micro-batch placed on the grid: one `runtime.Staged` per
    (device row, column group), copied once per distinct device and column
    group and shared by every shard round-robined onto that row."""

    k: int
    groups: List[slice]
    placed: Dict[Tuple[int, int], Staged]
    dtype: torch.dtype

    def _distinct(self) -> List[Staged]:
        return list({id(s): s for s in self.placed.values()}.values())

    @property
    def copied(self) -> _Copies:
        return _Copies(s.copied for s in self._distinct())

    def copy_ms(self) -> float:
        """Device milliseconds of the distinct copies (call once done)."""
        return sum(s.copy_ms() for s in self._distinct())


class _FailedShard:
    """Placeholder for a shard whose dispatch failed by injection.
    `finalize` recomputes the row-slice in degraded mode instead."""

    __slots__ = ("error",)

    def __init__(self, error: faults.FaultInjected):
        self.error = error


@dataclasses.dataclass
class _PendingBlocks:
    """Dispatched blocks not yet gathered (the `dispatch` half): one
    `runtime.Pending` per (shard, column group), or a `_FailedShard`; the
    staged RHS rides along so degraded-mode recovery can recompute a failed
    shard's rows from source."""

    blocks: List[object]
    k: int
    dtype: torch.dtype
    staged: _StagedRHS


class ShardedSpMVEngine:
    """Plan-once / execute-many SpMV sharded across a device grid.

    ``matrix`` may be CSR (converted once, like `SpMVEngine`) or SELL.
    ``mesh`` is a `runtime.DeviceMesh` with ``data`` and ``model`` axes
    (default: `launch.mesh.auto_spmv_mesh` over the visible devices of
    ``device``'s kind — the card unless the caller asks for the CPU). Row
    shards map to the ``data`` axis, RHS column groups to the ``model``
    axis; ``n_shards`` defaults to the ``data`` axis size, and larger values
    round-robin shards over the grid rows.

    ``partition`` selects where the shard boundaries fall (`core.partition`:
    ``"even"`` | ``"nnz"`` | ``"cost"`` | ``"cost2d"``, ``"auto"`` ->
    ``"cost"``). The plan parameters (``window``, ``block_rows``,
    ``backend``, ``cols_per_chunk``, ``k_tile``, ``matmat_mode``,
    ``packed``, ``buffer_depth``, ``value_dtype``, ``cache_dir``) are
    forwarded to every shard's engine. Results are tensors on the grid's
    first device (`device`).
    """

    def __init__(
        self,
        matrix: Union[CSRMatrix, SELLMatrix],
        *,
        mesh: Optional[DeviceMesh] = None,
        n_shards: Optional[int] = None,
        window: Optional[int] = None,
        block_rows: int = 8,
        slice_height: Optional[int] = None,
        width_multiple: int = 1,
        backend: str = "auto",
        cols_per_chunk: int = DEFAULT_COLS_PER_CHUNK,
        k_tile: int = DEFAULT_K_TILE,
        matmat_mode: str = "auto",
        packed: Union[bool, str] = "auto",
        buffer_depth: int = DEFAULT_BUFFER_DEPTH,
        value_dtype: Optional[str] = None,
        partition: str = "auto",
        cache_dir: Optional[str] = None,
        device=None,
    ):
        sell = normalize_to_sell(
            matrix, slice_height=slice_height, width_multiple=width_multiple
        )
        self.sell = sell
        if mesh is None:
            from repro_torch.launch.mesh import auto_spmv_mesh

            mesh = auto_spmv_mesh(device=device)
        elif device is not None:
            raise ValueError("pass either mesh= or device=, not both")
        self.mesh = mesh
        self.devices = mesh.devices  # [data row, model column]
        self.n_data, self.n_model = self.devices.shape
        self.device = self.devices[0, 0]  # where the rows meet

        self.backend = backend
        self.backend_resolved = resolve_backend(backend, self.device)
        self.block_rows = int(block_rows)
        self.window = window
        self.n_shards = self.n_data if n_shards is None else int(n_shards)
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        # The boundary computation sees the geometry the shard plans use.
        self.partition = partition
        self.partition_resolved = resolve_partition(partition)
        bounds, self._partition_info = shard_bounds(
            sell,
            min(self.n_shards, sell.n_slices) or 1,
            partition=partition,
            window=DEFAULT_WINDOW if window is None else int(window),
            block_rows=self.block_rows,
        )
        self._shards = row_shard_sells(sell, self.n_shards, bounds=bounds)
        self.n_shards = len(self._shards)  # clamped to n_slices
        engine_kw = dict(
            window=window, block_rows=block_rows, backend=backend,
            cols_per_chunk=cols_per_chunk, k_tile=k_tile,
            matmat_mode=matmat_mode, packed=packed,
            buffer_depth=buffer_depth, value_dtype=value_dtype,
            cache_dir=cache_dir,
        )
        # Through the engine cache, one engine per (shard, distinct device):
        # two sharded engines over one matrix share shard engines and plans.
        self._block_engines = [
            [get_engine(shard, device=self.devices[self._shard_device_row(i),
                                                   j], **engine_kw)
             for j in range(self.n_model)]
            for i, (shard, _, _) in enumerate(self._shards)
        ]
        self.engines = [row[0] for row in self._block_engines]
        self.row_ranges = [(lo, hi) for _, lo, hi in self._shards]
        self._copy_streams: Dict[str, "torch.cuda.Stream"] = {}
        # Degraded-mode recovery log (see `_recover_shard`).
        self._recovery_events: List[Dict[str, object]] = []
        self._recovery_lock = threading.Lock()

    @property
    def partition_info(self) -> Dict[str, object]:
        """The strategy, each shard's cost and their imbalance, in the
        partitioner's width-aware cycle estimate (`partition.shard_bounds`)."""
        return dict(self._partition_info)

    # -- placement ---------------------------------------------------------

    def _shard_device_row(self, i: int) -> int:
        return i % self.n_data

    def placement(self, k: int) -> List[Dict[str, object]]:
        """The (shard, column-group) -> device assignment `matmat(X)` with
        ``X.shape[1] == k`` uses: one entry per dispatched block, with the
        shard's own padded footprint (``nnz_padded``, ``width``)."""
        groups = column_groups(k, self.n_model)
        out: List[Dict[str, object]] = []
        for i, (lo, hi) in enumerate(self.row_ranges):
            shard_sell = self._shards[i][0]
            for j, cols in enumerate(groups):
                dev = self.devices[self._shard_device_row(i), j]
                out.append({
                    "shard": i,
                    "device": dev,
                    "device_str": device_str(dev),
                    "device_id": 0 if dev.index is None else int(dev.index),
                    "rows": (lo, hi),
                    "cols": (cols.start, cols.stop),
                    "nnz_padded": int(shard_sell.nnz_padded),
                    "width": int(np.max(shard_sell.slice_widths, initial=0)),
                })
        return out

    # -- execution ---------------------------------------------------------

    @property
    def n_rows(self) -> int:
        return self.sell.n_rows

    @property
    def n_cols(self) -> int:
        return self.sell.n_cols

    def _copy_stream(self, device: torch.device):
        """The stream a device's right-hand sides are copied on (the card
        only)."""
        if device.type != "cuda":
            return None
        key = device_str(device)
        stream = self._copy_streams.get(key)
        if stream is None:
            stream = self._copy_streams[key] = torch.cuda.Stream(device=device)
        return stream

    def _put(self, X, device: torch.device, cache: Dict, cols=None) -> Staged:
        """`X` staged on `device` once per distinct device and columns. (The
        JAX package donates a source block once copied; torch has no
        donation, so the caller's batch stays valid.)"""
        key = (device_str(device), cols)
        if key not in cache:
            cache[key] = stage_async(X, device, self._copy_stream(device))
        return cache[key]

    def _gather_rows(self, parts: List[torch.Tensor]) -> torch.Tensor:
        return torch.cat([p.to(self.device) for p in parts], dim=0)

    def matvec(self, x) -> torch.Tensor:
        """y = A @ x: x staged once per distinct device, each shard computes
        its row block on its own device, and the blocks are concatenated on
        `device`."""
        return self._gather_rows(
            [part for part, _, _ in self.matvec_parts(x)])

    def matvec_parts(self, x):
        """Per-shard matvec without the gather: a list of ``(part, placed_x,
        (lo, hi))`` per row shard, where ``part`` is the shard's slice of
        ``A @ x`` (launched on the shard's device), ``placed_x`` the input
        on that device and ``(lo, hi)`` the shard's global row range. The
        solvers' host loop reduces dot products over them: each shard takes
        ``<x[lo:hi], part>`` on its own device, and only the scalars meet
        on the host."""
        if tuple(np.shape(x)) != (self.sell.n_cols,):
            raise ValueError(
                f"matvec expects x of shape ({self.sell.n_cols},), got "
                f"{tuple(np.shape(x))}"
            )
        x = host_tensor(x)
        placed: Dict = {}  # one x transfer per distinct device
        out = []
        for i, eng in enumerate(self.engines):
            dev = self.devices[self._shard_device_row(i), 0]
            xd = on_compute_stream(self._put(x, dev, placed), dev)
            out.append((eng.matvec(xd), xd, self.row_ranges[i]))
        return out

    def matmat(self, X) -> torch.Tensor:
        """Y = A @ X with row shards on the ``data`` axis and RHS column
        groups on the ``model`` axis. Every block is dispatched before any
        is gathered, so all grid devices run concurrently. Bit-identical per
        column to the single-device engine on the reference backend. This is
        ``finalize(dispatch(stage(X)))``."""
        return self.finalize(self.dispatch(self.stage(X)))

    def __call__(self, x) -> torch.Tensor:
        return self.matvec(x) if np.ndim(x) == 1 else self.matmat(x)

    # -- streaming pipeline hooks (runtime.Executor) ------------------------

    def stage(self, X) -> _StagedRHS:
        """Start placing one RHS micro-batch on the grid: one `stage_async`
        (pinned memory and a non-blocking copy on the card) per distinct
        device and column group; shards that round-robin onto one device
        share the placed block."""
        if len(np.shape(X)) != 2 or np.shape(X)[0] != self.sell.n_cols:
            raise ValueError(
                f"stage expects X of shape ({self.sell.n_cols}, k), got "
                f"{tuple(np.shape(X))}"
            )
        X = host_tensor(X)
        k = int(X.shape[1])
        groups = column_groups(k, self.n_model)
        rows_used = sorted({self._shard_device_row(i)
                            for i in range(self.n_shards)})
        cache: Dict = {}
        placed: Dict[Tuple[int, int], Staged] = {}
        for d in rows_used:
            for j, cols in enumerate(groups):
                block = X[:, cols] if proper_slice(cols, k) else X
                placed[(d, j)] = self._put(block, self.devices[d, j], cache,
                                           (cols.start, cols.stop))
        return _StagedRHS(k=k, groups=groups, placed=placed, dtype=X.dtype)

    def dispatch(self, staged: _StagedRHS) -> _PendingBlocks:
        """Launch every (row-shard, column-group) block matmat on its staged
        RHS — no host sync. A shard failed at the ``shard_fail`` fault site
        does not poison the others: its slot carries a `_FailedShard` and
        `finalize` recomputes its rows. A real failure raises."""
        blocks: List[object] = []
        for i, row in enumerate(self._block_engines):
            d = self._shard_device_row(i)
            try:
                faults.maybe_inject(
                    "shard_fail", f"injected dispatch failure on shard {i}"
                )
            except faults.FaultInjected as exc:
                blocks.append(_FailedShard(exc))
                continue
            blocks.append([
                eng.dispatch(staged.placed[(d, j)])
                for j, eng in enumerate(row[:len(staged.groups)])
            ])
        return _PendingBlocks(blocks=blocks, k=staged.k, dtype=staged.dtype,
                              staged=staged)

    def finalize(self, pending: _PendingBlocks) -> torch.Tensor:
        """Wait for every block and assemble the (n_rows, k) result on
        `device`. A shard marked failed at dispatch has its rows recomputed
        in degraded mode (`_recover_shard`)."""
        if pending.k == 0:  # no groups were dispatched
            return torch.zeros((self.sell.n_rows, 0), dtype=pending.dtype,
                               device=self.device)
        rows = []
        for i, row in enumerate(pending.blocks):
            if isinstance(row, _FailedShard):
                rows.append(self._recover_shard(i, pending, row.error))
                continue
            parts = [eng.finalize(p).to(self.device)
                     for eng, p in zip(self._block_engines[i], row)]
            rows.append(torch.cat(parts, dim=1) if len(parts) > 1
                        else parts[0])
        return torch.cat(rows, dim=0)

    def _recover_shard(
        self, i: int, pending: _PendingBlocks, error: faults.FaultInjected
    ) -> torch.Tensor:
        """Recompute shard *i*'s row block, failed by injection, through the
        reference executor.

        The recovery engine shares the failed shard's SELL slice, geometry
        and value dtype, so on the reference backend the recomputed rows are
        bit-identical to the healthy dispatch (and within kernel parity
        tolerance of a cuda run). It runs on a surviving grid row's devices
        (the next row, when the grid has more than one)."""
        staged = pending.staged
        d = self._shard_device_row(i)
        survivor = (d + 1) % self.n_data if self.n_data > 1 else d
        parts = []
        for j in range(len(staged.groups)):
            dev = self.devices[survivor, j]
            ref_eng = get_engine(
                self._shards[i][0],
                window=self.window,
                block_rows=self.block_rows,
                backend="reference",
                value_dtype=self.engines[i].value_dtype,
                device=dev,
            )
            block = on_compute_stream(staged.placed[(d, j)],
                                      self.devices[d, j])
            # The reference executor holds every (element, column) product;
            # a few columns at a time bound that (its sums are per column).
            parts += [ref_eng.matmat(block[:, sl]).to(self.device)
                      for sl in microbatch_slices(block.shape[1],
                                                  RECOVERY_COLUMNS)]
        result = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
        event = {
            "shard": i,
            "rows": self.row_ranges[i],
            "k": pending.k,
            "error": repr(error),
            "injected": True,
            "mode": "reference-recompute",
            "device_str": device_str(self.devices[survivor, 0]),
        }
        with self._recovery_lock:
            self._recovery_events.append(event)
        faults.note_recovered(error.site)
        return result

    # -- introspection / persistence ---------------------------------------

    def recovery_report(self) -> Dict[str, object]:
        """Degraded-mode recovery log: every shard recomputed through the
        reference executor (the JAX package's keys; only injected failures
        are recovered, so ``injected`` equals ``recovered``)."""
        with self._recovery_lock:
            events = [dict(e) for e in self._recovery_events]
        return {
            "events": events,
            "recovered": len(events),
            "injected": sum(1 for e in events if e["injected"]),
        }

    def persist_schedules(self, cache_dir: Optional[str] = None) -> List[str]:
        """Write every shard's already-built schedule to the persistent
        store (see `SpMVEngine.persist_schedule`). Returns written paths."""
        paths = [eng.persist_schedule(cache_dir) for eng in self.engines]
        return [p for p in paths if p is not None]

    def plan_report(
        self, *, stream: Optional[Dict[str, int]] = None,
        k: Optional[int] = None,
    ) -> Dict[str, object]:
        """Aggregate plan report plus per-shard coalesce stats (the same
        keys as the JAX package's). Forces planning on every shard.
        ``shards[i]`` reports the rows the shard owns, its padded footprint,
        its stream's wide accesses and coalesce rate, its schedule geometry
        and whether its plan came from a cache; ``partition`` the strategy,
        its cost vector and the perf model's straggler imbalance.
        ``stream=``/``k=`` add the whole-matrix streaming and matmat
        predictions (see `SpMVEngine.plan_report`)."""
        shard_reports: List[Dict[str, object]] = []
        total_wide = 0
        total_elems = 0
        for i, eng in enumerate(self.engines):
            sched = eng.schedule  # force the plan
            _, _, shard_stream, _, _ = eng._ensure_plan()
            wide, rate = coalesce_stats(
                shard_stream, window=eng.window, block_rows=eng.block_rows
            )
            total_wide += wide
            total_elems += int(shard_stream.size)
            lo, hi = self.row_ranges[i]
            packed_eff = resolve_packed(eng.packed, sched)
            dev = self.devices[self._shard_device_row(i), 0]
            shard_reports.append({
                "shard": i,
                "rows": (lo, hi),
                "n_slices": eng.sell.n_slices,
                "nnz": int(np.count_nonzero(eng.sell.values)),
                "nnz_padded": eng.sell.nnz_padded,
                "width": int(np.max(eng.sell.slice_widths, initial=0)),
                "meta_bytes": schedule_meta_bytes(sched, packed=packed_eff),
                "meta_bytes_per_element": (
                    META_BYTES_PACKED if packed_eff else META_BYTES_UNPACKED
                ),
                "window": eng.window,
                "n_windows": sched.n_windows,
                "max_warps": sched.max_warps,
                "wide_accesses": wide,
                "coalesce_rate": rate,
                "schedule_cached": eng.plan_cached,
                "device_row": self._shard_device_row(i),
                "device_str": device_str(dev),
            })
        streaming = None
        if stream is not None:
            streaming = {
                **{key: int(v) for key, v in stream.items()},
                "perf": {
                    system: dataclasses.asdict(
                        streaming_spmv_perf(self.sell, system, **stream)
                    )
                    for system in ("base", "pack256")
                },
            }
        matmat = None
        if k is not None:
            k_tile = self.engines[0].k_tile
            matmat = {
                "k": int(k),
                "k_tile": k_tile,
                "mode": self.engines[0].matmat_mode_resolved,
                "perf": {
                    system: dataclasses.asdict(
                        matmat_spmv_perf(self.sell, system, k=int(k),
                                         k_tile=k_tile)
                    )
                    for system in ("pack0", "pack256")
                },
            }
        # Straggler-bound prediction over the shard matrices themselves
        # (their own padded widths) and the imbalance the partitioner
        # minimizes.
        sharded_perf = sharded_spmv_perf(
            [s for s, _, _ in self._shards], "pack256"
        )
        partition_report = {
            **self._partition_info,
            "perf": dataclasses.asdict(sharded_perf),
            "imbalance": {
                "max_shard_cycles": sharded_perf.max_shard_cycles,
                "mean_shard_cycles": sharded_perf.mean_shard_cycles,
                "ratio": sharded_perf.imbalance,
            },
        }
        return {
            "n_rows": self.sell.n_rows,
            "n_cols": self.sell.n_cols,
            "nnz_padded": self.sell.nnz_padded,
            "backend": self.backend,
            "backend_resolved": self.backend_resolved,
            "mesh": {"data": self.n_data, "model": self.n_model},
            "n_devices": int(self.devices.size),
            "n_shards": self.n_shards,
            "block_rows": self.block_rows,
            "wide_accesses": total_wide,
            "coalesce_rate": (
                float(total_elems) / float(total_wide * self.block_rows)
                if total_wide else 0.0
            ),
            "partition": partition_report,
            "recovery": self.recovery_report(),
            "shards": shard_reports,
            **({"streaming": streaming} if streaming is not None else {}),
            **({"matmat": matmat} if matmat is not None else {}),
        }
