"""Row-gather execution engine: plan once, gather many (port of
`repro.core.gather_engine`).

`GatherEngine` does for flat row-gather streams (paged-KV page tables,
embedding lookups) what `SpMVEngine` does for SELL column streams: it owns
one index stream, plans it once through the content-addressed schedule
cache, hoists the kernel-ready `DevicePlan`, and gathers any table of the
right shape through it.

  * Planning goes through `core.engine.cached_block_schedule`, so the
    in-memory cache, its ``built`` counter and the persistent schedule store
    (``cache_dir``, `core.schedule_store`) are shared with the SpMV engine.
  * On the cuda backend the schedule lowers once per engine to a
    `DevicePlan` in the gather geometry (`kernels.coalesced_gather.
    build_gather_plan`); every gather launches the kernel from it.
  * `plan_report()` gives coalesce stats, the metadata-traffic report and
    `perfmodel.gather_perf`, as the JAX package does.
  * `get_gather_engine` is the engine cache, keyed on the stream digest,
    the table/plan geometry and the device: a decode loop whose page table
    does not change lands on one engine every step, so steady-state decode
    builds no schedule.

The engine is bound to a table *shape*, not its values: one plan serves the
k pages and the v pages of a layer.

Backends: ``"index"`` (``table[idx]``, the uncoalesced baseline; the JAX
package's ``"jnp"``), ``"coalesced"`` (`schedule_gather_reference`, the
schedule executed in torch), ``"cuda"`` (the hand-written kernel; its plain
version on a CPU engine) and ``"auto"`` (cuda on a CUDA engine, coalesced on
a CPU one). ``"reference"`` is an alias of ``"coalesced"``.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from .coalescer import (
    BlockSchedule,
    META_BYTES_PACKED,
    META_BYTES_UNPACKED,
    coalesce_stats,
    packable_schedule,
    schedule_gather_reference,
    schedule_meta_bytes,
)
from . import schedule_store
from .engine import (
    DEFAULT_WINDOW,
    PACKED_CHOICES,
    _ENGINE_CACHE_MAX,
    _LRUCache,
    _save_best_effort,
    cached_block_schedule,
    resolve_packed,
    stream_digest,
)
from .perfmodel import DEFAULT_HW, HWConfig, gather_perf
from .runtime import resolve_device

GATHER_BACKENDS = ("index", "coalesced", "cuda", "auto")

#: A page / expert slab / embedding row is already the wide block, so the
#: gather default coalesces at single-row granularity (dedup across repeats).
DEFAULT_GATHER_BLOCK_ROWS = 1


def resolve_gather_backend(backend: str, device) -> str:
    """Map a gather backend request to a concrete executor on `device`:
    ``"auto"`` is cuda on a CUDA device and coalesced on the CPU;
    ``"reference"`` is an alias of ``"coalesced"``."""
    if backend == "reference":
        return "coalesced"
    if backend not in GATHER_BACKENDS:
        raise ValueError(
            f"backend must be one of {GATHER_BACKENDS} (or 'reference'), "
            f"got {backend!r}"
        )
    if backend == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "coalesced"
    return backend


def _flat_stream(indices) -> np.ndarray:
    """The index stream as contiguous int32 numpy (the digest's form)."""
    if torch.is_tensor(indices):
        indices = indices.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(indices, dtype=np.int32).reshape(-1))


class GatherEngine:
    """Plan-once / gather-many row gather over the coalesced data path.

    ``table_shape`` is the (rows, row_width) shape every gathered table must
    have; ``indices`` is the flat index stream (any integer shape, numpy or
    a tensor). ``window``/``block_rows`` are the paper's coalescing window W
    and the wide-block height in table rows (default 1: a KV page *is* the
    wide block, so coalescing dedups repeats). ``packed`` selects the
    `DevicePlan` metadata encoding of the cuda backend (``"auto"`` packs
    whenever lossless). ``device`` (default the card) holds the schedule,
    the plan and the tables gathered. ``cache_dir`` enables the shared
    persistent schedule store.
    """

    def __init__(
        self,
        table_shape: Tuple[int, int],
        indices,
        *,
        window: Optional[int] = None,
        block_rows: int = DEFAULT_GATHER_BLOCK_ROWS,
        backend: str = "auto",
        packed: Union[bool, str] = "auto",
        max_warps: Optional[int] = None,
        device=None,
        cache_dir: Optional[str] = None,
    ):
        table_shape = tuple(int(s) for s in table_shape)
        if len(table_shape) != 2:
            raise ValueError(
                f"table_shape must be (rows, row_width), got {table_shape}"
            )
        self.table_shape = table_shape
        idx = _flat_stream(indices)
        if idx.size == 0:
            raise ValueError("GatherEngine needs a non-empty index stream")
        if int(idx.min()) < 0 or int(idx.max()) >= table_shape[0]:
            raise ValueError(
                f"indices must lie in [0, {table_shape[0]}) for "
                f"table_shape={table_shape}; got range "
                f"[{int(idx.min())}, {int(idx.max())}]"
            )
        self.indices = idx
        self.device = resolve_device(device)
        self.backend = backend  # as requested ("auto" preserved for report)
        self.backend_resolved = resolve_gather_backend(backend, self.device)
        self.window = DEFAULT_WINDOW if window is None else int(window)
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.block_rows = int(block_rows)
        if self.block_rows < 1:
            raise ValueError(f"block_rows must be >= 1, got {block_rows}")
        if packed not in PACKED_CHOICES:
            raise ValueError(
                f"packed must be one of {PACKED_CHOICES}, got {packed!r}"
            )
        self.packed = packed  # as requested; resolved against the schedule
        self.max_warps = max_warps
        self.cache_dir = schedule_store.resolve_cache_dir(cache_dir)

        # Planning is lazy and locked, mirroring SpMVEngine: report queries
        # pay for the schedule, never for a gather.
        self._plan_lock = threading.RLock()
        self._digest: Optional[str] = None
        self._schedule: Optional[BlockSchedule] = None
        self.plan_cached: Optional[bool] = None  # set when the plan resolves
        self._device_plan = None  # kernels.sell_spmv.DevicePlan (cuda only)
        self._gather = None

    # -- planning ----------------------------------------------------------

    @property
    def n_indices(self) -> int:
        return int(self.indices.size)

    @property
    def digest(self) -> str:
        """Content digest of the index stream (memoized)."""
        with self._plan_lock:
            if self._digest is None:
                self._digest = stream_digest(self.indices)
            return self._digest

    @property
    def schedule(self) -> BlockSchedule:
        """The coalescer plan on the engine's device (content-addressed
        cache; built on first use, loaded from the persistent store when one
        is configured)."""
        with self._plan_lock:
            if self._schedule is None:
                self._schedule, self.plan_cached = cached_block_schedule(
                    self.indices,
                    window=self.window,
                    block_rows=self.block_rows,
                    max_warps=self.max_warps,
                    device=self.device,
                    cache_dir=self.cache_dir,
                )
            return self._schedule

    def persist_schedule(
        self, cache_dir: Optional[str] = None
    ) -> Optional[str]:
        """Write the already-built schedule to the persistent store (no-op if
        nothing is planned yet, no directory is configured, or the file
        exists). Returns the file path, or None."""
        with self._plan_lock:
            cache_dir = schedule_store.resolve_cache_dir(
                cache_dir if cache_dir is not None else self.cache_dir
            )
            if cache_dir is None or self._schedule is None:
                return None
            path = schedule_store.schedule_path(
                cache_dir, self.digest, window=self.window,
                block_rows=self.block_rows, max_warps=self.max_warps,
            )
            if not os.path.exists(path):
                _save_best_effort(
                    path, self._schedule, stream_digest=self.digest,
                    matrix_digest=None,
                )
            return path

    @property
    def device_plan(self):
        """The hoisted kernel-ready `DevicePlan` (lowered exactly once)."""
        with self._plan_lock:
            if self._device_plan is None:
                from repro_torch.kernels.coalesced_gather import (
                    build_gather_plan,
                )

                self._device_plan = build_gather_plan(
                    self.schedule, packed=self.packed
                )
            return self._device_plan

    def _ensure_executor(self):
        with self._plan_lock:
            if self._gather is None:
                n = self.n_indices
                if self.backend_resolved == "index":
                    idx = torch.as_tensor(
                        self.indices.astype(np.int64), device=self.device
                    )

                    def _gather(table: torch.Tensor) -> torch.Tensor:
                        return table[idx]

                elif self.backend_resolved == "coalesced":
                    sched = self.schedule

                    def _gather(table: torch.Tensor) -> torch.Tensor:
                        return schedule_gather_reference(table, sched, n_out=n)

                else:  # cuda
                    # Imported here: core stays importable before kernels
                    # (which itself imports core).
                    from repro_torch.kernels import ops as kops

                    plan = self.device_plan
                    window, block_rows = self.window, self.block_rows

                    def _gather(table: torch.Tensor) -> torch.Tensor:
                        # The index array never ships: the plan encodes
                        # every gather.
                        return kops.coalesced_gather(
                            table, None, window=window,
                            block_rows=block_rows, plan=plan, n_out=n,
                        )

                self._gather = _gather
            return self._gather

    # -- execution ---------------------------------------------------------

    def gather(self, table) -> torch.Tensor:
        """``table[indices]`` through the cached plan. table: `table_shape`,
        a tensor on the engine's device (a numpy table is staged there);
        returns (n_indices, row_width) in the table's dtype."""
        if not torch.is_tensor(table):
            table = torch.as_tensor(np.asarray(table), device=self.device)
        if table.device != self.device:
            raise ValueError(
                f"gather engine lives on {self.device}, the table on "
                f"{table.device}"
            )
        if tuple(table.shape) != self.table_shape:
            raise ValueError(
                f"gather expects a table of shape {self.table_shape}, got "
                f"{tuple(table.shape)}"
            )
        return self._ensure_executor()(table)

    __call__ = gather

    # -- introspection -----------------------------------------------------

    def plan_report(
        self,
        hw: HWConfig = DEFAULT_HW,
        *,
        row_bytes: Optional[int] = None,
    ) -> Dict[str, object]:
        """The plan, inspectable: stream/coalescer stats, the metadata-
        encoding report, and the `perfmodel.gather_perf` prediction (wide
        fetches deduped by CSHR hits vs the uncoalesced ``table[indices]``
        baseline). Forces planning. ``row_bytes`` is the modeled byte width
        of one table row (default: ``row_width * 4``, a float32 table)."""
        sched = self.schedule
        wide, rate = coalesce_stats(
            self.indices, window=self.window, block_rows=self.block_rows
        )
        packed_resolved = resolve_packed(self.packed, sched)
        bytes_packed = schedule_meta_bytes(sched, packed=True)
        bytes_unpacked = schedule_meta_bytes(sched, packed=False)
        rb = (
            self.table_shape[1] * 4 if row_bytes is None else int(row_bytes)
        )
        meta_bpe = META_BYTES_PACKED if packed_resolved else META_BYTES_UNPACKED
        perf = gather_perf(
            self.indices,
            window=self.window,
            block_rows=self.block_rows,
            row_bytes=rb,
            hw=hw,
            meta_bytes_per_elem=meta_bpe,
        )
        return {
            "table_shape": self.table_shape,
            "n_indices": self.n_indices,
            "backend": self.backend,
            "backend_resolved": self.backend_resolved,
            "window": self.window,
            "block_rows": self.block_rows,
            "n_windows": sched.n_windows,
            "max_warps": sched.max_warps,
            "schedule_cached": self.plan_cached,
            "wide_accesses": wide,
            "coalesce_rate": rate,
            "metadata": {
                "requested": self.packed,
                "packed": packed_resolved,
                "packable": packable_schedule(sched),
                "meta_bytes_per_element": meta_bpe,
                "meta_bytes": schedule_meta_bytes(
                    sched, packed=packed_resolved
                ),
                "meta_bytes_packed": bytes_packed,
                "meta_bytes_unpacked": bytes_unpacked,
                "traffic_reduction": bytes_unpacked / bytes_packed,
            },
            "gather_perf": dataclasses.asdict(perf),
        }


# ---------------------------------------------------------------------------
# Content-addressed engine cache
# ---------------------------------------------------------------------------

_gather_engine_cache = _LRUCache(_ENGINE_CACHE_MAX)
# Same single-object guarantee as engine.get_engine: one lock serializes the
# miss path (construction is cheap — planning stays lazy).
_gather_engine_lock = threading.RLock()


def get_gather_engine(
    table_shape: Tuple[int, int],
    indices,
    *,
    window: Optional[int] = None,
    block_rows: int = DEFAULT_GATHER_BLOCK_ROWS,
    backend: str = "auto",
    packed: Union[bool, str] = "auto",
    max_warps: Optional[int] = None,
    device=None,
    cache_dir: Optional[str] = None,
) -> GatherEngine:
    """Engine cache: same stream content + table/plan geometry + device ->
    same engine (and so the same schedule and plan). This is what makes
    steady-state decode plan-free: `models.paged_kv.gather_kv` keys on the
    page-table digest, and as long as the table does not change every
    decode step lands on one engine. The key holds the *resolved* backend
    and window (every spelling of one plan shares one engine); `packed` is
    keyed as requested, like `get_engine`; `cache_dir` changes where plans
    are stored, never what they are (a cached engine adopts it and writes
    its plan through)."""
    idx = _flat_stream(indices)
    dev = resolve_device(device)
    resolved = resolve_gather_backend(backend, dev)
    key = (
        stream_digest(idx),
        tuple(int(s) for s in table_shape),
        DEFAULT_WINDOW if window is None else int(window),
        int(block_rows),
        resolved,
        max_warps,
        packed if resolved == "cuda" else None,
        str(dev),
    )
    adopted = None
    with _gather_engine_lock:
        eng = _gather_engine_cache.get(key)
        if eng is None:
            eng = GatherEngine(
                table_shape,
                idx,
                window=window,
                block_rows=block_rows,
                backend=backend,
                packed=packed,
                max_warps=max_warps,
                device=dev,
                cache_dir=cache_dir,
            )
            _gather_engine_cache.put(key, eng)
        elif cache_dir is not None:
            eng.cache_dir = schedule_store.resolve_cache_dir(cache_dir)
            adopted = eng
    if adopted is not None:
        adopted.persist_schedule()
    return eng


def gather_engine_cache_stats() -> Dict[str, int]:
    return {
        "size": len(_gather_engine_cache),
        "hits": _gather_engine_cache.hits,
        "misses": _gather_engine_cache.misses,
    }


def clear_gather_engine_cache() -> None:
    _gather_engine_cache.clear()
