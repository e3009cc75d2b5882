"""Batched SpMV execution engine: plan once, execute many (port of
`repro.core.engine`).

  * `cached_block_schedule` — content-addressed schedule cache. The key is
    the SHA-256 digest of the int32 index-stream bytes plus (window,
    block_rows, max_warps) and the device the schedule lives on; repeat
    plans return the *same* object. With a cache directory (``cache_dir=``
    or ``$REPRO_SCHEDULE_CACHE``) a memory miss falls through to the
    persistent store (`core.schedule_store`, the JAX package's file format)
    before planning, and fresh plans are written back.
  * `SpMVEngine` — owns one matrix (CSR is converted to SELL up front,
    validated), one schedule, one `DevicePlan`, and `matvec(x)` /
    batched `matmat(X)` that reuse them across many right-hand sides.
  * Backends — ``backend="reference" | "cuda" | "auto"``. The reference
    backend executes the schedule-gather oracle in eager torch (bit-identical
    to the JAX package's reference backend in float32); the cuda backend
    runs the hand-written kernels (`kernels.sell_spmv`, and the fused
    `kernels.sell_spmm` for matmat) — on a CPU engine their plain versions.
    ``"auto"`` resolves to cuda on a CUDA engine and to the reference
    elsewhere. The kernels consume SELL in ``cols_per_chunk``-wide chunks, so
    the planner pads the width up to a multiple of it and derives the window
    (``cols_per_chunk * slice_height``) before the schedule is built.
  * Device — an engine runs on the card (``device=None`` means ``"cuda"``)
    unless the caller asks for the CPU with ``device="cpu"``; a missing card
    raises instead of running elsewhere.
  * `get_engine` — engine-level cache keyed on matrix content, resolved plan
    parameters and device.

Cache sizes are bounded (LRU). `SpMVEngine` also has the ``stage`` /
``dispatch`` / ``finalize`` trio of a streaming executor
(`runtime.Executor`): ``finalize(dispatch(stage(X)))`` equals ``matmat(X)``
bit for bit. On the card each hook acts on one micro-batch: ``stage`` copies
from pinned host memory on the engine's copy stream, ``dispatch`` makes the
compute stream wait for that copy only, and ``finalize`` waits for that
micro-batch's own completion event.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from . import faults, schedule_store
from .coalescer import BlockSchedule, META_BYTES_PACKED, \
    META_BYTES_UNPACKED, build_block_schedule, coalesce_stats, \
    packable_schedule, plan_device, schedule_gather_reference, \
    schedule_meta_bytes, trim_schedule_warps
from .formats import CSRMatrix, SELLMatrix
from .perfmodel import DEFAULT_HW, HWConfig, matmat_spmv_perf, spmv_perf, \
    streaming_spmv_perf
from .runtime import Pending, Staged, normalize_to_sell, pad_width, \
    resolve_device, stage_async

BACKENDS = ("reference", "cuda", "auto")
DEFAULT_WINDOW = 256
DEFAULT_COLS_PER_CHUNK = 8
DEFAULT_K_TILE = 8
# Kernel-pipeline default; must match kernels.sell_spmv.DEFAULT_BUFFER_DEPTH.
DEFAULT_BUFFER_DEPTH = 2
MATMAT_MODES = ("fused", "vmapped", "auto")
PACKED_CHOICES = (True, False, "auto")
VALUE_DTYPES = ("native", "bf16", "f32")
_TORCH_VALUE_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def resolve_value_dtype(value_dtype: Optional[str]) -> Optional[str]:
    """Normalize the value-storage knob: ``None``/"native" -> None (follow
    the input dtype), otherwise one of `VALUE_DTYPES`."""
    if value_dtype is None or value_dtype == "native":
        return None
    if value_dtype not in VALUE_DTYPES:
        raise ValueError(
            f"value_dtype must be one of {(None,) + VALUE_DTYPES}, got "
            f"{value_dtype!r}"
        )
    return value_dtype


def value_bytes_per_elem(
    value_dtype: Optional[str], hw: HWConfig = DEFAULT_HW
) -> float:
    """Bytes per SELL value the plan streams — the perf model's
    `value_bytes_per_elem` term (native keeps the model's `hw.elem_bytes`)."""
    resolved = resolve_value_dtype(value_dtype)
    if resolved is None:
        return float(hw.elem_bytes)
    return {"bf16": 2.0, "f32": 4.0}[resolved]


def _runtime_one(x: torch.Tensor) -> torch.Tensor:
    """An exact scalar 1.0 computed from a kernel input (``sum(x[:1]) * 0 +
    1``). Multiplying products by it keeps the reduction below free of
    multiply-add contraction, as in the JAX package."""
    s = torch.sum(x.reshape(-1)[:1])
    return s * 0 + 1


def _width_tree_sum(prod: torch.Tensor, one: torch.Tensor) -> torch.Tensor:
    """Reduce ``(n_slices, W, ...)`` over the width axis with a fixed
    power-of-two halving tree, bitwise invariant to trailing zero columns.
    Eager torch on purpose: each fold is one rounded add, exactly the JAX
    package's sequence of operations."""
    if prod.shape[1] == 0:
        return torch.zeros(prod.shape[:1] + prod.shape[2:], dtype=prod.dtype,
                           device=prod.device)
    prod = prod * one
    p = 1
    while p < prod.shape[1]:
        p *= 2
    if p != prod.shape[1]:
        pad_shape = list(prod.shape)
        pad_shape[1] = p - prod.shape[1]
        prod = torch.cat(
            [prod, torch.zeros(pad_shape, dtype=prod.dtype,
                               device=prod.device)], dim=1,
        )
    while prod.shape[1] > 1:
        h = prod.shape[1] // 2
        prod = prod[:, :h] + prod[:, h:]
    return prod[:, 0]


def resolve_packed(packed: Union[bool, str], schedule: BlockSchedule) -> bool:
    """The engine-level packing rule, shared with `plan_report`: ``"auto"``
    packs whenever the schedule's geometry fits the 16/16-bit encoding."""
    if packed == "auto":
        return packable_schedule(schedule)
    return bool(packed)


def resolve_backend(backend: str, device: torch.device) -> str:
    """Map "auto" to a concrete executor: the kernels on a CUDA engine, the
    reference executor on an engine the caller put on the CPU. Explicit
    "reference"/"cuda" always win (cuda on a CPU engine runs the kernels'
    plain versions)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "reference"
    return backend


def resolve_window(
    window: Optional[int],
    *,
    backend_resolved: str,
    cols_per_chunk: int,
    slice_height: int,
) -> int:
    """The cuda backend plans one (slice, chunk) per window (an explicit
    window that fights that geometry raises); the reference backend defaults
    to `DEFAULT_WINDOW`."""
    if backend_resolved == "cuda":
        kernel_window = int(cols_per_chunk) * int(slice_height)
        if window is not None and int(window) != kernel_window:
            raise ValueError(
                f"backend='cuda' plans one (slice, chunk) per window: "
                f"window = cols_per_chunk * slice_height = {kernel_window}"
                f", but window={window} was requested (pass window=None "
                f"to derive it, or change cols_per_chunk)"
            )
        return kernel_window
    return DEFAULT_WINDOW if window is None else int(window)


def resolve_matmat_mode(mode: str, backend_resolved: str) -> str:
    """``"auto"`` routes `matmat` onto the fused kernel on the cuda backend
    and onto the per-column path elsewhere; ``"fused"`` demands the fused
    kernel and raises off the cuda backend."""
    if mode not in MATMAT_MODES:
        raise ValueError(
            f"matmat_mode must be one of {MATMAT_MODES}, got {mode!r}"
        )
    if mode == "auto":
        return "fused" if backend_resolved == "cuda" else "vmapped"
    if mode == "fused" and backend_resolved != "cuda":
        raise ValueError(
            f"matmat_mode='fused' requires the cuda backend (the fused "
            f"sell_spmm kernel); backend resolved to {backend_resolved!r}"
        )
    return mode


# ---------------------------------------------------------------------------
# Content-addressed schedule cache
# ---------------------------------------------------------------------------

_SCHEDULE_CACHE_MAX = 64
_ENGINE_CACHE_MAX = 32


class _LRUCache:
    """Tiny bounded, thread-safe LRU with hit/miss counters."""

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self._d: "OrderedDict[object, object]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key, *, count: bool = True):
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                if count:
                    self.hits += 1
                return self._d[key]
            if count:
                self.misses += 1
            return None

    def put(self, key, value) -> None:
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.maxsize:
                self._d.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()
            self.hits = 0
            self.misses = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)


_schedule_cache = _LRUCache(_SCHEDULE_CACHE_MAX)
_engine_cache = _LRUCache(_ENGINE_CACHE_MAX)
_engine_lock = threading.RLock()
# Serializes schedule builds so concurrent planners of one stream get one
# object (the identity guarantee); the memory-hit write-through takes it too.
_build_lock = threading.RLock()
# Plan-construction counters: `built` counts actual `build_block_schedule`
# invocations, the disk_* counters observe the persistent store, `rebuilds`
# counts plans rebuilt after their file failed validation (quarantined as
# `*.bad`) and `save_errors` writes that failed after the store's retries.
_plan_stats = {
    "built": 0,
    "disk_hits": 0,
    "disk_rejects": 0,
    "disk_saves": 0,
    "rebuilds": 0,
    "save_errors": 0,
}
_plan_stats_lock = threading.Lock()


def _bump(counter: str, by: int = 1) -> None:
    with _plan_stats_lock:
        _plan_stats[counter] += by


def stream_digest(indices) -> str:
    """SHA-256 of an index stream's bytes plus shape and dtype, over the
    stream as given (numpy). `cached_block_schedule` hashes int32 streams,
    so its keys equal the JAX package's for the same stream."""
    arr = np.ascontiguousarray(np.asarray(indices))
    h = hashlib.sha256()
    h.update(str((arr.shape, arr.dtype.str)).encode())
    h.update(arr.tobytes())
    return h.hexdigest()


def cached_block_schedule(
    indices,
    *,
    window: int,
    block_rows: int,
    max_warps: Optional[int] = None,
    device=None,
    cache_dir: Optional[str] = None,
    matrix_digest: Optional[str] = None,
) -> Tuple[BlockSchedule, bool]:
    """Build (or fetch) the warp-trimmed coalescer schedule for an index
    stream on `device` (default: a tensor's own device, else the card; see
    `coalescer.plan_device`). Returns ``(schedule, was_cached)``; repeat
    calls with a byte-identical stream and the same plan parameters return
    the identical schedule object.

    With a cache directory (``cache_dir=`` or ``$REPRO_SCHEDULE_CACHE``) a
    memory miss looks for the plan's file first (validated on load: stream
    digest always, `matrix_digest` too when both sides carry one); a file
    that fails validation is quarantined and the plan rebuilt. A fresh plan
    is written back (best effort), and a memory hit writes through when its
    file is missing. Disk hits count as ``was_cached=True``."""
    dev = plan_device(indices, device)
    stream = np.asarray(
        indices.cpu().numpy() if torch.is_tensor(indices) else indices,
        dtype=np.int32,
    )
    digest = stream_digest(stream)
    key = (digest, window, block_rows, max_warps, str(dev))
    store_kw = dict(window=window, block_rows=block_rows,
                    max_warps=max_warps, matrix_digest=matrix_digest)
    sched = _schedule_cache.get(key)
    if sched is not None:
        _write_through_if_missing(sched, digest, cache_dir=cache_dir,
                                  **store_kw)
        return sched, True
    with _build_lock:
        sched = _schedule_cache.get(key, count=False)
        if sched is not None:
            _write_through_if_missing(sched, digest, cache_dir=cache_dir,
                                      **store_kw)
            return sched, True
        cache_dir = schedule_store.resolve_cache_dir(cache_dir)
        path = None
        rebuilding = False
        if cache_dir:
            path = schedule_store.schedule_path(cache_dir, digest, **store_kw)
            if os.path.exists(path):
                try:
                    sched = schedule_store.load_schedule(
                        path,
                        expect_stream_digest=digest,
                        expect_window=window,
                        expect_block_rows=block_rows,
                        expect_matrix_digest=matrix_digest,
                        device=dev,
                    )
                    _bump("disk_hits")
                    _schedule_cache.put(key, sched)
                    return sched, True
                except schedule_store.ScheduleCacheMismatch:
                    # Self-healing: move the broken file aside so the
                    # rebuild below persists a fresh one.
                    _bump("disk_rejects")
                    schedule_store.quarantine(path)
                    rebuilding = True
        sched = trim_schedule_warps(build_block_schedule(
            stream, window=window, block_rows=block_rows,
            max_warps=max_warps, device=dev,
        ))
        _bump("built")
        if rebuilding:
            _bump("rebuilds")
            faults.note_recovered("store_read")
        _schedule_cache.put(key, sched)
        if path is not None:
            _save_best_effort(path, sched, stream_digest=digest,
                              matrix_digest=matrix_digest)
        return sched, False


def _save_best_effort(path, sched, *, stream_digest, matrix_digest) -> None:
    """Persist a plan, degrading to memory-only if the disk stays broken
    (`save_schedule` already retries transient errors)."""
    try:
        schedule_store.save_schedule(
            path, sched, stream_digest=stream_digest,
            matrix_digest=matrix_digest,
        )
        _bump("disk_saves")
    except OSError:
        _bump("save_errors")


def _write_through_if_missing(
    sched: BlockSchedule,
    digest: str,
    *,
    window: int,
    block_rows: int,
    max_warps: Optional[int],
    cache_dir: Optional[str],
    matrix_digest: Optional[str],
) -> None:
    """Persist an in-memory plan whose file does not exist yet, so a plan
    built before a cache directory was configured still reaches the disk."""
    cache_dir = schedule_store.resolve_cache_dir(cache_dir)
    if cache_dir is None:
        return
    path = schedule_store.schedule_path(
        cache_dir, digest, window=window, block_rows=block_rows,
        max_warps=max_warps, matrix_digest=matrix_digest,
    )
    with _build_lock:  # one file and one disk_saves bump per plan
        if not os.path.exists(path):
            _save_best_effort(path, sched, stream_digest=digest,
                              matrix_digest=matrix_digest)


def schedule_cache_stats() -> Dict[str, int]:
    """Plan-cache counters plus the store's IO-health counters
    (``quarantined`` / ``retries`` from `schedule_store.store_io_stats`)."""
    with _plan_stats_lock:
        snapshot = dict(_plan_stats)
    return {
        "size": len(_schedule_cache),
        "hits": _schedule_cache.hits,
        "misses": _schedule_cache.misses,
        **snapshot,
        **schedule_store.store_io_stats(),
    }


def clear_schedule_cache() -> None:
    """Empty the in-memory schedule cache and zero all its counters (the
    store's IO-health counters too; files on disk are untouched)."""
    with _build_lock:
        _schedule_cache.clear()
        with _plan_stats_lock:
            for k in _plan_stats:
                _plan_stats[k] = 0
        schedule_store.clear_store_io_stats()


def clear_engine_cache() -> None:
    _engine_cache.clear()


def engine_cache_stats() -> Dict[str, int]:
    return {
        "size": len(_engine_cache),
        "hits": _engine_cache.hits,
        "misses": _engine_cache.misses,
    }


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def _sell_content_digest(sell: SELLMatrix) -> str:
    """Content digest of a SELL matrix, memoized on the instance (treat the
    arrays as frozen after the first digest)."""
    cached = getattr(sell, "_content_digest", None)
    if cached is not None:
        return cached
    h = hashlib.sha256()
    h.update(str((sell.n_rows, sell.n_cols, sell.slice_height)).encode())
    for arr in (sell.slice_ptrs, sell.slice_widths, sell.colidx, sell.values):
        a = np.ascontiguousarray(np.asarray(arr))
        h.update(str((a.shape, a.dtype.str)).encode())
        h.update(a.tobytes())
    digest = h.hexdigest()
    sell._content_digest = digest
    return digest


class SpMVEngine:
    """Plan-once / execute-many SpMV over the coalesced data path.

    ``matrix`` may be CSR (converted to SELL here) or an already-built SELL.
    Planning is lazy: the padded plan, the schedule and the `DevicePlan`
    are built on first execution (or `plan_report`), on ``device``.

    ``backend``: ``"reference"`` (eager torch schedule-gather oracle),
    ``"cuda"`` (the SELL kernels; their plain versions on a CPU engine) or
    ``"auto"`` (cuda on a CUDA engine, reference on a CPU one). The kernels
    consume ``cols_per_chunk`` SELL columns per chunk: the padded width is
    rounded up to a multiple of it and the window is ``cols_per_chunk *
    slice_height``. ``k_tile`` is the JAX fused matmat kernel's RHS tile
    width, kept in signatures and keys (the Hopper kernel picks its own
    column tile from k: `kernels.sell_spmv.launch_config`);
    ``matmat_mode`` routes `matmat` (``"auto"``: fused on cuda, per-column
    elsewhere). ``packed`` picks the metadata encoding (``"auto"``: one
    int32 word per element whenever lossless). ``buffer_depth`` (1..8) is
    the stages of the kernels' `cp.async` ring. ``value_dtype``
    stores the SELL values as ``"bf16"``/``"f32"`` (``None``/"native":
    the right-hand side's dtype); products accumulate in the promoted dtype.
    ``device`` (default ``"cuda"``) is where the plan and the execution
    live; ``"cpu"`` asks for the CPU. ``cache_dir`` (default:
    ``$REPRO_SCHEDULE_CACHE``) enables the persistent schedule store (see
    `cached_block_schedule`).
    """

    def __init__(
        self,
        matrix: Union[CSRMatrix, SELLMatrix],
        *,
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
        plan_width_multiple: Optional[int] = None,
        device=None,
        cache_dir: Optional[str] = None,
    ):
        self.device = resolve_device(device)
        sell = normalize_to_sell(
            matrix, slice_height=slice_height, width_multiple=width_multiple
        )
        self.sell = sell
        self.backend = backend  # as requested ("auto" preserved for report)
        self.backend_resolved = resolve_backend(backend, self.device)
        self.value_dtype = resolve_value_dtype(value_dtype)
        self.cols_per_chunk = int(cols_per_chunk)
        if self.cols_per_chunk < 1:
            raise ValueError(f"cols_per_chunk must be >= 1, got {cols_per_chunk}")
        self.k_tile = int(k_tile)
        if self.k_tile < 1:
            raise ValueError(f"k_tile must be >= 1, got {k_tile}")
        if packed not in PACKED_CHOICES:
            raise ValueError(
                f"packed must be one of {PACKED_CHOICES}, got {packed!r}"
            )
        self.packed = packed
        self.buffer_depth = int(buffer_depth)
        if self.buffer_depth < 1:
            raise ValueError(
                f"buffer_depth must be >= 1, got {buffer_depth}"
            )
        self.matmat_mode = matmat_mode
        self.matmat_mode_resolved = resolve_matmat_mode(
            matmat_mode, self.backend_resolved
        )
        self.block_rows = int(block_rows)
        self.cache_dir = schedule_store.resolve_cache_dir(cache_dir)
        self.window = resolve_window(
            window,
            backend_resolved=self.backend_resolved,
            cols_per_chunk=self.cols_per_chunk,
            slice_height=sell.slice_height,
        )
        if plan_width_multiple is None:
            plan_width_multiple = (
                self.cols_per_chunk if self.backend_resolved == "cuda" else 1
            )
        self.plan_width_multiple = int(plan_width_multiple)

        self._plan_lock = threading.RLock()
        self._plan = None  # (ci_plan, va_plan, stream, W_real, W_plan)
        self._schedule: Optional[BlockSchedule] = None
        self.plan_cached: Optional[bool] = None
        self._device_plan = None  # kernels.sell_spmv.DevicePlan (cuda only)
        self._values: Dict[torch.dtype, torch.Tensor] = {}
        self._matvec = None
        self._matmat = None
        self._matmat_vmapped = None
        self._copy_stream = None  # the card's host-to-device copy stream

    # -- planning ----------------------------------------------------------

    def _ensure_plan(self):
        """Width-aware plan geometry: the padded SELL arrays, widened to
        `plan_width_multiple` (zero columns), and the index stream the
        executor consumes. Returns ``(ci_plan, va_plan, stream, W_real,
        W_plan)`` with the arrays shaped (n_slices, W_plan, H), on the host."""
        with self._plan_lock:
            if self._plan is None:
                from .spmv import _sell_padded  # local: spmv routes via engine

                ci, va, W = _sell_padded(self.sell)
                ci_plan, va_plan, W_plan = pad_width(
                    ci, va, multiple=self.plan_width_multiple
                )
                stream = np.ascontiguousarray(ci_plan.reshape(-1))
                self._plan = (ci_plan, va_plan, stream, W, W_plan)
            return self._plan

    @property
    def schedule(self) -> BlockSchedule:
        """The coalescer plan on the engine's device (content-addressed
        cache; built on first use, loaded from the persistent store when one
        is configured)."""
        with self._plan_lock:
            if self._schedule is None:
                _, _, stream, _, _ = self._ensure_plan()
                self._schedule, self.plan_cached = cached_block_schedule(
                    stream,
                    window=self.window,
                    block_rows=self.block_rows,
                    device=self.device,
                    cache_dir=self.cache_dir,
                    matrix_digest=_sell_content_digest(self.sell),
                )
            return self._schedule

    def persist_schedule(self, cache_dir: Optional[str] = None) -> Optional[str]:
        """Write the already-built schedule to the persistent store (no-op if
        nothing is planned yet, no directory is configured, or the file
        exists). Returns the file path, or None. Covers the adopt-a-directory-
        later path (`get_engine(..., cache_dir=...)` hitting an engine that
        planned without one)."""
        with self._plan_lock:
            cache_dir = schedule_store.resolve_cache_dir(
                cache_dir if cache_dir is not None else self.cache_dir
            )
            if cache_dir is None or self._schedule is None:
                return None
            _, _, stream, _, _ = self._ensure_plan()
            digest = stream_digest(stream)
            matrix_digest = _sell_content_digest(self.sell)
            path = schedule_store.schedule_path(
                cache_dir, digest, window=self.window,
                block_rows=self.block_rows, matrix_digest=matrix_digest,
            )
            if not os.path.exists(path):
                _save_best_effort(path, self._schedule, stream_digest=digest,
                                  matrix_digest=matrix_digest)
            return path

    @property
    def device_plan(self):
        """The `DevicePlan` both kernels share (cuda backend only)."""
        self._ensure_compiled()
        return self._device_plan

    def plan_values(self, dtype: torch.dtype) -> torch.Tensor:
        """The plan's SELL values on the device, stored at the value dtype
        (or the right-hand side's dtype when native) — cast once per dtype."""
        vdt = _TORCH_VALUE_DTYPES.get(self.value_dtype, dtype)
        with self._plan_lock:
            vals = self._values.get(vdt)
            if vals is None:
                va_plan = self._ensure_plan()[1]
                vals = torch.as_tensor(va_plan).to(vdt).to(self.device)
                self._values[vdt] = vals
            return vals

    def _ensure_compiled(self):
        with self._plan_lock:
            if self._matvec is None:
                self._build_executors()
            return self._matvec, self._matmat

    def _build_executors(self) -> None:
        _, _, stream, W, W_plan = self._ensure_plan()
        sched = self.schedule
        sell = self.sell
        n_slices, H = sell.n_slices, sell.slice_height
        n_rows, n_out = sell.n_rows, stream.shape[0]
        _matmat_fused = None
        _matmat_ref = None

        if self.backend_resolved == "cuda":
            from repro_torch.kernels import ops
            from repro_torch.kernels.sell_spmv import build_device_plan

            kw = dict(
                cols_per_chunk=self.cols_per_chunk,
                block_rows=self.block_rows,
                buffer_depth=self.buffer_depth,
            )
            # The schedule is lowered once; the matvec and the fused matmat
            # kernels share the plan, and colidx never reaches a kernel.
            plan = build_device_plan(
                sched, n_slices=n_slices, cols_per_chunk=self.cols_per_chunk,
                slice_height=H, packed=self.packed,
            )
            self._device_plan = plan
            k_tile = self.k_tile

            def _matvec(x: torch.Tensor) -> torch.Tensor:
                y = ops.sell_spmv(None, self.plan_values(x.dtype), x,
                                  plan=plan, **kw)
                return y[:n_rows]

            if self.matmat_mode_resolved == "fused":

                def _matmat_fused(X: torch.Tensor) -> torch.Tensor:
                    Y = ops.sell_spmm(None, self.plan_values(X.dtype), X,
                                      plan=plan, k_tile=k_tile, **kw)
                    return Y[:n_rows]

            def _matmat_cols(X: torch.Tensor) -> torch.Tensor:
                # The per-column baseline: one matvec per right-hand side.
                if X.shape[1] == 0:
                    dtype = torch.promote_types(
                        self.plan_values(X.dtype).dtype, X.dtype
                    )
                    return torch.zeros((n_rows, 0), dtype=dtype,
                                       device=X.device)
                return torch.stack(
                    [_matvec(X[:, j]) for j in range(X.shape[1])], dim=1
                )

        else:

            def _matvec(x: torch.Tensor) -> torch.Tensor:
                gathered = schedule_gather_reference(
                    x[:, None], sched, n_out=n_out
                )
                g = gathered[:, 0].reshape(n_slices, W_plan, H)[:, :W]
                va = self.plan_values(x.dtype)[:, :W]
                # Width reduction through the padding-invariant tree.
                y = _width_tree_sum(va * g, _runtime_one(x))
                return y.reshape(-1)[:n_rows]

            def _matmat_ref(X: torch.Tensor) -> torch.Tensor:
                # Direct 2-D variant of _matvec: same gather, same product,
                # same folds per column (bit-identical per column).
                k = X.shape[1]
                if k == 0:
                    return torch.zeros((n_rows, 0), dtype=X.dtype,
                                       device=X.device)
                gathered = schedule_gather_reference(X, sched, n_out=n_out)
                g = gathered.reshape(n_slices, W_plan, H, k)[:, :W]
                va = self.plan_values(X.dtype)[:, :W]
                y = _width_tree_sum(va[..., None] * g, _runtime_one(X))
                return y.reshape(-1, k)[:n_rows]

            _matmat_cols = _matmat_ref

        self._matmat_vmapped = _matmat_cols
        self._matmat = _matmat_fused if _matmat_fused is not None \
            else _matmat_cols
        self._matvec = _matvec

    # -- execution ---------------------------------------------------------

    @property
    def n_rows(self) -> int:
        return self.sell.n_rows

    @property
    def n_cols(self) -> int:
        return self.sell.n_cols

    def _check_rhs(self, X, ndim: int, name: str) -> None:
        shape = tuple(np.shape(X))
        if len(shape) != ndim or shape[0] != self.sell.n_cols:
            want = f"({self.sell.n_cols},)" if ndim == 1 \
                else f"({self.sell.n_cols}, k)"
            raise ValueError(f"{name} expects x of shape {want}, got {shape}")

    def _place(self, X, ndim: int, name: str) -> torch.Tensor:
        """A right-hand side on this engine's device, ready for the current
        stream: placed by `stage_async` (on the card through pinned memory
        and the copy stream), with the current stream waiting for its copy.
        No host sync."""
        self._check_rhs(X, ndim, name)
        stream = self.copy_stream() if self.device.type == "cuda" else None
        return self._on_compute_stream(stage_async(X, self.device, stream))

    def matvec(self, x) -> torch.Tensor:
        """y = A @ x through the cached coalesced plan. x: (n_cols,), staged
        on the engine's device; returns without waiting for the result."""
        x = self._place(x, 1, "matvec")
        mv, _ = self._ensure_compiled()
        return mv(x)

    def device_matvec(self):
        """The matvec callable itself (not its result), for a tensor already
        on the engine's device: it stages nothing and synchronises nothing,
        so the solvers can capture it in a CUDA graph (`core.solvers`)."""
        mv, _ = self._ensure_compiled()
        return mv

    def matmat(self, X) -> torch.Tensor:
        """Y = A @ X for X: (n_cols, k) — one schedule shared by all k. On
        the cuda backend this runs the fused kernel (`kernels.sell_spmm`):
        the plan and the SELL values stream once per `k_tile` columns. This
        is ``dispatch(stage(X)).Y``: it returns without waiting for Y."""
        self._check_rhs(X, 2, "matmat")
        return self.dispatch(self.stage(X)).Y

    def matmat_vmapped(self, X) -> torch.Tensor:
        """The per-column baseline: `matvec` over each RHS column (on the
        reference backend the direct 2-D form, bit-identical per column)."""
        X = self._place(X, 2, "matmat")
        self._ensure_compiled()
        return self._matmat_vmapped(X)

    def __call__(self, x) -> torch.Tensor:
        return self.matvec(x) if np.ndim(x) == 1 else self.matmat(x)

    # -- streaming pipeline hooks (runtime.Executor) ------------------------
    # matmat(X) == finalize(dispatch(stage(X))) bit for bit; stage moves
    # data, dispatch launches compute, finalize is the only host sync, and
    # each acts on one micro-batch.

    def copy_stream(self) -> "torch.cuda.Stream":
        """The stream `stage` copies right-hand sides on (the card only)."""
        with self._plan_lock:
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(device=self.device)
            return self._copy_stream

    def stage(self, X) -> Staged:
        """Start placing a RHS micro-batch (n_cols, k) on this engine's
        device. On the card a host batch goes through pinned memory (a
        pinned CPU tensor is used as it is) and a non-blocking copy on the
        copy stream, which records the batch's `copied` event; on the CPU
        the batch is placed at once."""
        if X.ndim != 2 or X.shape[0] != self.sell.n_cols:
            raise ValueError(
                f"stage expects X of shape ({self.sell.n_cols}, k), got "
                f"{tuple(X.shape)}"
            )
        stream = self.copy_stream() if self.device.type == "cuda" else None
        return stage_async(X, self.device, stream)

    def dispatch(self, staged: Staged) -> Pending:
        """Launch the batched matmat on a staged micro-batch: the compute
        (current) stream waits for that batch's copy only, and the batch's
        completion event is recorded behind the kernel. No host sync."""
        _, mm = self._ensure_compiled()
        X = self._on_compute_stream(staged)
        Y = mm(X)
        if not X.is_cuda:
            return Pending(Y)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return Pending(Y, done, staged)

    def _on_compute_stream(self, staged: Staged) -> torch.Tensor:
        """The staged batch, with the current (compute) stream waiting for
        that batch's copy only."""
        X = staged.X
        if X.is_cuda and staged.copied is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(staged.copied)
            # X was allocated on the copy stream: keep the caching allocator
            # from handing its memory out before the kernel has read it.
            X.record_stream(stream)
        return X

    def finalize(self, pending: Pending) -> torch.Tensor:
        """Wait for this micro-batch's completion event (and nothing queued
        after it); return its result."""
        if pending.done is not None:
            pending.done.synchronize()
        return pending.Y

    # -- introspection -----------------------------------------------------

    def perf(self, system: str, hw: HWConfig = DEFAULT_HW):
        """Cycle-level perf-model prediction for this matrix on one system
        ('base' | 'pack0' | 'pack64' | 'pack256')."""
        return spmv_perf(self.sell, system, hw)

    def plan_report(
        self,
        hw: HWConfig = DEFAULT_HW,
        *,
        stream: Optional[Dict[str, int]] = None,
        k: Optional[int] = None,
    ) -> Dict[str, object]:
        """The plan, inspectable: stream/coalescer stats, the store's health
        counters and perf-model predictions (the same keys and numbers as
        the JAX package, plus ``device``). ``stream=`` adds the streamed
        throughput prediction, ``k=`` the matmat amortization prediction."""
        sched = self.schedule
        _, _, plan_stream, W, W_plan = self._ensure_plan()
        wide, rate = coalesce_stats(
            plan_stream, window=self.window, block_rows=self.block_rows
        )
        health = schedule_cache_stats()
        report: Dict[str, object] = {
            "n_rows": self.sell.n_rows,
            "n_cols": self.sell.n_cols,
            "nnz_padded": self.sell.nnz_padded,
            "slice_height": self.sell.slice_height,
            "padded_width": W,
            "plan_width": W_plan,
            "backend": self.backend,
            "backend_resolved": self.backend_resolved,
            "device": str(self.device),
            "cols_per_chunk": self.cols_per_chunk,
            "k_tile": self.k_tile,
            "matmat_mode": self.matmat_mode_resolved,
            "window": self.window,
            "block_rows": self.block_rows,
            "n_windows": sched.n_windows,
            "max_warps": sched.max_warps,
            "schedule_cached": self.plan_cached,
            "wide_accesses": wide,
            "coalesce_rate": rate,
            # The store's health: quarantined files, retried IO, plans
            # rebuilt after quarantine, failed saves (process-wide).
            "cache_health": {
                key: health[key]
                for key in ("quarantined", "retries", "rebuilds", "save_errors")
            },
            "perf": {
                system: dataclasses.asdict(self.perf(system, hw))
                for system in ("base", "pack0", "pack256")
            },
        }
        if self.backend_resolved == "cuda":
            packed_resolved = resolve_packed(self.packed, sched)
            bytes_packed = schedule_meta_bytes(sched, packed=True)
            bytes_unpacked = schedule_meta_bytes(sched, packed=False)
            perf_by_enc = {
                enc: spmv_perf(
                    self.sell, "pack256", hw, meta_bytes_per_elem=bpe,
                )
                for enc, bpe in (
                    ("packed", META_BYTES_PACKED),
                    ("unpacked", META_BYTES_UNPACKED),
                )
            }
            report["metadata"] = {
                "requested": self.packed,
                "packed": packed_resolved,
                "packable": packable_schedule(sched),
                "buffer_depth": self.buffer_depth,
                "meta_bytes_per_element": (
                    META_BYTES_PACKED if packed_resolved
                    else META_BYTES_UNPACKED
                ),
                "meta_bytes": schedule_meta_bytes(
                    sched, packed=packed_resolved
                ),
                "meta_bytes_packed": bytes_packed,
                "meta_bytes_unpacked": bytes_unpacked,
                "traffic_reduction": bytes_unpacked / bytes_packed,
                "mem_util_packed": perf_by_enc["packed"].mem_utilization,
                "mem_util_unpacked": perf_by_enc["unpacked"].mem_utilization,
                "traffic_ratio_packed": perf_by_enc["packed"].traffic_ratio,
                "traffic_ratio_unpacked":
                    perf_by_enc["unpacked"].traffic_ratio,
            }
        vbpe = value_bytes_per_elem(self.value_dtype, hw)
        perf_native_v = spmv_perf(self.sell, "pack256", hw)
        perf_active_v = (
            spmv_perf(self.sell, "pack256", hw, value_bytes_per_elem=vbpe)
            if self.value_dtype is not None else perf_native_v
        )
        report["values"] = {
            "value_dtype": self.value_dtype or "native",
            "value_bytes_per_element": vbpe,
            "mem_util": perf_active_v.mem_utilization,
            "traffic_ratio": perf_active_v.traffic_ratio,
            "traffic_ratio_native": perf_native_v.traffic_ratio,
            "traffic_reduction": (
                perf_native_v.offchip_bytes / perf_active_v.offchip_bytes
            ),
        }
        if stream is not None:
            report["streaming"] = {
                **{key: int(v) for key, v in stream.items()},
                "perf": {
                    system: dataclasses.asdict(
                        streaming_spmv_perf(self.sell, system, hw=hw, **stream)
                    )
                    for system in ("base", "pack256")
                },
            }
        if k is not None:
            report["matmat"] = {
                "k": int(k),
                "k_tile": self.k_tile,
                "mode": self.matmat_mode_resolved,
                "perf": {
                    system: dataclasses.asdict(
                        matmat_spmv_perf(
                            self.sell, system, k=int(k), k_tile=self.k_tile,
                            hw=hw,
                        )
                    )
                    for system in ("pack0", "pack256")
                },
            }
        return report


def get_engine(
    matrix: Union[CSRMatrix, SELLMatrix],
    *,
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
    device=None,
    cache_dir: Optional[str] = None,
) -> SpMVEngine:
    """Engine cache: same matrix content + resolved plan parameters + device
    -> same engine. The key holds the *resolved* backend, window and matmat
    mode, as in the JAX package; cuda-only knobs (`cols_per_chunk`,
    `k_tile` when fused, `packed`, `buffer_depth`) key only cuda engines.
    `cache_dir` is not part of the key (it changes where a plan is stored,
    never what it is): a cached engine adopts a directory asked for and
    writes its plan through. Thread-safe: concurrent callers with one key
    get one engine."""
    dev = resolve_device(device)
    matrix = normalize_to_sell(
        matrix, slice_height=slice_height, width_multiple=width_multiple,
        validate=False,  # O(nnz) scan deferred to construction on a miss
    )
    resolved = resolve_backend(backend, dev)
    mode_resolved = resolve_matmat_mode(matmat_mode, resolved)
    if packed not in PACKED_CHOICES:
        raise ValueError(
            f"packed must be one of {PACKED_CHOICES}, got {packed!r}"
        )
    key = (
        _sell_content_digest(matrix),
        resolve_window(
            window,
            backend_resolved=resolved,
            cols_per_chunk=cols_per_chunk,
            slice_height=matrix.slice_height,
        ),
        block_rows,
        resolved,
        resolve_value_dtype(value_dtype),
        (
            cols_per_chunk,
            k_tile if mode_resolved == "fused" else None,
            mode_resolved,
            packed,
            int(buffer_depth),
        )
        if resolved == "cuda" else None,
        str(dev),
    )
    adopted = None
    with _engine_lock:
        eng = _engine_cache.get(key)
        if eng is None:
            eng = SpMVEngine(
                matrix,
                window=window,
                block_rows=block_rows,
                backend=backend,
                cols_per_chunk=cols_per_chunk,
                k_tile=k_tile,
                matmat_mode=matmat_mode,
                packed=packed,
                buffer_depth=buffer_depth,
                value_dtype=value_dtype,
                device=dev,
                cache_dir=cache_dir,
            )
            _engine_cache.put(key, eng)
        elif cache_dir is not None:
            eng.cache_dir = schedule_store.resolve_cache_dir(cache_dir)
            adopted = eng
    if adopted is not None:
        # the npz write runs outside the global lock (the engine's own lock
        # guards it)
        adopted.persist_schedule()
    return eng
