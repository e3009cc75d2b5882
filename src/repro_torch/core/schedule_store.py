"""Persistent on-disk store for coalescer `BlockSchedule`s (port of
`repro.core.schedule_store`; its files and this module's are the same files).

Planning is the one expensive, matrix-dependent step of the engine's
plan-once/execute-many split (the paper's offline preprocessing, Sec. III).
The in-memory content-addressed cache amortizes it within a process; this
module amortizes it *across* processes: schedules are serialized to
digest-named ``.npz`` files under a cache directory, so a cold serving
process that has seen a matrix before skips `build_block_schedule` entirely.

File layout: ``<cache_dir>/sched-<key>.npz`` where ``key`` hashes the plan
identity — the index-stream digest plus (window, block_rows, max_warps) and,
for engine-planned schedules, the owning matrix's content digest. Each file
carries a JSON header with:

  * ``version`` — store format version; other versions are rejected.
  * ``stream_digest`` — the SHA-256 of the index stream the schedule was
    built for. A schedule executed against a different stream would silently
    gather the wrong elements, so a mismatch always rejects the file.
  * ``matrix_digest`` — content digest of the owning matrix (values
    included), when the schedule was planned by an engine. The stream digest
    alone cannot distinguish two matrices that share a column-index stream;
    the matrix digest closes that hole for engine-planned schedules: if both
    the file and the loader carry one and they differ, the file is rejected.
  * plan geometry (``window``, ``block_rows``, ``n_windows``,
    ``max_warps``) — cross-checked against the arrays on load so a truncated
    or hand-edited file cannot produce a malformed schedule.

Writes are atomic (temp file + ``os.replace``) so a crashed process never
leaves a half-written schedule for the next one to trip over.

The store is **self-healing**: transient IO errors (ENOSPC / EIO, real or
injected via `core.faults`) get bounded retry with exponential backoff, a
file that fails validation is quarantined (renamed ``*.bad``) by the caller
via `quarantine` so the next lookup replans instead of re-tripping, and an
interrupted atomic write always cleans up its temp file and descriptor.
`store_io_stats()` surfaces the ``quarantined`` / ``retries`` counters that
`engine.schedule_cache_stats()` folds into its report.

The cache directory defaults to the ``REPRO_SCHEDULE_CACHE`` environment
variable (unset = persistence off); `SpMVEngine`, `GatherEngine` and
``launch/serve.py --schedule-cache`` thread explicit directories through.

The arrays cross the file as numpy with the JAX package's dtypes (int32
fields, a bool ``elem_valid``) and the same header, so either package loads
the other's files; a loaded schedule lands on the device the caller names.
"""
from __future__ import annotations

import errno
import hashlib
import json
import os
import tempfile
import threading
import time
from typing import Callable, Dict, Optional, TypeVar

import numpy as np
import torch

from . import faults
from .coalescer import BlockSchedule
from .runtime import resolve_device

_T = TypeVar("_T")

CACHE_DIR_ENV = "REPRO_SCHEDULE_CACHE"
# v2: partial-window tail padding no longer mints a spurious block-0 warp, so
# v1 files can disagree with the fixed planner's warp counts (`n_warps`,
# plan_report coalesce stats) — reject them and replan rather than serve
# stale metadata.
STORE_VERSION = 2

_ARRAY_FIELDS = ("tags", "n_warps", "elem_warp", "elem_offset", "elem_valid")


class ScheduleCacheMismatch(ValueError):
    """A persisted schedule exists but cannot be used: wrong store version,
    wrong stream/matrix digest, inconsistent geometry, or unreadable file.
    Callers treat this as a cache miss and replan."""


# --- IO-health counters (shared by every store) ----------------------------

IO_RETRIES = 3
IO_BACKOFF_BASE_S = 0.01

_io_stats: Dict[str, int] = {"quarantined": 0, "retries": 0}
_io_stats_lock = threading.Lock()


def _bump_io(counter: str, by: int = 1) -> None:
    with _io_stats_lock:
        _io_stats[counter] += by


def store_io_stats() -> Dict[str, int]:
    """Snapshot of persistence-layer health counters (all stores)."""
    with _io_stats_lock:
        return dict(_io_stats)


def clear_store_io_stats() -> None:
    with _io_stats_lock:
        for k in _io_stats:
            _io_stats[k] = 0


_TRANSIENT_ERRNOS = frozenset(
    {errno.ENOSPC, errno.EIO, errno.EAGAIN, errno.EINTR, errno.EBUSY}
)


def transient_io(exc: BaseException) -> bool:
    """True for IO errors worth retrying (disk momentarily full / flaky)."""
    return isinstance(exc, OSError) and exc.errno in _TRANSIENT_ERRNOS


def retry_io(
    fn: Callable[[], _T],
    *,
    what: str,
    retries: int = IO_RETRIES,
    base_delay: float = IO_BACKOFF_BASE_S,
    on_retry: Optional[Callable[[], None]] = None,
) -> _T:
    """Run `fn`, retrying transient IO errors with exponential backoff.

    Non-transient exceptions propagate immediately; after `retries` failed
    retries the last transient error propagates too.  Each retry bumps the
    module ``retries`` counter (plus the caller's `on_retry` hook, e.g. the
    store's local tally).
    """
    attempt = 0
    injected: Dict[str, int] = {}
    while True:
        try:
            result = fn()
        except OSError as e:
            if not transient_io(e) or attempt >= retries:
                raise
            if isinstance(e, faults.FaultInjected):
                injected[e.site] = injected.get(e.site, 0) + 1
            _bump_io("retries")
            if on_retry is not None:
                on_retry()
            time.sleep(base_delay * (2 ** attempt))
            attempt += 1
            continue
        # Retrying past an injected transient error counts as a recovery.
        for site, n in injected.items():
            faults.note_recovered(site, n)
        return result


def quarantine(path: str, *, on_quarantine: Optional[Callable[[], None]] = None) -> Optional[str]:
    """Rename a failed-validation cache file to ``<path>.bad`` so the next
    lookup rebuilds instead of re-reading the same broken bytes.

    Returns the quarantine path, or None if the file vanished underneath us
    (another process may have quarantined it first — that is fine).
    """
    bad = path + ".bad"
    try:
        os.replace(path, bad)
    except OSError:
        return None
    _bump_io("quarantined")
    if on_quarantine is not None:
        on_quarantine()
    return bad


def resolve_cache_dir(cache_dir: Optional[str]) -> Optional[str]:
    """Explicit directory wins; else the env var; else None (persistence off)."""
    if cache_dir is not None:
        return str(cache_dir)
    return os.environ.get(CACHE_DIR_ENV) or None


def plan_key_digest(
    stream_digest: str, *, window: int, block_rows: int,
    max_warps: Optional[int] = None, matrix_digest: Optional[str] = None,
) -> str:
    """Filename-safe digest of the plan identity (stream + plan params).

    `matrix_digest` (when the planner has matrix context) is part of the key:
    two matrices that share an index stream get *separate* files rather than
    endlessly rejecting and overwriting each other's plan — the header check
    in `load_schedule` then only fires on tampered/corrupt files."""
    payload = repr((
        stream_digest, int(window), int(block_rows),
        None if max_warps is None else int(max_warps),
        matrix_digest,
    ))
    return hashlib.sha256(payload.encode()).hexdigest()[:32]


def schedule_path(
    cache_dir: str, stream_digest: str, *, window: int, block_rows: int,
    max_warps: Optional[int] = None, matrix_digest: Optional[str] = None,
) -> str:
    key = plan_key_digest(
        stream_digest, window=window, block_rows=block_rows,
        max_warps=max_warps, matrix_digest=matrix_digest,
    )
    return os.path.join(cache_dir, f"sched-{key}.npz")


def save_schedule(
    path: str,
    schedule: BlockSchedule,
    *,
    stream_digest: str,
    matrix_digest: Optional[str] = None,
) -> str:
    """Atomically write `schedule` to `path`. Returns the final path."""
    header = {
        "version": STORE_VERSION,
        "stream_digest": stream_digest,
        "matrix_digest": matrix_digest,
        "window": int(schedule.window),
        "block_rows": int(schedule.block_rows),
        "n_windows": schedule.n_windows,
        "max_warps": schedule.max_warps,
    }
    arrays = {
        name: getattr(schedule, name).cpu().numpy() for name in _ARRAY_FIELDS
    }
    dirname = os.path.dirname(path) or "."
    os.makedirs(dirname, exist_ok=True)

    def _attempt() -> None:
        atomic_write_bytes(
            path,
            lambda f: np.savez_compressed(f, header=json.dumps(header), **arrays),
            suffix=".npz.tmp",
        )

    retry_io(_attempt, what=f"save schedule {path}")
    return path


def atomic_write_bytes(
    path: str, write: Callable[[object], None], *, suffix: str = ".tmp"
) -> None:
    """One atomic write attempt: temp file + ``os.replace``.

    Guarantees that neither the temp file nor its descriptor outlives a
    failure anywhere on the serialize/rename path (`write` raising, `fdopen`
    itself raising, or `os.replace` failing) — an interrupted write must
    never strand ``*.tmp`` files in the cache dir.  Raises whatever the
    failing step raised; `retry_io` decides whether to try again.
    """
    dirname = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=dirname, suffix=suffix)
    try:
        try:
            f = os.fdopen(fd, "wb")
        except BaseException:
            os.close(fd)
            raise
        with f:
            write(f)
            # Simulated ENOSPC/EIO from the chaos harness lands here, after
            # bytes hit the temp file — the torn-write cleanup path below is
            # exactly what a real mid-write disk error exercises.
            faults.maybe_inject("store_write", f"simulated disk error writing {path}")
        os.replace(tmp, path)
    except BaseException:
        try:
            if os.path.exists(tmp):
                os.unlink(tmp)
        except OSError:
            pass
        raise


def load_schedule(
    path: str,
    *,
    expect_stream_digest: Optional[str] = None,
    expect_window: Optional[int] = None,
    expect_block_rows: Optional[int] = None,
    expect_matrix_digest: Optional[str] = None,
    device=None,
) -> BlockSchedule:
    """Load and validate a persisted schedule, onto `device` (default: the
    card; see `runtime.resolve_device`).

    Raises `ScheduleCacheMismatch` on any header/geometry disagreement; the
    matrix-digest check only applies when both sides carry a digest (a
    schedule saved without matrix context is valid for any matrix whose
    stream matches — stream identity is what schedule correctness needs).

    Transient IO errors (EIO and friends) are retried with backoff before
    being treated as an unreadable file; the chaos harness's ``store_read``
    site corrupts the bytes on disk right here, so injected corruption flows
    through the very same rejection path a real torn file would.
    """
    faults.corrupt_file(path, "store_read")

    def _read():
        with np.load(path, allow_pickle=False) as z:
            return (
                json.loads(z["header"].item()),
                {name: z[name] for name in _ARRAY_FIELDS},
            )

    try:
        header, arrays = retry_io(_read, what=f"load schedule {path}")
    except Exception as e:
        raise ScheduleCacheMismatch(f"unreadable schedule file {path}: {e}")

    if header.get("version") != STORE_VERSION:
        raise ScheduleCacheMismatch(
            f"{path}: store version {header.get('version')!r}, "
            f"expected {STORE_VERSION}"
        )
    if (
        expect_stream_digest is not None
        and header.get("stream_digest") != expect_stream_digest
    ):
        raise ScheduleCacheMismatch(
            f"{path}: stream digest mismatch (file planned for a different "
            f"index stream)"
        )
    if (
        expect_matrix_digest is not None
        and header.get("matrix_digest") is not None
        and header["matrix_digest"] != expect_matrix_digest
    ):
        raise ScheduleCacheMismatch(
            f"{path}: matrix digest mismatch (file planned for a different "
            f"matrix with the same index stream)"
        )
    window = int(header.get("window", -1))
    block_rows = int(header.get("block_rows", -1))
    if expect_window is not None and window != expect_window:
        raise ScheduleCacheMismatch(
            f"{path}: planned for window={window}, expected {expect_window}"
        )
    if expect_block_rows is not None and block_rows != expect_block_rows:
        raise ScheduleCacheMismatch(
            f"{path}: planned for block_rows={block_rows}, "
            f"expected {expect_block_rows}"
        )

    tags = arrays["tags"]
    n_windows, max_warps = (
        (int(tags.shape[0]), int(tags.shape[1])) if tags.ndim == 2 else (-1, -1)
    )
    geometry_ok = (
        tags.ndim == 2
        and n_windows == int(header.get("n_windows", -1))
        and max_warps == int(header.get("max_warps", -1))
        and arrays["n_warps"].shape == (n_windows,)
        and arrays["elem_warp"].shape == (n_windows, window)
        and arrays["elem_offset"].shape == (n_windows, window)
        and arrays["elem_valid"].shape == (n_windows, window)
    )
    if not geometry_ok:
        raise ScheduleCacheMismatch(
            f"{path}: array shapes disagree with the header (corrupt file?)"
        )
    dev = resolve_device(device)

    def field(name, dtype):
        return torch.as_tensor(np.asarray(arrays[name]), device=dev).to(dtype)

    return BlockSchedule(
        tags=field("tags", torch.int32),
        n_warps=field("n_warps", torch.int32),
        elem_warp=field("elem_warp", torch.int32),
        elem_offset=field("elem_offset", torch.int32),
        elem_valid=field("elem_valid", torch.bool),
        window=window,
        block_rows=block_rows,
    )
