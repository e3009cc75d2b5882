"""Streaming executor layer and the plan/batch geometry every engine shares
(port of `repro.core.runtime`).

  * Geometry — `normalize_to_sell` (the one CSR->SELL normalization every
    engine entry point shares), `pad_width` (the width padding of the
    width-aware planner), `column_groups`/`microbatch_slices` (contiguous
    RHS column splits), `resolve_device` (the device of an engine or a
    plan: the card unless the caller asks for the CPU), and the sharded
    engine's (data, model) device grid (`DeviceMesh`).
  * Host batches — `host_tensor` casts a float64 host batch to torch's
    default dtype where it is staged, as `jnp.asarray` does with x64 off;
    `stage_async` places a batch on a device.
  * `Executor` — the protocol an execution engine implements: beyond
    `matvec`/`matmat`, ``stage(X)`` (start placing a RHS micro-batch on the
    executor's device), ``dispatch(staged)`` (launch compute, no host sync)
    and ``finalize(pending)`` (wait for that micro-batch and return it), with
    ``finalize(dispatch(stage(X))) == matmat(X)`` bit for bit. On the card
    `stage_async` is JAX's asynchronous `device_put`: a non-blocking copy
    from pinned host memory on a copy stream, which records an event the
    compute stream waits on; `Pending.done` is the one array
    `block_until_ready` would wait on.
  * `StreamingExecutor` — wraps any `Executor` and micro-batches RHS
    columns through a pipeline of bounded depth: while micro-batch *i*
    computes, micro-batch *i+1* is copied to the card. Host batches are
    packed into a ring of ``depth`` pinned buffers (`PinnedRing`, the port's
    `device_put_rhs`); a buffer is packed again only after its last copy has
    completed. `submit()`/`drain()` expose the pipeline to serving loops,
    `matmat()` keeps the synchronous signature, and the fault-tolerance
    knobs (``timeout``, ``retries``, ``validate``, the ``dispatch_timeout``
    fault site at retirement) behave as in the JAX package.

Dependency direction: below `engine` for the geometry helpers, above it for
scheduling (`StreamingExecutor` talks to engines only through the protocol).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Protocol, Tuple, \
    Union, runtime_checkable

import numpy as np
import torch

from . import faults
from .formats import CSRMatrix, SELLMatrix, csr_to_sell
from .spans import span

DEFAULT_MICROBATCH = 32
DEFAULT_DEPTH = 2


def normalize_to_sell(
    matrix: Union[CSRMatrix, SELLMatrix],
    *,
    slice_height: Optional[int] = None,
    width_multiple: int = 1,
    validate: bool = True,
) -> SELLMatrix:
    """CSR inputs are validated and converted (the offline preprocessing
    step); SELL inputs are checked against the requested conversion
    parameters. ``validate=False`` skips the O(nnz) SELL well-formedness scan
    for hot cache-lookup paths (`get_engine`), where construction on a miss
    validates anyway."""
    if isinstance(matrix, CSRMatrix):
        kw = {} if slice_height is None else {"slice_height": slice_height}
        with span("repro.plan.layout", stage="csr_to_sell"):
            matrix.validate()
            return csr_to_sell(matrix, width_multiple=width_multiple, **kw)
    if isinstance(matrix, SELLMatrix):
        if slice_height is not None and slice_height != matrix.slice_height:
            raise ValueError(
                f"matrix is already SELL with slice_height="
                f"{matrix.slice_height}; cannot re-slice to {slice_height} "
                f"(convert from CSR instead)"
            )
        if width_multiple != 1 and np.any(
            np.asarray(matrix.slice_widths) % width_multiple
        ):
            raise ValueError(
                f"matrix is already SELL and its slice widths are not "
                f"multiples of {width_multiple} (convert from CSR instead)"
            )
        if validate:
            with span("repro.plan.layout", stage="validate_sell"):
                matrix.validate()
        return matrix
    raise TypeError(f"expected CSRMatrix or SELLMatrix, got {type(matrix)}")


def pad_width(
    ci: np.ndarray, va: np.ndarray, *, multiple: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Zero-pad (n_slices, W, H) colidx/value arrays up to the next multiple
    of ``multiple`` columns (colidx 0 / value 0 — safe for SpMV). Returns
    ``(ci_plan, va_plan, W_plan)``; when W already satisfies the multiple the
    inputs pass through unchanged."""
    ns, W, H = ci.shape
    m = int(multiple)
    if m < 1:
        raise ValueError(f"width multiple must be >= 1, got {multiple}")
    W_plan = max(-(-W // m) * m, m)
    if W_plan == W:
        return ci, va, W
    ci_plan = np.zeros((ns, W_plan, H), dtype=ci.dtype)
    va_plan = np.zeros((ns, W_plan, H), dtype=va.dtype)
    ci_plan[:, :W] = ci
    va_plan[:, :W] = va
    return ci_plan, va_plan, W_plan


def pad_slices(
    sell: SELLMatrix, *, multiple: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Each slice of `sell` at its own width, rounded up to a multiple of
    ``multiple`` columns (at least one: a slice of width 0 gets one zero
    chunk), the new columns colidx 0 / value 0 after the slice's own.
    Returns ``(colidx, values, widths)``: the slices' storage end to end,
    column-major within each slice as `SELLMatrix` keeps it, and the new
    widths; the arrays pass through where every width already fits."""
    m = int(multiple)
    if m < 1:
        raise ValueError(f"width multiple must be >= 1, got {multiple}")
    H = sell.slice_height
    widths = np.asarray(sell.slice_widths, dtype=np.int64)
    new = np.maximum(-(-widths // m) * m, m)
    if np.array_equal(new, widths):
        return sell.colidx, sell.values, new
    ptr = np.zeros(widths.size + 1, dtype=np.int64)
    ptr[1:] = np.cumsum(new * H)
    colidx = np.zeros(int(ptr[-1]), dtype=sell.colidx.dtype)
    values = np.zeros(int(ptr[-1]), dtype=sell.values.dtype)
    # an element keeps its place within its slice: column-major (width, H)
    # storage puts the new columns after the old ones
    shift = ptr[:-1] - np.asarray(sell.slice_ptrs, dtype=np.int64)[:-1]
    dst = np.arange(sell.nnz_padded, dtype=np.int64) + np.repeat(
        shift, widths * H)
    colidx[dst] = sell.colidx
    values[dst] = sell.values
    return colidx, values, new


def column_groups(k: int, n_groups: int) -> List[slice]:
    """Balanced contiguous split of `k` RHS columns into at most `n_groups`
    non-empty slices."""
    n_groups = max(1, min(n_groups, k)) if k else 1
    bounds = np.linspace(0, k, n_groups + 1).astype(int)
    return [
        slice(int(bounds[j]), int(bounds[j + 1]))
        for j in range(n_groups)
        if bounds[j + 1] > bounds[j]
    ]


def microbatch_slices(k: int, microbatch: int) -> List[slice]:
    """Fixed-size contiguous split of `k` RHS columns into micro-batches of
    ``microbatch`` columns (the last one may be short)."""
    if microbatch < 1:
        raise ValueError(f"microbatch must be >= 1, got {microbatch}")
    return [slice(j, min(j + microbatch, k)) for j in range(0, k, microbatch)]


@dataclasses.dataclass(eq=False)
class DeviceMesh:
    """The sharded engine's device grid, the port's two-axis
    `jax.sharding.Mesh`: `devices` is a 2-D numpy object array of
    `torch.device`s, ``devices[i, j]`` on data row ``i`` and model column
    ``j``. One device may appear more than once (shards round-robin onto
    it). `launch.mesh` builds them."""

    devices: np.ndarray
    axis_names = ("data", "model")

    def __post_init__(self) -> None:
        self.devices = np.asarray(self.devices, dtype=object)
        if self.devices.ndim != 2:
            raise ValueError(
                f"a mesh is a (data, model) grid; got {self.devices.ndim} "
                f"axes"
            )

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def resolve_device(device=None) -> torch.device:
    """The device of an engine or a plan: ``None`` means the card. A CUDA
    device without a card raises — nothing carries on on the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default, but torch "
                "finds none; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be a CUDA device or 'cpu', got {dev}")
    return dev


def host_tensor(X) -> torch.Tensor:
    """A host batch (numpy or array-like) as a CPU tensor, floating data
    wider than torch's default dtype cast to it: float64 becomes float32, as
    `jnp.asarray` does with x64 off, so a float64 request computes what it
    computes in the JAX package. A tensor passes through with its dtype."""
    if torch.is_tensor(X):
        return X
    t = torch.as_tensor(np.asarray(X))
    default = torch.get_default_dtype()
    if t.is_floating_point() and t.element_size() > default.itemsize:
        t = t.to(default)
    return t


def stage_rhs(X, device) -> torch.Tensor:
    """Place a right-hand side (numpy array or tensor) on `device`. A host
    numpy batch is copied (through `host_tensor`); a tensor passes through
    with its dtype."""
    return host_tensor(X).to(device)


def parse_stream_spec(spec: str) -> Dict[str, int]:
    """``"depth=D,microbatch=B"`` -> streaming parameters (either key may be
    omitted; defaults fill in). The CLI surface of the streaming layer:
    `serve --spmv --stream depth=2,microbatch=16`."""
    out = {"depth": DEFAULT_DEPTH, "microbatch": DEFAULT_MICROBATCH}
    for part in (p.strip() for p in spec.split(",") if p.strip()):
        key, sep, val = part.partition("=")
        key = key.strip()
        if not sep or key not in out:
            raise ValueError(
                f"--stream expects 'depth=D,microbatch=B' (either key "
                f"optional), got {spec!r}"
            )
        try:
            out[key] = int(val)
        except ValueError:
            raise ValueError(
                f"--stream {key} must be an integer, got {val.strip()!r}"
            )
        if out[key] < 1:
            raise ValueError(f"--stream {key} must be >= 1, got {out[key]}")
    return out


# ---------------------------------------------------------------------------
# The executor protocol and its per-micro-batch handles
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Staged:
    """A RHS micro-batch on (or on its way to) its executor's device. On the
    card `copied` is the event recorded behind its host-to-device copy and
    `copy_start` the one before it (both timed); `host` keeps the pinned
    source alive. Elsewhere the events are None."""

    X: torch.Tensor
    copied: Optional["torch.cuda.Event"] = None
    copy_start: Optional["torch.cuda.Event"] = None
    host: Optional[torch.Tensor] = None

    def copy_ms(self) -> float:
        """Device milliseconds of the copy (0 where there was none); call
        once `copied` has completed."""
        if self.copy_start is None:
            return 0.0
        return float(self.copy_start.elapsed_time(self.copied))


@dataclasses.dataclass
class Pending:
    """A dispatched micro-batch: its result and, on the card, the event
    recorded behind its kernel (what `finalize` waits on)."""

    Y: torch.Tensor
    done: Optional["torch.cuda.Event"] = None
    staged: Optional[Staged] = None


@runtime_checkable
class Executor(Protocol):
    """What the streaming layer (and any serving loop) requires of an
    execution engine; `SpMVEngine` and `dist.ShardedSpMVEngine` implement it.
    The contract is

        finalize(dispatch(stage(X))) == matmat(X)   (bit for bit)

    with `stage` performing only data placement (asynchronous on the card),
    `dispatch` only launching compute (no host sync), and `finalize` waiting
    for that one micro-batch.
    """

    @property
    def n_rows(self) -> int: ...

    @property
    def n_cols(self) -> int: ...

    def matvec(self, x): ...

    def matmat(self, X): ...

    def stage(self, X) -> Any: ...

    def dispatch(self, staged) -> Any: ...

    def finalize(self, pending): ...

    def plan_report(self, **kwargs) -> Dict[str, object]: ...


def stage_async(X, device: torch.device, copy_stream=None) -> Staged:
    """Start placing `X` (numpy or a tensor) on `device`. On the card a host
    batch is packed into pinned memory unless it is pinned already, then
    copied without blocking on `copy_stream`, where `copied` is recorded; a
    tensor already on the card is made contiguous on the current stream.
    Elsewhere this is `stage_rhs`."""
    if device.type != "cuda":
        return Staged(stage_rhs(X, device))
    if torch.is_tensor(X) and X.is_cuda:
        X = X.to(device).contiguous()
        copied = torch.cuda.Event()
        copied.record(torch.cuda.current_stream(device))
        return Staged(X, copied)
    host = host_tensor(X)
    if not host.is_pinned():
        pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        pinned.copy_(host)
        host = pinned
    with torch.cuda.stream(copy_stream):
        start = torch.cuda.Event(enable_timing=True)
        copied = torch.cuda.Event(enable_timing=True)
        start.record()
        dev = torch.empty(host.shape, dtype=host.dtype, device=device)
        dev.copy_(host, non_blocking=True)
        copied.record()
    return Staged(dev, copied, start, host)


def proper_slice(sl: slice, k: int) -> bool:
    """True when `sl` selects a strict subset of the k source columns. An
    identity slice stages the caller's batch itself; a proper slice is a
    strided view that staging packs into a buffer of its own."""
    return (sl.stop - sl.start) < k


def on_compute_stream(staged: Staged, device: torch.device) -> torch.Tensor:
    """The staged batch, with `device`'s current (compute) stream waiting
    for that batch's copy only. No host sync."""
    X = staged.X
    if X.is_cuda and staged.copied is not None:
        stream = torch.cuda.current_stream(device)
        stream.wait_event(staged.copied)
        # X was allocated on the copy stream: keep the caching allocator
        # from handing its memory out before the kernel has read it.
        X.record_stream(stream)
    return X


class PinnedRing:
    """``depth`` pinned host buffers of ``rows x cols`` elements that a
    streaming pipeline packs its host micro-batches into. A slot is packed
    again only after the copy that last read it has completed (its
    `copied` event); pinned allocation failing raises (nothing stages from
    pageable memory in its place). Slots are handed out and returned by the
    owning `StreamingExecutor` under its lock."""

    def __init__(self, depth: int, rows: int, cols: int, dtype: torch.dtype):
        self._bufs = [torch.empty(int(rows) * int(cols), dtype=dtype,
                                  pin_memory=True) for _ in range(depth)]
        self._copied: List[Optional["torch.cuda.Event"]] = [None] * depth
        self.free: Deque[int] = deque(range(depth))

    def pack(self, slot: int, src: torch.Tensor) -> torch.Tensor:
        """Copy the host micro-batch `src` (rows, w <= cols) into `slot`
        once its previous copy is done; returns the contiguous pinned view."""
        ev = self._copied[slot]
        if ev is not None:
            ev.synchronize()
        view = self._bufs[slot][: src.shape[0] * src.shape[1]].view(
            src.shape)
        view.copy_(src)
        return view

    def note_copy(self, slot: int, copied) -> None:
        self._copied[slot] = copied


# ---------------------------------------------------------------------------
# The streaming executor
# ---------------------------------------------------------------------------


class StreamHandle:
    """One submitted RHS batch moving through the pipeline. `result()`
    drives the owning `StreamingExecutor` until every micro-batch of this
    batch has been finalized, then assembles the output columns in order."""

    def __init__(self, owner: "StreamingExecutor", k: int, n_parts: int,
                 dtype: torch.dtype) -> None:
        self._owner = owner
        self.k = k
        self._parts: List[Optional[torch.Tensor]] = [None] * n_parts
        self._remaining = n_parts
        self._dtype = dtype
        self._error: Optional[BaseException] = None
        self._collected = False
        self.retries = 0  # micro-batch retries spent on this batch

    @property
    def error(self) -> Optional[BaseException]:
        """The failure recorded for this batch, if any (after retries)."""
        return self._error

    @property
    def done(self) -> bool:
        return self._remaining == 0 or self._error is not None

    @property
    def failed(self) -> bool:
        return self._error is not None

    def result(self):
        """Block until this batch is complete and return (n_rows, k);
        re-raises the pipeline error if any of its micro-batches failed."""
        return self._owner._complete(self)

    def _deliver(self, idx: int, part) -> None:
        if self._error is not None:
            return  # batch already failed; late part is discarded
        self._parts[idx] = part
        self._remaining -= 1

    def _fail(self, exc: BaseException) -> None:
        if self._error is None:
            self._error = exc

    def _assemble(self):
        """Column-concatenate the finalized micro-batches (on their device)."""
        if self._error is not None:
            raise self._error
        if not self._parts:
            return torch.zeros((self._owner.n_rows, 0), dtype=self._dtype,
                               device=self._owner.device)
        if len(self._parts) == 1:
            return self._parts[0]
        return torch.cat(self._parts, dim=1)


class StreamTimeout(RuntimeError):
    """A micro-batch's device sync exceeded the pipeline's `timeout`."""


@dataclasses.dataclass
class BatchFailure:
    """One submitted batch that still failed after the pipeline's bounded
    retries — `drain()` reports these instead of raising."""

    index: int  # position in submission order among that drain's batches
    k: int
    error: BaseException
    retries: int


class DrainResult(list):
    """`drain()`'s return value: the healthy batch results in submission
    order (a list), plus `failures`, the batches that failed after retries.
    A healthy drain has ``failures == []``."""

    def __init__(self, results=(), failures: Optional[List[BatchFailure]] = None):
        super().__init__(results)
        self.failures: List[BatchFailure] = list(failures or ())

    @property
    def ok(self) -> bool:
        return not self.failures


class _InflightEntry:
    """One reserved slot in the in-flight window. The slot is reserved under
    the pipeline lock, its stage/dispatch runs outside it; `ready` flips
    once `pending` holds the dispatched work. `X`/`sl` are kept so a failed
    micro-batch can be re-staged from source; `slot` is its ring buffer."""

    __slots__ = ("handle", "idx", "pending", "ready", "X", "sl", "attempts",
                 "ring", "slot")

    def __init__(self, handle: StreamHandle, idx: int, X=None, sl=None) -> None:
        self.handle = handle
        self.idx = idx
        self.pending: Any = None
        self.ready = False
        self.X = X
        self.sl = sl
        self.attempts = 0
        self.ring: Optional[PinnedRing] = None
        self.slot: Optional[int] = None


def _host_tensor(X) -> Optional[torch.Tensor]:
    """A host batch as a CPU tensor (`host_tensor`; None for a tensor on
    the card)."""
    if torch.is_tensor(X) and X.is_cuda:
        return None
    return host_tensor(X)


class StreamingExecutor:
    """Micro-batch pipeline of bounded depth over any `Executor`.

    ``matmat(X)`` splits the RHS columns into ``microbatch``-wide
    micro-batches and pipelines them: micro-batch *i+1* is staged (on the
    card: packed into a pinned ring buffer and copied on the executor's copy
    stream) while micro-batch *i* computes, and results are finalized only
    when the bounded in-flight window forces it or the caller asks.
    ``depth`` is the backpressure bound: at most ``depth`` staged-or-
    computing micro-batches exist at once, and the ring holds ``depth``
    buffers. ``depth=1`` is the synchronous schedule (the A/B control).

    ``submit(X)`` feeds the pipeline without waiting for results (it blocks
    only when the window is full, on the oldest micro-batch); ``drain()``
    retires everything in flight and returns the uncollected batches in
    submission order. ``matmat`` is submit + complete-one, bit-identical to
    the wrapped executor's ``matmat`` on the reference backend.

    Thread-safe: a condition variable guards the pipeline state, and the
    blocking `finalize` always runs outside it. `staging` reports the host
    seconds spent packing micro-batches into the ring and the device
    milliseconds of their copies.
    """

    def __init__(
        self,
        executor: Executor,
        *,
        microbatch: int = DEFAULT_MICROBATCH,
        depth: int = DEFAULT_DEPTH,
        timeout: Optional[float] = None,
        retries: int = 0,
        validate: bool = False,
    ) -> None:
        if microbatch < 1:
            raise ValueError(f"microbatch must be >= 1, got {microbatch}")
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if timeout is not None and not timeout > 0:
            raise ValueError(f"timeout must be > 0 seconds, got {timeout}")
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        for hook in ("matmat", "stage", "dispatch", "finalize"):
            if not callable(getattr(executor, hook, None)):
                raise TypeError(
                    f"executor {type(executor).__name__} does not implement "
                    f"the Executor protocol (missing {hook}); see "
                    f"core.runtime.Executor"
                )
        self.executor = executor
        self.microbatch = int(microbatch)
        self.depth = int(depth)
        # `timeout` bounds each micro-batch's `finalize` in seconds;
        # `retries` bounds how often a failed or timed-out micro-batch is
        # re-staged from source before its batch is reported failed;
        # `validate` rejects NaN/Inf right-hand sides at submit.
        self.timeout = None if timeout is None else float(timeout)
        self.retries = int(retries)
        self.validate = bool(validate)
        self.device = torch.device(getattr(executor, "device", "cpu"))
        self._stats = {"retries": 0, "timeouts": 0, "failures": 0}
        self._staging = {"microbatches": 0, "pack_s": 0.0, "copy_ms": 0.0}
        self._rings: Dict[torch.dtype, PinnedRing] = {}
        self._cv = threading.Condition()
        self._inflight: Deque[_InflightEntry] = deque()  # reservation order
        self._submitted: List[StreamHandle] = []

    @property
    def stats(self) -> Dict[str, int]:
        """Pipeline fault counters: micro-batch ``retries``, ``timeouts``
        observed, and batches reported as ``failures`` after retries."""
        with self._cv:
            return dict(self._stats)

    @property
    def staging(self) -> Dict[str, float]:
        """Micro-batches staged, host seconds packing them into the pinned
        ring (``pack_s``) and device milliseconds of their host-to-device
        copies (``copy_ms``, summed at retirement)."""
        with self._cv:
            return dict(self._staging)

    # -- pipeline plumbing --------------------------------------------------

    @property
    def n_rows(self) -> int:
        return self.executor.n_rows

    @property
    def n_cols(self) -> int:
        return self.executor.n_cols

    @property
    def in_flight(self) -> int:
        """Micro-batches currently staged or computing (<= depth always)."""
        with self._cv:
            return len(self._inflight)

    def _ring(self, dtype: torch.dtype) -> PinnedRing:
        with self._cv:
            ring = self._rings.get(dtype)
            if ring is None:
                ring = self._rings[dtype] = PinnedRing(
                    self.depth, self.n_cols, self.microbatch, dtype)
            return ring

    def _stage(self, entry: _InflightEntry):
        """Stage + dispatch one micro-batch. A host batch bound for the card
        is packed into the entry's ring buffer first (taking a free one, and
        waiting for one to be returned, when it has none)."""
        src = entry.X[:, entry.sl]
        host = _host_tensor(src) if self.device.type == "cuda" else None
        if host is not None:
            ring = self._ring(host.dtype)
            with self._cv:
                while entry.slot is None:
                    if ring.free:
                        entry.ring, entry.slot = ring, ring.free.popleft()
                    else:
                        self._cv.wait()
            t0 = time.perf_counter()
            src = ring.pack(entry.slot, host)
            with self._cv:
                self._staging["pack_s"] += time.perf_counter() - t0
        staged = self.executor.stage(src)
        if host is not None:
            ring.note_copy(entry.slot, getattr(staged, "copied", None))
        with self._cv:
            self._staging["microbatches"] += 1
        return self.executor.dispatch(staged)

    def _release(self, entry: _InflightEntry) -> None:
        """Return the entry's ring buffer (under the lock)."""
        if entry.slot is not None:
            entry.ring.free.append(entry.slot)
            entry.slot = None
            self._cv.notify_all()

    def _note_copy_time(self, pending) -> None:
        staged = getattr(pending, "staged", None)
        if staged is not None:
            ms = staged.copy_ms()
            with self._cv:
                self._staging["copy_ms"] += ms

    def _retire_oldest(self) -> bool:
        """Finalize the oldest *ready* in-flight micro-batch, outside the
        lock. Returns False when nothing was in flight."""
        with self._cv:
            while True:
                if not self._inflight:
                    return False
                entry = next((e for e in self._inflight if e.ready), None)
                if entry is not None:
                    break
                self._cv.wait()
            self._inflight.remove(entry)
            self._cv.notify_all()  # a window slot is free
        injected_sites: List[str] = []
        try:
            while True:
                try:
                    faults.maybe_inject(
                        "dispatch_timeout",
                        f"injected micro-batch timeout (part {entry.idx})",
                    )
                    part = self._finalize_timed(entry.pending)
                    self._note_copy_time(entry.pending)
                except Exception as exc:
                    if isinstance(exc, StreamTimeout):
                        with self._cv:
                            self._stats["timeouts"] += 1
                    if isinstance(exc, faults.FaultInjected):
                        injected_sites.append(exc.site)
                    restaged = False
                    while entry.attempts < self.retries and entry.X is not None:
                        # Bounded retry: re-stage this micro-batch from source
                        # and re-dispatch.
                        entry.attempts += 1
                        with self._cv:
                            self._stats["retries"] += 1
                            entry.handle.retries += 1
                        try:
                            entry.pending = self._stage(entry)
                            restaged = True
                            break
                        except Exception as exc2:
                            exc = exc2  # restage itself failed; spend a retry
                    if restaged:
                        continue  # finalize the freshly dispatched work
                    # Out of retries: fail the handle so every waiter
                    # completes; the error surfaces once, at its collector.
                    with self._cv:
                        self._stats["failures"] += 1
                        entry.handle._fail(exc)
                        self._cv.notify_all()
                    return True
                break
        finally:
            with self._cv:
                self._release(entry)
        for site in injected_sites:
            faults.note_recovered(site)
        with self._cv:
            entry.handle._deliver(entry.idx, part)
            self._cv.notify_all()
        return True

    def _finalize_timed(self, pending):
        """`finalize` with the per-micro-batch deadline applied: the wait
        runs on a helper thread only when a timeout is set; exceeding it
        raises `StreamTimeout` (the abandoned daemon thread stays parked on
        the micro-batch's event)."""
        if self.timeout is None:
            return self.executor.finalize(pending)
        box: Dict[str, Any] = {}

        def _run() -> None:
            try:
                box["value"] = self.executor.finalize(pending)
            except BaseException as exc:  # surfaces on the caller thread
                box["error"] = exc

        t = threading.Thread(target=_run, daemon=True)
        t.start()
        t.join(self.timeout)
        if t.is_alive():
            raise StreamTimeout(
                f"micro-batch finalize exceeded timeout={self.timeout}s"
            )
        if "error" in box:
            raise box["error"]
        return box["value"]

    def _pump(self, handle: StreamHandle, X, slices) -> None:
        """Stage + dispatch every micro-batch of `X`, retiring the oldest
        in-flight work whenever the window is full."""
        try:
            self._pump_inner(handle, X, slices)
        except BaseException as exc:
            with self._cv:
                handle._fail(exc)
                handle._collected = True
                if handle in self._submitted:
                    self._submitted.remove(handle)
                self._cv.notify_all()
            raise

    def _pump_inner(self, handle: StreamHandle, X, slices) -> None:
        for idx, sl in enumerate(slices):
            entry = _InflightEntry(handle, idx, X, sl)
            while True:  # reserve a window slot
                with self._cv:
                    if len(self._inflight) < self.depth:
                        self._inflight.append(entry)
                        self._cv.notify_all()
                        break
                if not self._retire_oldest():
                    with self._cv:
                        if len(self._inflight) >= self.depth:
                            self._cv.wait()
            try:
                pending = self._stage(entry)
            except BaseException:
                with self._cv:  # release the reserved slot and its buffer
                    try:
                        self._inflight.remove(entry)
                    except ValueError:
                        pass
                    self._release(entry)
                    self._cv.notify_all()
                raise
            with self._cv:
                entry.pending = pending
                entry.ready = True
                self._cv.notify_all()

    def _complete(self, handle: StreamHandle):
        # Claim the handle before waiting, so a concurrent drain() does not
        # hand the same result out twice.
        with self._cv:
            handle._collected = True
        while True:
            with self._cv:
                if handle.done:
                    if handle in self._submitted:
                        self._submitted.remove(handle)
                    return handle._assemble()
            if not self._retire_oldest():
                with self._cv:
                    if not handle.done and not self._inflight:
                        self._cv.wait()

    # -- public API ---------------------------------------------------------

    def submit(self, X) -> StreamHandle:
        """Feed one RHS batch (n_cols, k) — numpy or a tensor — into the
        pipeline. Returns a handle whose `result()` blocks for that batch
        only; blocks here only while the in-flight window is full."""
        if not (isinstance(X, np.ndarray) or torch.is_tensor(X)):
            X = np.asarray(X)
        if X.ndim != 2 or X.shape[0] != self.n_cols:
            raise ValueError(
                f"submit expects X of shape ({self.n_cols}, k), got "
                f"{tuple(X.shape)}"
            )
        if self.validate and X.shape[1] and not (
            np.all(np.isfinite(X)) if isinstance(X, np.ndarray)
            else bool(torch.isfinite(X).all())
        ):
            raise ValueError(
                "submit rejected RHS batch: non-finite values (NaN/Inf) in X "
                "(validate=True guards the pipeline against poisoned inputs)"
            )
        k = int(X.shape[1])
        slices = microbatch_slices(k, self.microbatch) if k else []
        dtype = host_tensor(X[:0]).dtype
        handle = StreamHandle(self, k, len(slices), dtype)
        with self._cv:
            self._submitted.append(handle)
        self._pump(handle, X, slices)
        return handle

    def drain(self) -> DrainResult:
        """Retire all in-flight work; return every not-yet-collected batch's
        result in submission order (an empty `DrainResult` when idle). A
        batch collected by its own `result()` is excluded. Failures are
        reported in `DrainResult.failures`, not raised."""
        while True:
            if self._retire_oldest():
                continue
            with self._cv:
                if self._inflight:
                    continue  # a concurrent submit refilled the window
                if not all(h.done for h in self._submitted):
                    self._cv.wait()  # parts mid-finalize on another thread
                    continue
                pending = [h for h in self._submitted if not h._collected]
                for h in pending:
                    h._collected = True
                self._submitted = []
            return DrainResult(
                (h._assemble() for h in pending if not h.failed),
                failures=[
                    BatchFailure(
                        index=i, k=h.k, error=h._error, retries=h.retries
                    )
                    for i, h in enumerate(pending) if h.failed
                ],
            )

    def matvec(self, x):
        """Single-RHS convenience: streams a (n_cols, 1) batch."""
        if not (isinstance(x, np.ndarray) or torch.is_tensor(x)):
            x = np.asarray(x)
        if x.ndim != 1 or x.shape[0] != self.n_cols:
            raise ValueError(
                f"matvec expects x of shape ({self.n_cols},), got "
                f"{tuple(x.shape)}"
            )
        return self.matmat(x[:, None])[:, 0]

    def matmat(self, X):
        """Y = A @ X through the pipeline — drop-in for `Executor.matmat`,
        bit-identical to it on the reference backend."""
        return self.submit(X).result()

    def __call__(self, x):
        return self.matvec(x) if np.ndim(x) == 1 else self.matmat(x)

    # -- introspection ------------------------------------------------------

    def plan_report(self, *, k: Optional[int] = None, **kwargs):
        """The wrapped executor's plan report with the perf model's overlap
        prediction for this pipeline shape under ``streaming``; `k` defaults
        to one full in-flight window, and the ``matmat`` section is at the
        micro-batch width (every dispatch is one micro-batch)."""
        stream = {
            "k": self.depth * self.microbatch if k is None else int(k),
            "microbatch": self.microbatch,
            "depth": self.depth,
        }
        kwargs.setdefault("k", self.microbatch)
        return self.executor.plan_report(stream=stream, **kwargs)
