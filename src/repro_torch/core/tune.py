"""Plan autotuner: search (cols_per_chunk, block_rows, k_tile, packed,
buffer_depth, value_dtype) per matrix (port of `repro.core.tune`).

  * ``mode="model"`` (default) scores every candidate with
    `perfmodel.plan_matmat_cycles` on the candidate's own plan geometry:
    numpy on the index stream, no device, deterministic — the winner equals
    the JAX package's for the same matrix, k, backend and space.
  * ``mode="measure"`` builds each candidate's engine on the engine's
    device and times real calls (``matmat``; ``matvec`` at k = 1, the call
    a one-column server and the solvers make), interleaved round-robin
    across candidates so drift hits every candidate alike: CUDA events
    behind a synchronise on the card, the host clock on the CPU. A
    candidate whose kernel geometry the card refuses (`kernels.sell_spmv.
    launch_config` raises) is scored as infeasible and counted; if every
    candidate is, the search raises. On the card the candidates' device
    bytes are reckoned before they are built, and where they do not fit
    together they are timed in groups, the groups' winners then once more
    against each other (`Trial` lists what each candidate took).
  * On the cuda backend k_tile is cut to one value before the search: the
    Hopper kernels take their column tile from k, so the knob would only
    score one geometry several times (`_card_space`).
  * Winners persist content-addressed as ``tune-<key>.json`` under
    ``$REPRO_TUNE_CACHE`` (or the schedule store's directory), with the JAX
    package's version, key and body: a winner for the same question is one
    file both packages read, each running zero trials. Tampered or stale
    files are quarantined and re-searched, as in `core.schedule_store`.

`get_tuned_engine` closes the loop: autotune, then feed the winning knobs
into `get_engine` (``serve --spmv --tune`` is the CLI surface).
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from . import faults, schedule_store
from .coalescer import META_BYTES_PACKED, META_BYTES_UNPACKED
from .engine import DEFAULT_K_TILE, SpMVEngine, VALUE_DTYPES, \
    _sell_content_digest, get_engine, resolve_backend, resolve_value_dtype, \
    value_bytes_per_elem
from .formats import CSRMatrix, SELLMatrix
from .perfmodel import DEFAULT_HW, HWConfig, plan_matmat_cycles
from .runtime import normalize_to_sell, pad_width, resolve_device

TUNE_CACHE_ENV = "REPRO_TUNE_CACHE"
TUNE_VERSION = 3  # the JAX package's: v3 added value_dtype to the space

# The JAX package's search space (216 candidates). On the card k_tile does
# not shape the kernels (`launch_config` takes the column tile from k), so
# a search there keeps one value of it (`_card_space`): 72 candidates.
DEFAULT_SPACE: Dict[str, Tuple] = {
    "cols_per_chunk": (4, 8, 16),
    "block_rows": (4, 8, 16),
    "k_tile": (4, 8, 16),
    "packed": (0, 1),
    "buffer_depth": (1, 2),
    "value_dtype": ("native", "bf16"),
}
TUNE_MODES = ("model", "measure")
# Share of the card's free memory one group of measured candidates may take.
MEASURE_MEMORY_SHARE = 0.5


@dataclasses.dataclass(frozen=True)
class TunedPlan:
    """One search winner. ``trials`` counts the candidate evaluations *this
    call* ran (0 on any cache hit); ``source`` says where the winner came
    from ('search' | 'memory' | 'disk')."""

    cols_per_chunk: int
    block_rows: int
    k_tile: int
    packed: int  # 0 | 1 — int (not bool) so the space/JSON stay uniform
    buffer_depth: int
    value_dtype: str  # 'native' | 'bf16' | 'f32' (engine.VALUE_DTYPES)
    k: int
    backend: str  # resolved
    mode: str
    cost: float  # model cycles (mode='model') or best measured us
    trials: int
    source: str


@dataclasses.dataclass
class Trial:
    """One measured candidate: its knobs, its best time in microseconds
    (inf when infeasible), the measurement group it ran in, and the error
    that made it infeasible."""

    candidate: Dict[str, object]
    us: float = float("inf")
    group: int = 0
    error: Optional[str] = None


_memory: Dict[str, TunedPlan] = {}
_lock = threading.Lock()
_stats = {
    "searched": 0, "trials": 0, "memory_hits": 0, "disk_hits": 0,
    "disk_rejects": 0, "disk_saves": 0,
    # Self-healing counters, as in the schedule store: rejected winner files
    # are quarantined (`*.bad`) and re-searched; transient IO errors on the
    # atomic write are retried; a write that stays broken degrades to
    # memory-only.
    "quarantined": 0, "retries": 0, "save_errors": 0,
    # Measured candidates whose geometry the card refused.
    "infeasible": 0,
}


def tune_stats() -> Dict[str, int]:
    with _lock:
        return dict(_stats)


def clear_tune_cache() -> None:
    """Empty the in-memory tune cache and zero the counters (on-disk files
    are untouched — the cross-process cache is the point)."""
    with _lock:
        _memory.clear()
        for key in _stats:
            _stats[key] = 0


def _bump(counter: str, by: int = 1) -> None:
    with _lock:
        _stats[counter] += by


def resolve_tune_cache_dir(cache_dir: Optional[str]) -> Optional[str]:
    """Explicit directory wins; else ``$REPRO_TUNE_CACHE``; else the schedule
    store's directory (``$REPRO_SCHEDULE_CACHE``); else None (persistence
    off)."""
    if cache_dir is not None:
        return str(cache_dir)
    env = os.environ.get(TUNE_CACHE_ENV) or None
    if env is not None:
        return env
    return schedule_store.resolve_cache_dir(None)


def _normalize_space(
    space: Optional[Dict[str, Iterable[int]]]
) -> Dict[str, Tuple[int, ...]]:
    space = dict(DEFAULT_SPACE) if space is None else dict(space)
    unknown = set(space) - set(DEFAULT_SPACE)
    if unknown:
        raise ValueError(
            f"unknown tune-space knobs {sorted(unknown)}; valid: "
            f"{sorted(DEFAULT_SPACE)}"
        )
    out: Dict[str, Tuple] = {}
    for knob in DEFAULT_SPACE:
        raw = space.get(knob, DEFAULT_SPACE[knob])
        if knob == "value_dtype":
            values = tuple(sorted({str(v) for v in raw}))
            if not values or any(v not in VALUE_DTYPES for v in values):
                raise ValueError(
                    f"tune-space knob 'value_dtype' must list strings in "
                    f"{VALUE_DTYPES}, got {values}")
            out[knob] = values
            continue
        values = tuple(sorted({int(v) for v in raw}))
        if knob == "packed":
            if not values or any(v not in (0, 1) for v in values):
                raise ValueError(
                    f"tune-space knob 'packed' must list ints in (0, 1), "
                    f"got {values}")
        elif not values or any(v < 1 for v in values):
            raise ValueError(f"tune-space knob {knob!r} must list ints >= 1, "
                             f"got {values}")
        out[knob] = values
    return out


def _candidates(space: Dict[str, Tuple[int, ...]]) -> List[Dict[str, int]]:
    knobs = sorted(space)
    return [
        dict(zip(knobs, combo))
        for combo in itertools.product(*(space[k] for k in knobs))
    ]


def tune_key(
    matrix_digest: str, *, k: int, backend: str, mode: str,
    space: Dict[str, Tuple[int, ...]],
    hw: HWConfig = DEFAULT_HW,
    rounds: Optional[int] = None,
) -> str:
    """Filename-safe digest of the search identity (the JAX package's
    payload, so the same question gets the same file): matrix, k, backend,
    mode, space, the hardware model and — for measured searches only — the
    trial count."""
    payload = repr((
        TUNE_VERSION, matrix_digest, int(k), backend, mode,
        tuple(sorted((knob, space[knob]) for knob in space)),
        tuple(sorted(dataclasses.asdict(hw).items())),
        None if rounds is None else int(rounds),
    ))
    return hashlib.sha256(payload.encode()).hexdigest()[:32]


def tune_path(cache_dir: str, key: str) -> str:
    return os.path.join(cache_dir, f"tune-{key}.json")


def _save(path: str, plan: TunedPlan, *, matrix_digest: str, key: str) -> None:
    payload = {
        "version": TUNE_VERSION,
        "matrix_digest": matrix_digest,
        "key": key,
        "winner": dataclasses.asdict(plan),
    }
    dirname = os.path.dirname(path) or "."
    os.makedirs(dirname, exist_ok=True)
    blob = json.dumps(payload, indent=2).encode()
    try:
        schedule_store.retry_io(
            lambda: schedule_store.atomic_write_bytes(
                path, lambda f: f.write(blob), suffix=".json.tmp"
            ),
            what=f"save tuned plan {path}",
            on_retry=lambda: _bump("retries"),
        )
    except OSError:
        _bump("save_errors")
        return
    _bump("disk_saves")


def _load(
    path: str, *, matrix_digest: str, key: str,
    space: Dict[str, Tuple[int, ...]], k: int, backend: str, mode: str,
) -> Optional[TunedPlan]:
    """Load a persisted winner; any mismatch counts as a miss. Beyond the
    header (version, digest, key), the winner body is validated against the
    search it claims to answer: every knob from the keyed space, and
    k/backend/mode/cost the question's own. A rejected file is quarantined
    (``*.bad``) so the re-search that follows can persist a fresh one."""
    faults.corrupt_file(path, "store_read")

    def _read():
        with open(path) as f:
            return json.load(f)

    try:
        payload = schedule_store.retry_io(
            _read, what=f"load tuned plan {path}",
            on_retry=lambda: _bump("retries"),
        )
        if (
            payload.get("version") != TUNE_VERSION
            or payload.get("matrix_digest") != matrix_digest
            or payload.get("key") != key
        ):
            raise ValueError("header mismatch")
        w = payload["winner"]
        plan = TunedPlan(
            cols_per_chunk=int(w["cols_per_chunk"]),
            block_rows=int(w["block_rows"]),
            k_tile=int(w["k_tile"]),
            packed=int(w["packed"]),
            buffer_depth=int(w["buffer_depth"]),
            value_dtype=str(w["value_dtype"]),
            k=int(w["k"]),
            backend=str(w["backend"]),
            mode=str(w["mode"]),
            cost=float(w["cost"]),
            trials=int(w["trials"]),
            source="disk",
        )
        if (
            plan.cols_per_chunk not in space["cols_per_chunk"]
            or plan.block_rows not in space["block_rows"]
            or plan.k_tile not in space["k_tile"]
            or plan.packed not in space["packed"]
            or plan.buffer_depth not in space["buffer_depth"]
            or plan.value_dtype not in space["value_dtype"]
            or plan.k != int(k)
            or plan.backend != backend
            or plan.mode != mode
            or not np.isfinite(plan.cost)
            or plan.trials < 0
        ):
            raise ValueError("winner body mismatch")
    except Exception:
        _bump("disk_rejects")
        schedule_store.quarantine(
            path, on_quarantine=lambda: _bump("quarantined")
        )
        # The caller re-searches and re-saves on a None return, which is the
        # recovery for an injected read corruption.
        faults.note_recovered("store_read")
        return None
    _bump("disk_hits")
    return plan


def _model_search(
    sell: SELLMatrix,
    candidates: List[Dict[str, int]],
    *,
    k: int,
    hw: HWConfig,
) -> Tuple[Dict[str, int], float, int]:
    """Score every candidate with the fused-matmat cycle model on its own
    plan geometry. The width-padded stream is shared across candidates with
    the same cols_per_chunk (padding is the only cpc-dependent part)."""
    from .spmv import _sell_padded  # local: spmv routes via engine

    ci, va, _ = _sell_padded(sell)
    H = sell.slice_height
    streams: Dict[int, np.ndarray] = {}
    best: Optional[Tuple[float, Dict[str, int]]] = None
    trials = 0
    for cand in candidates:
        cpc = cand["cols_per_chunk"]
        if cpc not in streams:
            ci_p, _, _ = pad_width(ci, va, multiple=cpc)
            streams[cpc] = np.ascontiguousarray(ci_p.reshape(-1))
        cost = plan_matmat_cycles(
            streams[cpc],
            n_rows=sell.n_rows,
            n_slices=sell.n_slices,
            k=k,
            k_tile=cand["k_tile"],
            window=cpc * H,
            block_rows=cand["block_rows"],
            hw=hw,
            meta_bytes_per_elem=(
                META_BYTES_PACKED if cand["packed"] else META_BYTES_UNPACKED
            ),
            buffer_depth=cand["buffer_depth"],
            value_bytes_per_elem=value_bytes_per_elem(
                cand["value_dtype"], hw=hw
            ),
        )
        trials += 1
        if best is None or cost < best[0]:
            best = (cost, cand)
    assert best is not None
    return best[1], best[0], trials


def candidate_device_bytes(
    sell: SELLMatrix, cand: Dict[str, object], *, with_schedule: bool
) -> int:
    """An upper bound on the device bytes a measured candidate's engine
    holds: its values and metadata at the padded plan width, and its tag
    matrix at the most warps a window can need (the window's elements, or
    every block of x); with the coalescer schedule it plans from when
    `with_schedule` (candidates of one cols_per_chunk and block_rows share
    it)."""
    cpc, br = int(cand["cols_per_chunk"]), int(cand["block_rows"])
    H = sell.slice_height
    W = int(np.max(sell.slice_widths, initial=0))
    W_plan = max(-(-W // cpc) * cpc, cpc)
    elems = sell.n_slices * W_plan * H
    n_windows = sell.n_slices * (W_plan // cpc)
    tags = n_windows * min(cpc * H, -(-sell.n_cols // br)) * 4
    value_bytes = 2 if cand["value_dtype"] == "bf16" else 4
    meta_bytes = META_BYTES_PACKED if cand["packed"] else META_BYTES_UNPACKED
    total = elems * (value_bytes + meta_bytes) + tags
    if with_schedule:  # elem_warp, elem_offset (int32), elem_valid, tags
        total += elems * 9 + tags
    return int(total)


def _measure_groups(
    sell: SELLMatrix, candidates: List[Dict[str, object]],
    device: torch.device, reserve: int,
) -> List[List[int]]:
    """Candidate indices in groups whose engines fit the card together
    (`candidate_device_bytes` within `MEASURE_MEMORY_SHARE` of its free
    memory, less `reserve`); one group off the card."""
    if device.type != "cuda":
        return [list(range(len(candidates)))]
    free, _ = torch.cuda.mem_get_info(device)
    budget = MEASURE_MEMORY_SHARE * free - reserve
    groups: List[List[int]] = [[]]
    used, schedules = 0, set()
    for i, cand in enumerate(candidates):
        key = (cand["cols_per_chunk"], cand["block_rows"])
        need = candidate_device_bytes(sell, cand,
                                      with_schedule=key not in schedules)
        if groups[-1] and used + need > budget:
            groups.append([])
            used, schedules = 0, set()
            need = candidate_device_bytes(sell, cand, with_schedule=True)
        groups[-1].append(i)
        used += need
        schedules.add(key)
    return groups

def _card_space(space: Dict[str, Tuple]) -> Dict[str, Tuple]:
    """The space a search on the card runs: k_tile, which the kernels do
    not have, cut to one value (the engine default when listed), so that no
    candidate is scored or timed twice over the same geometry."""
    k_tiles = space["k_tile"]
    keep = DEFAULT_K_TILE if DEFAULT_K_TILE in k_tiles else k_tiles[0]
    return {**space, "k_tile": (keep,)}


def _timer(device: torch.device):
    """Microseconds of one call: CUDA events behind a synchronise on the
    card, the host clock elsewhere."""
    if device.type != "cuda":
        def host_us(fn) -> float:
            t0 = time.perf_counter()
            fn()
            return (time.perf_counter() - t0) * 1e6
        return host_us

    def card_us(fn) -> float:
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) * 1e3
    return card_us


def _release(device: torch.device) -> None:
    """Hand the memory of engines just dropped back to the card, so that
    the next group is built in the room `_measure_groups` reckoned with."""
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _time_round_robin(
    engines: Dict[int, SpMVEngine], call, rounds: int, timer,
) -> Tuple[Dict[int, float], int]:
    """Best time of each engine over `rounds` interleaved rounds."""
    best = {i: float("inf") for i in engines}
    trials = 0
    for _ in range(rounds):
        for i, eng in engines.items():
            best[i] = min(best[i], timer(lambda: call(eng)))
            trials += 1
    return best, trials


def _measure_search(
    sell: SELLMatrix,
    candidates: List[Dict[str, int]],
    *,
    k: int,
    backend: str,
    rounds: int,
    device: torch.device,
    trial_log: Optional[List[Trial]] = None,
) -> Tuple[Dict[str, int], float, int]:
    """Time real calls per candidate, interleaved round-robin. Engines are
    built here (not through the engine cache) so that a group's engines are
    released before the next group is built; their schedules stay in the
    content-addressed schedule cache, so the winner's engine, built next by
    `get_tuned_engine`, plans from it."""
    rng = np.random.default_rng(0)
    X = torch.as_tensor(
        rng.standard_normal((sell.n_cols, k)).astype(np.float32),
        device=device,
    )
    x = X[:, 0].contiguous()

    def call(eng: SpMVEngine):
        # a one-column server (and every solver) calls matvec
        return eng.matvec(x) if k == 1 else eng.matmat(X)

    def engine(i: int) -> SpMVEngine:
        cand = candidates[i]
        return SpMVEngine(
            sell,
            backend=backend,
            cols_per_chunk=cand["cols_per_chunk"],
            block_rows=cand["block_rows"],
            k_tile=cand["k_tile"],
            packed=bool(cand["packed"]),
            buffer_depth=cand["buffer_depth"],
            value_dtype=resolve_value_dtype(cand["value_dtype"]),
            device=device,
        )

    timer = _timer(device)
    trials_ = [Trial(dict(c)) for c in candidates]

    def measure(members: List[int]) -> int:
        """Build, warm and time `members` together; returns the timed
        calls. A geometry the card refuses raises ValueError on its first
        call: it is scored as infeasible."""
        engines: Dict[int, SpMVEngine] = {}
        for i in members:
            eng = engine(i)
            try:  # plan + first launch outside the timed rounds
                call(eng)
            except ValueError as exc:
                trials_[i].error = str(exc)
                _bump("infeasible")
                continue
            engines[i] = eng
        eng = None
        best, n = _time_round_robin(engines, call, rounds, timer)
        for i, us in best.items():
            trials_[i].us = us
        engines.clear()
        _release(device)
        return n

    groups = _measure_groups(sell, candidates, device,
                             reserve=X.numel() * 4 * 3)
    trials = 0
    for g, members in enumerate(groups):
        for i in members:
            trials_[i].group = g
        trials += measure(members)
    feasible = [i for i, t in enumerate(trials_) if t.error is None]
    if not feasible:
        raise RuntimeError(
            f"every one of the {len(candidates)} candidates was infeasible "
            f"on {device}: {trials_[0].error}"
        )
    if len(groups) > 1:
        # The groups' winners once more, interleaved against each other, so
        # that drift between groups does not pick the winner.
        best_of: Dict[int, int] = {}
        for i in feasible:
            g = trials_[i].group
            if g not in best_of or trials_[i].us < trials_[best_of[g]].us:
                best_of[g] = i
        trials += measure(sorted(best_of.values()))
    if trial_log is not None:
        trial_log.extend(trials_)
    i_best = min(feasible, key=lambda i: trials_[i].us)
    return candidates[i_best], trials_[i_best].us, trials


def autotune(
    matrix: Union[CSRMatrix, SELLMatrix],
    *,
    k: int,
    backend: str = "auto",
    mode: str = "model",
    space: Optional[Dict[str, Iterable[int]]] = None,
    rounds: int = 3,
    slice_height: Optional[int] = None,
    cache_dir: Optional[str] = None,
    hw: HWConfig = DEFAULT_HW,
    device=None,
    trial_log: Optional[List[Trial]] = None,
) -> TunedPlan:
    """Find (cols_per_chunk, block_rows, k_tile, packed, buffer_depth,
    value_dtype) for serving k-column products on this matrix. Returns the
    cached winner when one exists — in memory first, then the persistent
    store — running zero trials; only a new (matrix, k, backend, mode,
    space) question searches. ``device`` (default the card) resolves
    ``backend="auto"`` and is where measure mode builds and times its
    engines; a measured search appends one `Trial` per candidate to
    `trial_log` when one is given."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if mode not in TUNE_MODES:
        raise ValueError(f"mode must be one of {TUNE_MODES}, got {mode!r}")
    dev = resolve_device(device)
    sell = normalize_to_sell(matrix, slice_height=slice_height, validate=False)
    resolved = resolve_backend(backend, dev)
    norm_space = _normalize_space(space)
    if resolved == "cuda":
        norm_space = _card_space(norm_space)
    digest = _sell_content_digest(sell)
    key = tune_key(
        digest, k=k, backend=resolved, mode=mode, space=norm_space, hw=hw,
        rounds=rounds if mode == "measure" else None,
    )

    with _lock:
        cached = _memory.get(key)
        if cached is not None:
            _stats["memory_hits"] += 1
    if cached is not None:
        return dataclasses.replace(cached, trials=0, source="memory")

    cache_dir = resolve_tune_cache_dir(cache_dir)
    path = tune_path(cache_dir, key) if cache_dir else None
    if path is not None and os.path.exists(path):
        plan = _load(
            path, matrix_digest=digest, key=key, space=norm_space, k=k,
            backend=resolved, mode=mode,
        )
        if plan is not None:
            with _lock:
                _memory[key] = plan
            return dataclasses.replace(plan, trials=0)

    candidates = _candidates(norm_space)
    if mode == "model":
        winner, cost, trials = _model_search(
            sell, candidates, k=k, hw=hw
        )
    else:
        winner, cost, trials = _measure_search(
            sell, candidates, k=k, backend=backend, rounds=rounds,
            device=dev, trial_log=trial_log,
        )
    plan = TunedPlan(
        cols_per_chunk=winner["cols_per_chunk"],
        block_rows=winner["block_rows"],
        k_tile=winner["k_tile"],
        packed=winner["packed"],
        buffer_depth=winner["buffer_depth"],
        value_dtype=winner["value_dtype"],
        k=int(k),
        backend=resolved,
        mode=mode,
        cost=float(cost),
        trials=trials,
        source="search",
    )
    _bump("searched")
    _bump("trials", trials)
    with _lock:
        _memory[key] = plan
    if path is not None:
        _save(path, plan, matrix_digest=digest, key=key)
    return plan


def get_tuned_engine(
    matrix: Union[CSRMatrix, SELLMatrix],
    *,
    k: int,
    backend: str = "auto",
    mode: str = "model",
    space: Optional[Dict[str, Iterable[int]]] = None,
    rounds: int = 3,
    slice_height: Optional[int] = None,
    tune_cache_dir: Optional[str] = None,
    cache_dir: Optional[str] = None,
    device=None,
    trial_log: Optional[List[Trial]] = None,
) -> Tuple[SpMVEngine, TunedPlan]:
    """Autotune, then feed the winning knobs straight into `get_engine`.
    Returns ``(engine, tuned_plan)``. `cache_dir` is the *schedule* store
    (forwarded to the engine); `tune_cache_dir` the tuner's own store (both
    default to their environment variables, the tuner falling back to the
    schedule directory)."""
    plan = autotune(
        matrix, k=k, backend=backend, mode=mode, space=space, rounds=rounds,
        slice_height=slice_height, cache_dir=tune_cache_dir, device=device,
        trial_log=trial_log,
    )
    engine = get_engine(
        matrix,
        backend=backend,
        cols_per_chunk=plan.cols_per_chunk,
        block_rows=plan.block_rows,
        k_tile=plan.k_tile,
        packed=bool(plan.packed),
        buffer_depth=plan.buffer_depth,
        value_dtype=resolve_value_dtype(plan.value_dtype),
        slice_height=slice_height,
        device=device,
        cache_dir=cache_dir,
    )
    return engine, plan
