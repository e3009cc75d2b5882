"""Iterative solvers over the plan-once SpMV engine (port of
`repro.core.solvers`).

One coalescing schedule serves every iteration: the engine's matvec
(`SpMVEngine.device_matvec`, the `sell_spmv` kernel on the card) is the
whole SpMV of each step, and the convergence scalars stay on the device.
Three loops, selected by ``loop=``:

- ``"while"`` — the port of `jax.lax.while_loop`. Each solver's step is
  written once as a *guarded* step: it computes ``active = (k < maxiter) &
  (metric > tol)`` on the device and advances the state only where active
  (`torch.where`), so after convergence a step changes nothing. The loop
  runs blocks of guarded steps (16, 4 or 1: `WHILE_BLOCKS`) and reads the
  step count and the metric on the host once per block, so iteration
  counts stay exact; each block's length comes from the metric's rate of
  decrease, so that few steps run past convergence. On the card each
  block length is captured once per (solver, maxiter, dtype, block) into a
  `torch.cuda.CUDAGraph` and replayed; a capture that fails raises. On the
  CPU the same blocks run eagerly. Default whenever the executor exposes
  `device_matvec`.
- ``"python"`` — the unguarded step with a host check every iteration:
  the oracle. ``while`` and ``python`` agree bit for bit (the same
  arithmetic in the same order).
- ``"host"`` — a numpy loop through `Executor.matvec`, for executors
  without a device matvec (`runtime.StreamingExecutor`). Sharded operators
  are not ported yet (ROADMAP A10) and raise.

A replayed graph reads the buffers it was captured with, so every solve
copies its own starting state — b, x0, the tolerance, the damping — into
those buffers before the first replay (the JAX package's rule that nothing
per-call may be baked into a cached step).

Every solve reports `schedule_builds` (the delta of the global plan-build
counter: 1 cold, 0 warm) and `matvecs`, the matvecs it ran: the iterations
(plus cg's initial residual) and, on the ``while`` loop, the guarded steps
of a last block that ran past convergence.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .engine import get_engine, schedule_cache_stats
from .formats import CSRMatrix, SELLMatrix, coo_to_csr

__all__ = [
    "SolveResult",
    "WHILE_BLOCKS",
    "cg",
    "jacobi",
    "pagerank",
    "power_iteration",
    "transition_matrix",
]

_LOOPS = ("auto", "while", "python", "host")

#: Block lengths (guarded steps) of the ``while`` loop, longest first; one
#: host read a block (`_next_block` picks each block's length).
WHILE_BLOCKS = (16, 4, 1)


@dataclasses.dataclass
class SolveResult:
    """Outcome of an iterative solve.

    ``residual`` is the solver's own convergence metric at exit: relative
    2-norm residual ||b - Ax|| / ||b|| for cg/jacobi, L1 iterate delta for
    pagerank, relative eigen-residual ||Ax - lam x|| / |lam| for
    power_iteration. ``schedule_builds`` counts coalescing-schedule builds
    observed during this solve (1 cold, 0 warm); ``matvecs`` the matvecs the
    solve ran. ``x`` is a tensor on the executor's device (numpy for
    ``loop="host"``).
    """

    x: object
    iterations: int
    residual: float
    converged: bool
    solver: str
    loop: str
    schedule_builds: int
    residual_trace: Optional[np.ndarray] = None
    eigenvalue: Optional[float] = None
    matvecs: int = 0


# --------------------------------------------------------------------------
# Operator / loop resolution


def _resolve_operator(A, *, backend: str, engine_kw: dict):
    if isinstance(A, (CSRMatrix, SELLMatrix)):
        return get_engine(A, backend=backend, **engine_kw)
    if callable(getattr(A, "matvec", None)):
        if backend != "auto" or engine_kw:
            opts = [f"backend={backend!r}"] if backend != "auto" else []
            opts += [f"{k}=..." for k in engine_kw]
            raise ValueError(
                f"{', '.join(opts)} cannot be applied to a prebuilt "
                f"{type(A).__name__} — it already fixes the backend and "
                f"engine options; pass the matrix instead, or drop the "
                f"engine arguments"
            )
        return A
    raise TypeError(
        f"expected a CSRMatrix/SELLMatrix or an Executor with .matvec, got "
        f"{type(A).__name__}"
    )


def _default_dtype() -> torch.dtype:
    """The default real dtype (float32, as JAX's without x64) — the one
    source for the device and host loops alike."""
    return torch.get_default_dtype()


def _resolve_loop(loop: str, ex) -> str:
    if loop not in _LOOPS:
        raise ValueError(f"loop must be one of {_LOOPS}, got {loop!r}")
    has_device = callable(getattr(ex, "device_matvec", None))
    if loop == "auto":
        return "while" if has_device else "host"
    if loop in ("while", "python") and not has_device:
        raise ValueError(
            f"loop={loop!r} needs a device-resident matvec "
            f"({type(ex).__name__} does not expose device_matvec) — use "
            f"loop='host'"
        )
    return loop


def _require_square(ex, solver: str) -> int:
    if ex.n_rows != ex.n_cols:
        raise ValueError(
            f"{solver} requires a square operator, got "
            f"{ex.n_rows}x{ex.n_cols}"
        )
    return int(ex.n_rows)


def _vector(v, dtype: torch.dtype, device) -> torch.Tensor:
    """A right-hand side or start vector as a fresh tensor on `device`."""
    if torch.is_tensor(v):
        return v.to(device=device, dtype=dtype).clone()
    return torch.as_tensor(np.asarray(v), dtype=dtype, device=device).clone()


def _scalar(value, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.tensor(value, dtype=dtype, device=device)


# --------------------------------------------------------------------------
# The guarded step and the loops
#
# A solver's state is a dict of tensors that its `update` advances. With
# ``active=None`` (the python loop) the new values replace the old; with an
# ``active`` flag (the while loop) they replace them only where active. The
# trace is written in place at ``k``; a guarded step past convergence writes
# into the spare slot at ``maxiter``. Every write is an in-place copy into
# the state's own buffers, which a captured graph therefore keeps advancing.


def _commit(state: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor],
            active: Optional[torch.Tensor], maxiter: int) -> None:
    trace_val = new.pop("trace")
    k = state["k"]
    slot = k if active is None else torch.where(active, k, maxiter)
    state["tr"].index_put_((slot.view(1),), trace_val.reshape(1))
    new["k"] = k + 1
    for name, value in new.items():
        buf = state[name]
        buf.copy_(value if active is None else torch.where(active, value, buf))


def _cond(state, metric: str, tol: str, maxiter: int) -> torch.Tensor:
    return (state["k"] < maxiter) & (state[metric] > state[tol])


def _probe(state, metric: str, tol: str) -> Tuple[int, float, float]:
    """``(k, metric, tol)`` of the state in one host read (float32 and the
    int64 count convert to float64 exactly, so ``metric > tol`` and ``k <
    maxiter`` decide on the host as they do on the device)."""
    k, m, t = torch.stack([state[n].to(torch.float64)
                           for n in ("k", metric, tol)]).tolist()
    return int(k), m, t


def _next_block(k: int, m: float, t: float, maxiter: int,
                last: Optional[Tuple[int, float]]) -> int:
    """How many guarded steps the next block of the ``while`` loop runs: the
    longest of `WHILE_BLOCKS` that the steps still needed can fill. The
    steps needed are never more than ``maxiter - k``; where the metric fell
    over the last block (``last`` = its k and metric at that block's
    start), they are estimated from its geometric rate of decrease. Without
    a rate (the first block, or a metric that did not fall) the middle
    block runs. A step past convergence changes nothing but costs a matvec,
    so a short block near the end keeps matvecs close to iterations."""
    need = maxiter - k
    if last is not None and last[0] < k and math.isfinite(last[1]) \
            and 0.0 < m < last[1] and t > 0.0:
        rate = math.log(m / last[1]) / (k - last[0])
        need = min(need, max(1, math.ceil(math.log(t / m) / rate)))
    else:
        need = min(need, WHILE_BLOCKS[1])
    return max(b for b in WHILE_BLOCKS if b <= max(need, 1))


def _drive(ex, key, state, *, metric: str, tol: str, update, maxiter: int,
           mode: str) -> Tuple[Dict[str, torch.Tensor], int]:
    """Run the loop; returns the final state and the steps (matvecs) run."""

    def cond(s):
        return _cond(s, metric, tol, maxiter)

    def step(s, active):
        _commit(s, update(s), active, maxiter)

    steps = 0
    if mode == "python":
        while bool(cond(state)):
            step(state, None)
            steps += 1
        return state, steps
    if state["k"].device.type == "cuda":
        graphs, state, steps = _graph_blocks(ex, key, state, cond=cond,
                                             step=step)
    else:
        graphs = None
    last = None
    k, m, t = _probe(state, metric, tol)
    while k < maxiter and m > t:
        n = _next_block(k, m, t, maxiter, last)
        if graphs is None:
            for _ in range(n):
                step(state, cond(state))
        else:
            graphs.run(n)
        steps += n
        last = (k, m)
        k, m, t = _probe(state, metric, tol)
    return state, steps


class _GraphBlocks:
    """The guarded-step blocks of one solver key on the card: a block of
    ``n`` steps is captured into its own CUDA graph the first time it is
    needed (the launches it holds recorded) and replayed after that. A
    capture that fails raises."""

    def __init__(self, key, static, cond, step):
        self.key, self.static = key, static
        self._cond, self._step = cond, step
        self._graphs: Dict[int, tuple] = {}

    def run(self, n: int) -> None:
        from repro_torch.kernels.ops import CapturedLaunches

        entry = self._graphs.get(n)
        if entry is None:
            graph = torch.cuda.CUDAGraph()
            try:
                with CapturedLaunches() as launches, torch.cuda.graph(graph):
                    for _ in range(n):
                        self._step(self.static, self._cond(self.static))
            except Exception as exc:
                raise RuntimeError(
                    f"loop='while' could not capture the {self.key[0]} step "
                    f"into a CUDA graph ({exc}); loop='python' runs it "
                    f"uncaptured"
                ) from exc
            entry = self._graphs[n] = (graph, launches)
        graph, launches = entry
        graph.replay()
        launches.replayed()


def _graph_blocks(ex, key, state, *, cond, step):
    """The ``while`` loop's graphs for `key`, cached on the executor like
    the JAX package's jitted runners. The first solve of a key runs one
    guarded step eagerly (the kernels' first launch, outside any graph) and
    its state becomes the graphs' buffers; later solves copy their starting
    state into those buffers. Returns (graphs, the state to read, steps
    run)."""
    cache = ex.__dict__.setdefault("_solver_graphs", {})
    graphs = cache.get(key)
    if graphs is not None:
        for name, value in state.items():
            graphs.static[name].copy_(value)
        return graphs, graphs.static, 0
    if not bool(cond(state)):
        return None, state, 0
    step(state, cond(state))
    cache[key] = graphs = _GraphBlocks(key, state, cond, step)
    return graphs, state, 1


def _trace_out(tr: torch.Tensor, iterations: int,
               want: bool) -> Optional[np.ndarray]:
    if not want:
        return None
    return tr[:iterations].cpu().numpy()


def _host(y) -> np.ndarray:
    """An executor's matvec result as a host array."""
    return y.cpu().numpy() if torch.is_tensor(y) else np.asarray(y)


class _BuildCounter:
    """Delta of the global schedule-build counter across a solve."""

    def __enter__(self):
        self._before = schedule_cache_stats()["built"]
        return self

    def __exit__(self, *exc):
        self.builds = schedule_cache_stats()["built"] - self._before
        return False


# --------------------------------------------------------------------------
# Conjugate gradient


def cg(
    A,
    b,
    *,
    tol: float = 1e-6,
    maxiter: Optional[int] = None,
    x0=None,
    trace: bool = False,
    loop: str = "auto",
    backend: str = "auto",
    **engine_kw,
) -> SolveResult:
    """Conjugate gradient for SPD ``A`` (not verified — caller's contract;
    `core.matrices.make_spd` / `core.matrices.spd` produce valid inputs).
    Converges when ||r||_2 <= tol * ||b||_2, capped at ``maxiter``
    (default n) iterations."""
    with _BuildCounter() as bc:
        ex = _resolve_operator(A, backend=backend, engine_kw=engine_kw)
        n = _require_square(ex, "cg")
        mode = _resolve_loop(loop, ex)
        mi = n if maxiter is None else int(maxiter)
        if mode == "host":
            res = _cg_host(ex, b, tol=tol, maxiter=mi, x0=x0, trace=trace)
        else:
            res = _cg_device(
                ex, b, tol=tol, maxiter=mi, x0=x0, trace=trace, mode=mode
            )
    res.schedule_builds = bc.builds
    return res


def _cg_device(ex, b, *, tol, maxiter, x0, trace, mode) -> SolveResult:
    mv = ex.device_matvec()
    dev, dtype = ex.device, _default_dtype()
    b = _vector(b, dtype, dev)
    x = torch.zeros_like(b) if x0 is None else _vector(x0, dtype, dev)
    bb = torch.dot(b, b)
    r = b - mv(x)
    rr = torch.dot(r, r)
    state = {
        "x": x, "r": r, "p": r.clone(), "rr": rr,
        "k": torch.zeros((), dtype=torch.int64, device=dev),
        "tol2": _scalar(tol, dtype, dev) ** 2 * bb,
        "tr": torch.zeros(maxiter + 1, dtype=dtype, device=dev),
    }

    def update(s):
        Ap = mv(s["p"])
        alpha = s["rr"] / torch.dot(s["p"], Ap)
        x = s["x"] + alpha * s["p"]
        r = s["r"] - alpha * Ap
        rr_new = torch.dot(r, r)
        p = r + (rr_new / s["rr"]) * s["p"]
        return {"x": x, "r": r, "p": p, "rr": rr_new,
                "trace": torch.sqrt(rr_new)}

    s, steps = _drive(
        ex, ("cg", maxiter, str(dtype)), state,
        metric="rr", tol="tol2", update=update,
        maxiter=maxiter, mode=mode,
    )
    iters = int(s["k"])
    bb_f, rr_f = float(bb), float(s["rr"])
    resid = math.sqrt(rr_f) / math.sqrt(bb_f) if bb_f > 0 else 0.0
    return SolveResult(
        x=s["x"].clone(),
        iterations=iters,
        residual=resid,
        converged=bool(rr_f <= float(s["tol2"])),
        solver="cg",
        loop=mode,
        schedule_builds=0,
        residual_trace=_trace_out(s["tr"], iters, trace),
        matvecs=1 + steps,
    )


def _host_matvec_and_dot(ex) -> Callable[[np.ndarray], Tuple[np.ndarray, float]]:
    """p -> (A@p as host array, <p, A@p>)."""
    if getattr(ex, "matvec_parts", None) is not None:
        raise NotImplementedError(
            f"{type(ex).__name__} is a sharded operator; the sharded engine "
            f"is not ported yet (ROADMAP A10)"
        )

    def mv_dot(p: np.ndarray):
        Ap = _host(ex.matvec(p))
        return Ap, float(np.dot(p, Ap))

    return mv_dot


def _cg_host(ex, b, *, tol, maxiter, x0, trace) -> SolveResult:
    b = np.asarray(b)
    x = np.zeros_like(b) if x0 is None else np.asarray(x0, b.dtype)
    mv_dot = _host_matvec_and_dot(ex)
    bb = float(np.dot(b, b))
    r = b - _host(ex.matvec(x))
    p = r.copy()
    rr = float(np.dot(r, r))
    tol2 = tol * tol * bb
    tr: List[float] = []
    k = 0
    while k < maxiter and rr > tol2:
        Ap, pAp = mv_dot(p)
        alpha = rr / pAp
        x = x + alpha * p
        r = r - alpha * Ap
        rr_new = float(np.dot(r, r))
        p = r + (rr_new / rr) * p
        rr = rr_new
        tr.append(math.sqrt(rr))
        k += 1
    resid = math.sqrt(rr) / math.sqrt(bb) if bb > 0 else 0.0
    return SolveResult(
        x=x,
        iterations=k,
        residual=resid,
        converged=rr <= tol2,
        solver="cg",
        loop="host",
        schedule_builds=0,
        residual_trace=np.asarray(tr, b.dtype) if trace else None,
        matvecs=1 + k,
    )


# --------------------------------------------------------------------------
# Jacobi


def _diag_of(A_or_ex) -> np.ndarray:
    """Main diagonal as a host array, from CSR, SELL, or an executor that
    carries its SELL (`SpMVEngine.sell`)."""
    obj = A_or_ex
    if not isinstance(obj, (CSRMatrix, SELLMatrix)):
        obj = getattr(obj, "sell", None)
        if obj is None:
            raise TypeError(
                f"cannot extract a diagonal from {type(A_or_ex).__name__}; "
                f"pass diag= explicitly"
            )
    if isinstance(obj, CSRMatrix):
        n = obj.n_rows
        row_of = np.repeat(np.arange(n), np.diff(obj.indptr))
        on_diag = obj.indices == row_of
        d = np.zeros(n, dtype=np.float64)
        np.add.at(d, row_of[on_diag], obj.data[on_diag])
        return d
    sell = obj
    H = sell.slice_height
    d = np.zeros(sell.n_slices * H, dtype=np.float64)
    for s in range(sell.n_slices):
        ci, va = sell.slice_arrays(s)
        rows = s * H + np.arange(ci.shape[1])
        d[rows] = (va * (ci == rows[None, :])).sum(axis=0)
    return d[: sell.n_rows]


def jacobi(
    A,
    b,
    *,
    tol: float = 1e-6,
    maxiter: int = 1000,
    omega: float = 1.0,
    diag=None,
    x0=None,
    trace: bool = False,
    loop: str = "auto",
    backend: str = "auto",
    **engine_kw,
) -> SolveResult:
    """(Weighted) Jacobi: x += omega * D^-1 (b - A x). Converges for
    strictly diagonally dominant A (`core.matrices.spd`). The residual in
    the trace/result is that of the iterate *entering* each step."""
    with _BuildCounter() as bc:
        ex = _resolve_operator(A, backend=backend, engine_kw=engine_kw)
        n = _require_square(ex, "jacobi")
        mode = _resolve_loop(loop, ex)
        d = _diag_of(A) if diag is None else np.asarray(diag, np.float64)
        if d.shape != (n,):
            raise ValueError(f"diag must have shape ({n},), got {d.shape}")
        if (d == 0).any():
            raise ValueError("jacobi needs a nowhere-zero diagonal")
        inv_d = omega / d
        if mode == "host":
            res = _jacobi_host(
                ex, b, inv_d=inv_d, tol=tol, maxiter=int(maxiter), x0=x0,
                trace=trace,
            )
        else:
            res = _jacobi_device(
                ex, b, inv_d=inv_d, tol=tol, maxiter=int(maxiter), x0=x0,
                trace=trace, mode=mode,
            )
    res.schedule_builds = bc.builds
    return res


def _jacobi_device(ex, b, *, inv_d, tol, maxiter, x0, trace,
                   mode) -> SolveResult:
    mv = ex.device_matvec()
    dev, dtype = ex.device, _default_dtype()
    b = _vector(b, dtype, dev)
    x = torch.zeros_like(b) if x0 is None else _vector(x0, dtype, dev)
    bb = torch.dot(b, b)
    # b and inv_d ride in the state: a replayed graph must solve this call's
    # system, not the one it was captured with.
    state = {
        "x": x, "b": b, "rr": _scalar(math.inf, dtype, dev),
        "k": torch.zeros((), dtype=torch.int64, device=dev),
        "inv_d": _vector(inv_d, dtype, dev),
        "tol2": _scalar(tol, dtype, dev) ** 2 * bb,
        "tr": torch.zeros(maxiter + 1, dtype=dtype, device=dev),
    }

    def update(s):
        r = s["b"] - mv(s["x"])
        rr = torch.dot(r, r)
        x = s["x"] + s["inv_d"] * r
        return {"x": x, "rr": rr, "trace": torch.sqrt(rr)}

    s, steps = _drive(
        ex, ("jacobi", maxiter, str(dtype)), state,
        metric="rr", tol="tol2", update=update,
        maxiter=maxiter, mode=mode,
    )
    iters = int(s["k"])
    bb_f, rr = float(bb), float(s["rr"])
    rr_f = rr if np.isfinite(rr) else float("inf")
    resid = math.sqrt(rr_f) / math.sqrt(bb_f) if bb_f > 0 else 0.0
    return SolveResult(
        x=s["x"].clone(),
        iterations=iters,
        residual=resid,
        converged=bool(rr <= float(s["tol2"])),
        solver="jacobi",
        loop=mode,
        schedule_builds=0,
        residual_trace=_trace_out(s["tr"], iters, trace),
        matvecs=steps,
    )


def _jacobi_host(ex, b, *, inv_d, tol, maxiter, x0, trace) -> SolveResult:
    b = np.asarray(b)
    x = np.zeros_like(b) if x0 is None else np.asarray(x0, b.dtype)
    inv_d = np.asarray(inv_d, b.dtype)
    bb = float(np.dot(b, b))
    tol2 = tol * tol * bb
    rr = float("inf")
    tr: List[float] = []
    k = 0
    while k < maxiter and rr > tol2:
        r = b - _host(ex.matvec(x))
        rr = float(np.dot(r, r))
        x = x + inv_d * r
        tr.append(math.sqrt(rr))
        k += 1
    resid = math.sqrt(rr) / math.sqrt(bb) if bb > 0 else 0.0
    return SolveResult(
        x=x,
        iterations=k,
        residual=resid,
        converged=rr <= tol2,
        solver="jacobi",
        loop="host",
        schedule_builds=0,
        residual_trace=np.asarray(tr, b.dtype) if trace else None,
        matvecs=k,
    )


# --------------------------------------------------------------------------
# PageRank


def transition_matrix(adj: CSRMatrix) -> CSRMatrix:
    """Column-stochastic PageRank operator M = P^T from a (square) adjacency
    matrix: M[j, i] = 1/outdeg(i) for each stored edge i -> j (stored-entry
    multiplicity counts; values are ignored). Columns of dangling nodes
    (outdeg 0) are all zero; the iteration's mass-conservation correction
    redistributes their rank uniformly."""
    if adj.n_rows != adj.n_cols:
        raise ValueError(
            f"transition_matrix needs a square adjacency, got "
            f"{adj.n_rows}x{adj.n_cols}"
        )
    n = adj.n_rows
    outdeg = np.diff(adj.indptr)
    row_of = np.repeat(np.arange(n), outdeg)
    vals = 1.0 / outdeg[row_of]
    return coo_to_csr(
        n, n, adj.indices.astype(np.int64), row_of.astype(np.int64), vals
    )


def pagerank(
    A,
    *,
    damping: float = 0.85,
    tol: float = 1e-8,
    maxiter: int = 200,
    x0=None,
    trace: bool = False,
    loop: str = "auto",
    backend: str = "auto",
    **engine_kw,
) -> SolveResult:
    """PageRank by power iteration on the transition operator. ``A`` is
    either an adjacency `CSRMatrix` (the transition matrix is built here)
    or an executor already wrapping `transition_matrix(adj)`. Each step is
    y = damping * M x; y += (1 - sum(y)) / n, so sum(x) stays 1 and the
    SpMV is the whole iteration. Converges when the L1 iterate delta drops
    below ``tol``."""
    with _BuildCounter() as bc:
        if isinstance(A, CSRMatrix):
            ex = get_engine(
                transition_matrix(A), backend=backend, **engine_kw
            )
        elif isinstance(A, SELLMatrix):
            raise TypeError(
                "pagerank needs the CSR adjacency (to build the transition "
                "matrix) or a prebuilt executor over transition_matrix(adj)"
            )
        else:
            ex = _resolve_operator(A, backend=backend, engine_kw=engine_kw)
        n = _require_square(ex, "pagerank")
        mode = _resolve_loop(loop, ex)
        if mode == "host":
            res = _pagerank_host(
                ex, n, damping=damping, tol=tol, maxiter=int(maxiter),
                x0=x0, trace=trace,
            )
        else:
            res = _pagerank_device(
                ex, n, damping=damping, tol=tol, maxiter=int(maxiter),
                x0=x0, trace=trace, mode=mode,
            )
    res.schedule_builds = bc.builds
    return res


def _pagerank_device(ex, n, *, damping, tol, maxiter, x0, trace,
                     mode) -> SolveResult:
    mv = ex.device_matvec()
    dev, dtype = ex.device, _default_dtype()
    x = (torch.full((n,), 1.0 / n, dtype=dtype, device=dev) if x0 is None
         else _vector(x0, dtype, dev))
    state = {
        "x": x, "delta": _scalar(math.inf, dtype, dev),
        "k": torch.zeros((), dtype=torch.int64, device=dev),
        "damp": _scalar(damping, dtype, dev),
        "tolc": _scalar(tol, dtype, dev),
        "tr": torch.zeros(maxiter + 1, dtype=dtype, device=dev),
    }

    def update(s):
        y = s["damp"] * mv(s["x"])
        y = y + (1.0 - torch.sum(y)) / n
        delta = torch.sum(torch.abs(y - s["x"]))
        return {"x": y, "delta": delta, "trace": delta}

    s, steps = _drive(
        ex, ("pagerank", maxiter, str(dtype)), state,
        metric="delta", tol="tolc", update=update,
        maxiter=maxiter, mode=mode,
    )
    iters = int(s["k"])
    delta_f = float(s["delta"])
    return SolveResult(
        x=s["x"].clone(),
        iterations=iters,
        residual=delta_f if np.isfinite(delta_f) else float("inf"),
        converged=bool(delta_f <= tol),
        solver="pagerank",
        loop=mode,
        schedule_builds=0,
        residual_trace=_trace_out(s["tr"], iters, trace),
        matvecs=steps,
    )


def _pagerank_host(ex, n, *, damping, tol, maxiter, x0, trace) -> SolveResult:
    dtype = torch.empty(0, dtype=_default_dtype()).numpy().dtype
    x = (np.full((n,), 1.0 / n, dtype) if x0 is None
         else np.asarray(x0, dtype))
    delta = float("inf")
    tr: List[float] = []
    k = 0
    while k < maxiter and delta > tol:
        y = damping * _host(ex.matvec(x))
        y = y + (1.0 - y.sum()) / n
        delta = float(np.abs(y - x).sum())
        x = y
        tr.append(delta)
        k += 1
    return SolveResult(
        x=x,
        iterations=k,
        residual=delta,
        converged=delta <= tol,
        solver="pagerank",
        loop="host",
        schedule_builds=0,
        residual_trace=np.asarray(tr, dtype) if trace else None,
        matvecs=k,
    )


# --------------------------------------------------------------------------
# Power iteration (dominant eigenpair)


def power_iteration(
    A,
    *,
    tol: float = 1e-6,
    maxiter: int = 200,
    x0=None,
    trace: bool = False,
    loop: str = "auto",
    backend: str = "auto",
    **engine_kw,
) -> SolveResult:
    """Dominant eigenpair by power iteration. Convergence metric is the
    relative eigen-residual ||A x - lam x|| / |lam| with lam the Rayleigh
    quotient; `SolveResult.eigenvalue` carries lam. Deterministic default
    start (normalized ones); pass ``x0`` if that is orthogonal to the
    dominant eigenvector."""
    with _BuildCounter() as bc:
        ex = _resolve_operator(A, backend=backend, engine_kw=engine_kw)
        n = _require_square(ex, "power_iteration")
        mode = _resolve_loop(loop, ex)
        if mode == "host":
            res = _power_host(
                ex, n, tol=tol, maxiter=int(maxiter), x0=x0, trace=trace
            )
        else:
            res = _power_device(
                ex, n, tol=tol, maxiter=int(maxiter), x0=x0, trace=trace,
                mode=mode,
            )
    res.schedule_builds = bc.builds
    return res


def _power_device(ex, n, *, tol, maxiter, x0, trace, mode) -> SolveResult:
    mv = ex.device_matvec()
    dev, dtype = ex.device, _default_dtype()
    x = (torch.full((n,), 1.0 / math.sqrt(n), dtype=dtype, device=dev)
         if x0 is None else _vector(x0, dtype, dev))
    x = x / torch.sqrt(torch.dot(x, x))
    state = {
        "x": x, "lam": _scalar(0.0, dtype, dev),
        "delta": _scalar(math.inf, dtype, dev),
        "k": torch.zeros((), dtype=torch.int64, device=dev),
        "tolc": _scalar(tol, dtype, dev),
        "tr": torch.zeros(maxiter + 1, dtype=dtype, device=dev),
    }

    def update(s):
        y = mv(s["x"])
        lam = torch.dot(s["x"], y)  # Rayleigh quotient (x is unit-norm)
        resid = y - lam * s["x"]
        delta = torch.sqrt(torch.dot(resid, resid)) / torch.abs(lam)
        x = y / torch.sqrt(torch.dot(y, y))
        return {"x": x, "lam": lam, "delta": delta, "trace": delta}

    s, steps = _drive(
        ex, ("power", maxiter, str(dtype)), state,
        metric="delta", tol="tolc", update=update,
        maxiter=maxiter, mode=mode,
    )
    iters = int(s["k"])
    delta_f = float(s["delta"])
    return SolveResult(
        x=s["x"].clone(),
        iterations=iters,
        residual=delta_f,
        converged=bool(delta_f <= tol),
        solver="power_iteration",
        loop=mode,
        schedule_builds=0,
        residual_trace=_trace_out(s["tr"], iters, trace),
        eigenvalue=float(s["lam"]),
        matvecs=steps,
    )


def _power_host(ex, n, *, tol, maxiter, x0, trace) -> SolveResult:
    dtype = torch.empty(0, dtype=_default_dtype()).numpy().dtype
    x = (np.full((n,), 1.0 / math.sqrt(n), dtype) if x0 is None
         else np.asarray(x0, dtype))
    x = x / np.sqrt(np.dot(x, x))
    lam = 0.0
    delta = float("inf")
    tr: List[float] = []
    k = 0
    while k < maxiter and delta > tol:
        y = _host(ex.matvec(x))
        lam = float(np.dot(x, y))
        resid = y - lam * x
        delta = float(np.sqrt(np.dot(resid, resid)) / abs(lam))
        x = y / np.sqrt(np.dot(y, y))
        tr.append(delta)
        k += 1
    return SolveResult(
        x=x,
        iterations=k,
        residual=delta,
        converged=delta <= tol,
        solver="power_iteration",
        loop="host",
        schedule_builds=0,
        residual_trace=np.asarray(tr, dtype) if trace else None,
        eigenvalue=lam,
        matvecs=k,
    )
