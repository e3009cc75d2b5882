"""Fault tolerance & elasticity for long-running multi-pod jobs (port of
`repro.train.fault_tolerance`: `HeartbeatMonitor` and `StragglerPolicy` are
`repro`'s code; `run_with_recovery` runs on the port's checkpoint, which
restores into the state's own tensors, re-placed onto `shardings` when
given; `remesh_shardings` places a spec tree on a new process mesh).

What a 1000+-node fleet needs, implemented and unit-tested here (the fleet
control plane is simulated — this container has one host — but every policy
runs against the real checkpoint/data/mesh code paths):

  * HeartbeatMonitor — detects dead/straggling workers from heartbeat age.
  * run_with_recovery — the supervisor loop: on failure, restore the latest
    complete checkpoint and resume at the right data step (pipeline.skip_to),
    possibly on a DIFFERENT device count (elastic re-shard at restore).
  * StragglerPolicy — deadline-based step skipping: if a worker exceeds the
    per-step deadline repeatedly, the supervisor reassigns its data shard
    (deterministic pipeline makes this a pure function of (step, shard)).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

from repro_torch.sharding.rules import to_shardings
from repro_torch.train.checkpoint import AsyncCheckpointer, restore_latest


@dataclasses.dataclass
class WorkerState:
    last_heartbeat: float
    step: int = 0
    alive: bool = True


class HeartbeatMonitor:
    """Tracks worker liveness from heartbeat timestamps (control-plane side)."""

    def __init__(self, timeout_s: float, now: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self.now = now
        self.workers: Dict[str, WorkerState] = {}

    def beat(self, worker: str, step: int) -> None:
        self.workers[worker] = WorkerState(self.now(), step, True)

    def dead_workers(self) -> list:
        t = self.now()
        out = []
        for w, st in self.workers.items():
            if st.alive and t - st.last_heartbeat > self.timeout_s:
                st.alive = False
                out.append(w)
        return out

    def stragglers(self, fleet_step: int, max_lag: int) -> list:
        return [
            w for w, st in self.workers.items()
            if st.alive and fleet_step - st.step > max_lag
        ]


@dataclasses.dataclass
class StragglerPolicy:
    """Deadline-based mitigation: after `patience` consecutive deadline
    misses, drop/reassign the worker's shard for that step (the deterministic
    pipeline lets any worker recompute shard s of step t)."""

    step_deadline_s: float
    patience: int = 2
    _misses: int = 0

    def observe(self, step_seconds: float) -> str:
        """Returns 'ok' | 'warn' | 'reassign'."""
        if step_seconds <= self.step_deadline_s:
            self._misses = 0
            return "ok"
        self._misses += 1
        if self._misses >= self.patience:
            # Re-arm after signalling: the shard was just reassigned, so the
            # next reassignment again requires `patience` consecutive misses
            # (otherwise one slow worker triggers a reassign storm).
            self._misses = 0
            return "reassign"
        return "warn"


def run_with_recovery(
    *,
    init_state: Callable[[], object],
    train_one_step: Callable[[object, int], object],
    total_steps: int,
    ckpt_dir: str,
    ckpt_every: int = 50,
    shardings=None,
    max_restarts: int = 3,
    on_step: Optional[Callable[[int, object], None]] = None,
):
    """Supervisor loop with checkpoint/restart.

    `train_one_step(state, step)` may raise (simulated node failure in
    tests); the loop restores the newest complete checkpoint into the state
    and resumes after its step (from `init_state()` at step 0 when there is
    none). Restore places the state's module tensors on `shardings` ({name:
    `sharding.rules.Sharding`}) — pass shardings built from the CURRENT
    mesh (`remesh_shardings`) to get elastic re-sharding on a changed
    device count."""
    if ckpt_every < 1:
        # Fail fast: `step % ckpt_every` would otherwise ZeroDivisionError
        # only once training reaches the first step — long after launch.
        raise ValueError(f"ckpt_every must be >= 1, got {ckpt_every}")
    ckpt = AsyncCheckpointer(ckpt_dir)
    restarts = 0
    state = init_state()
    start = 0
    restored = restore_latest(ckpt_dir, state, shardings=shardings)
    if restored is not None:
        start, state = restored
        start += 1

    step = start
    while step < total_steps:
        try:
            state = train_one_step(state, step)
            if on_step is not None:
                on_step(step, state)
            if step % ckpt_every == 0 or step == total_steps - 1:
                ckpt.save(step, state)
            step += 1
        except Exception:
            restarts += 1
            if restarts > max_restarts:
                ckpt.wait()
                raise
            ckpt.wait()
            restored = restore_latest(ckpt_dir, state, shardings=shardings)
            if restored is None:
                state = init_state()
                step = 0
            else:
                step, state = restored
                step += 1
    ckpt.wait()
    return state


def remesh_shardings(pspecs, mesh):
    """Shardings for an existing {name: spec} map (`sharding.rules.
    tensor_pspecs`) on a NEW process mesh — the elastic-rescale hook (device
    count changed between runs)."""
    return to_shardings(pspecs, mesh)
