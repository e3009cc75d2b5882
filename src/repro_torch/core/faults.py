"""Deterministic, seedable fault injection for the plan-cache / dispatch stack.

The paper's premise is *decoupling*: near-memory index units run ahead of the
processing elements.  Decoupled pieces must tolerate each other's failures, so
this module provides the chaos side of that contract — a `FaultPlan` that
injects reproducible faults at named sites threaded through the IO and
dispatch boundaries:

``store_read``
    corrupts a cache file (npz schedule / json tune winner) just before it is
    read, exercising the quarantine + rebuild path.
``store_write``
    raises a transient ``OSError`` (ENOSPC / EIO) inside an atomic cache
    write, exercising the bounded-retry path.
``dispatch_timeout``
    raises an ``InjectedTimeout`` at a streaming micro-batch boundary,
    exercising `StreamingExecutor`'s per-micro-batch retry.
``shard_fail``
    raises an ``InjectedShardFailure`` in a sharded dispatch, exercising
    `ShardedSpMVEngine`'s degraded-mode reference recompute.

Spec grammar (also accepted via the ``REPRO_FAULTS`` env var)::

    site:key=val,key=val;site2:key=val
    e.g.  store_read:rate=0.3,seed=7;dispatch_timeout:after=5

Per-site keys:

* ``rate``  — probability in [0, 1] that an event at this site fires
              (deterministic given ``seed``; default 1.0).
* ``after`` — skip the first N events at this site, then start firing.
* ``count`` — fire at most N times total (default: 1 when ``after`` is
              given without ``rate``, else unlimited).
* ``seed``  — per-site RNG seed (default: plan seed, default 0).

Activation is scoped: ``with FaultPlan("shard_fail:count=1"):`` pushes the
plan on a stack consulted by `maybe_inject` / `corrupt_file`; the
``REPRO_FAULTS`` env var installs a process-wide fallback plan.  Recovery
code calls `note_recovered` so `FaultPlan.report()` can prove that every
injected fault was healed (``unrecovered == 0``).
"""

from __future__ import annotations

import dataclasses
import errno
import os
import threading
from typing import Dict, List, Optional

__all__ = [
    "FAULT_SITES",
    "FaultInjected",
    "InjectedCorruption",
    "InjectedIOError",
    "InjectedShardFailure",
    "InjectedTimeout",
    "FaultPlan",
    "SiteSpec",
    "active_plan",
    "corrupt_file",
    "maybe_inject",
    "note_recovered",
    "parse_fault_spec",
    "suspended",
]

FAULT_SITES = ("store_read", "store_write", "dispatch_timeout", "shard_fail")

ENV_VAR = "REPRO_FAULTS"

# Bytes splatted over the head of a cache file by a ``store_read`` corruption.
# Long enough to destroy both the zip magic of an npz and the JSON prologue
# of a tune winner.
_CORRUPTION = b"\x00CHAOS\xff" * 8


class FaultInjected(Exception):
    """Base for all injected faults; carries the site that fired."""

    def __init__(self, site: str, message: str):
        super().__init__(message)
        self.site = site


class InjectedIOError(OSError, FaultInjected):
    """Transient IO error (ENOSPC / EIO) injected into an atomic write."""

    def __init__(self, site: str, message: str, *, err: int = errno.ENOSPC):
        OSError.__init__(self, err, message)
        self.site = site


class InjectedCorruption(FaultInjected):
    """Marker raised only if a corrupted read is *not* healed by the caller."""


class InjectedTimeout(FaultInjected):
    """A micro-batch that exceeded its (simulated) dispatch deadline."""


class InjectedShardFailure(FaultInjected):
    """A shard whose dispatch (simulatedly) died mid-flight."""


_EXC_FOR_SITE = {
    "store_read": InjectedCorruption,
    "store_write": InjectedIOError,
    "dispatch_timeout": InjectedTimeout,
    "shard_fail": InjectedShardFailure,
}


@dataclasses.dataclass(frozen=True)
class SiteSpec:
    """Parsed per-site firing rule."""

    site: str
    rate: float = 1.0
    after: int = 0
    count: Optional[int] = None
    seed: int = 0


def _parse_int(site: str, key: str, raw: str) -> int:
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"fault spec: {site}:{key}={raw!r} is not an int") from None


def parse_fault_spec(spec: str, *, default_seed: int = 0) -> Dict[str, SiteSpec]:
    """Parse ``site:key=val,...;site2:...`` into per-site rules."""

    sites: Dict[str, SiteSpec] = {}
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        site, _, body = clause.partition(":")
        site = site.strip()
        if site not in FAULT_SITES:
            raise ValueError(
                f"fault spec: unknown site {site!r} (expected one of {FAULT_SITES})"
            )
        if site in sites:
            raise ValueError(f"fault spec: duplicate site {site!r}")
        kw = {"rate": 1.0, "after": 0, "count": None, "seed": default_seed}
        saw_rate = False
        for item in filter(None, (s.strip() for s in body.split(","))):
            key, eq, raw = item.partition("=")
            key = key.strip()
            raw = raw.strip()
            if not eq:
                raise ValueError(f"fault spec: expected key=val, got {item!r}")
            if key == "rate":
                try:
                    rate = float(raw)
                except ValueError:
                    raise ValueError(
                        f"fault spec: {site}:rate={raw!r} is not a float"
                    ) from None
                if not 0.0 <= rate <= 1.0:
                    raise ValueError(f"fault spec: {site}:rate must be in [0, 1]")
                kw["rate"] = rate
                saw_rate = True
            elif key in ("after", "count", "seed"):
                kw[key] = _parse_int(site, key, raw)
            else:
                raise ValueError(
                    f"fault spec: unknown key {key!r} for site {site!r} "
                    "(expected rate/after/count/seed)"
                )
        if kw["count"] is None and not saw_rate:
            # "dispatch_timeout:after=5" means *one* deterministic fault, not
            # a permanently failing site that no bounded retry could heal.
            kw["count"] = 1
        sites[site] = SiteSpec(site=site, **kw)
    if not sites:
        raise ValueError("fault spec: empty spec")
    return sites


class _SiteState:
    """Mutable firing state for one site (event counter + RNG + tallies)."""

    def __init__(self, spec: SiteSpec):
        self.spec = spec
        self.events = 0
        self.injected = 0
        self.recovered = 0
        # numpy is already a hard dependency of the stack; a Generator gives
        # us a reproducible per-site stream independent of global state.
        import numpy as np

        self._rng = np.random.default_rng(
            np.random.SeedSequence([spec.seed, hash(spec.site) & 0x7FFFFFFF])
        )

    def fire(self) -> bool:
        idx = self.events
        self.events += 1
        if idx < self.spec.after:
            return False
        if self.spec.count is not None and self.injected >= self.spec.count:
            return False
        if self.spec.rate < 1.0 and float(self._rng.random()) >= self.spec.rate:
            return False
        self.injected += 1
        return True


class FaultPlan:
    """A deterministic set of fault-injection rules, usable as a context
    manager.  Thread-safe; one plan may be shared across pump threads."""

    def __init__(self, spec: str = "", *, seed: int = 0):
        self.spec = spec
        self.seed = seed
        self._sites = {
            site: _SiteState(rule)
            for site, rule in (
                parse_fault_spec(spec, default_seed=seed).items() if spec else ()
            )
        }
        self._lock = threading.Lock()

    # -- firing ------------------------------------------------------------

    def fire(self, site: str) -> bool:
        """Record an event at *site*; True if a fault should be injected."""
        state = self._sites.get(site)
        if state is None:
            return False
        with self._lock:
            return state.fire()

    def note_recovered(self, site: str, n: int = 1) -> None:
        """Recovery code reports that *n* injected faults at *site* healed."""
        state = self._sites.get(site)
        if state is None:
            return
        with self._lock:
            # Clamp: recovery paths also heal *organic* faults (e.g. a cache
            # file that was corrupt for real); only credit injected ones so
            # `unrecovered` can never go negative.
            state.recovered = min(state.injected, state.recovered + n)

    # -- reporting ---------------------------------------------------------

    def report(self) -> Dict[str, object]:
        """Tally of injected vs recovered faults, per site and total."""
        with self._lock:
            sites = {
                name: {
                    "events": st.events,
                    "injected": st.injected,
                    "recovered": st.recovered,
                }
                for name, st in self._sites.items()
            }
        injected = sum(s["injected"] for s in sites.values())
        recovered = sum(s["recovered"] for s in sites.values())
        return {
            "spec": self.spec,
            "sites": sites,
            "injected": injected,
            "recovered": recovered,
            "unrecovered": injected - recovered,
        }

    # -- scoping -----------------------------------------------------------

    def __enter__(self) -> "FaultPlan":
        with _stack_lock:
            _stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        with _stack_lock:
            # Remove the most recent occurrence of *this* plan; tolerate
            # out-of-order exits from nested contexts.
            for i in range(len(_stack) - 1, -1, -1):
                if _stack[i] is self:
                    del _stack[i]
                    break


_stack: List[FaultPlan] = []
_stack_lock = threading.Lock()
_env_plan: Optional[FaultPlan] = None
_env_spec_seen: Optional[str] = None
_suspended = threading.local()


def active_plan() -> Optional[FaultPlan]:
    """The innermost active plan, or the ``REPRO_FAULTS`` env plan, or None.

    Returns None while inside a `suspended()` block on this thread.
    """
    if getattr(_suspended, "depth", 0) > 0:
        return None
    with _stack_lock:
        if _stack:
            return _stack[-1]
    global _env_plan, _env_spec_seen
    spec = os.environ.get(ENV_VAR, "")
    if not spec:
        _env_plan = None
        _env_spec_seen = None
        return None
    if _env_plan is None or _env_spec_seen != spec:
        _env_plan = FaultPlan(spec)
        _env_spec_seen = spec
    return _env_plan


class suspended:
    """Context manager masking fault injection on the current thread.

    Used by chaos drills to compute a fault-free oracle while a plan is
    active, e.g. ``with faults.suspended(): y_expect = eng.matmat(X)``.
    """

    def __enter__(self) -> "suspended":
        _suspended.depth = getattr(_suspended, "depth", 0) + 1
        return self

    def __exit__(self, *exc) -> None:
        _suspended.depth = getattr(_suspended, "depth", 1) - 1


def maybe_inject(site: str, message: str = "") -> None:
    """Raise this site's injected exception if the active plan fires."""
    plan = active_plan()
    if plan is None or not plan.fire(site):
        return
    exc_type = _EXC_FOR_SITE[site]
    msg = message or f"injected fault at {site}"
    if exc_type is InjectedIOError:
        raise InjectedIOError(site, msg)
    raise exc_type(site, msg)


def corrupt_file(path: str, site: str = "store_read") -> bool:
    """If the active plan fires at *site*, deterministically corrupt *path*
    on disk (splat garbage over its head) so the real reader sees a torn
    file and the genuine quarantine + rebuild machinery is exercised.

    Returns True if the file was corrupted.
    """
    plan = active_plan()
    if plan is None or not os.path.exists(path) or not plan.fire(site):
        return False
    with open(path, "r+b") as f:
        f.write(_CORRUPTION)
    return True


def note_recovered(site: str, n: int = 1) -> None:
    """Report recovery of *n* injected faults at *site* to the active plan.

    Recovery accounting ignores `suspended()` masking: the fault fired while
    injection was live, so its healing must be credited to the same plan.
    """
    with _stack_lock:
        plan = _stack[-1] if _stack else None
    if plan is None:
        plan = _env_plan
    if plan is not None:
        plan.note_recovered(site, n)
