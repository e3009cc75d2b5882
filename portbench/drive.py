"""The one traffic loop: what a mix's data file asks for, run closed.

A traffic file (`traffic/<name>.json`) names its ``kind`` (`kinds/<kind>.py`:
the inputs, the warm-up, the call the window times and its check) and
gives, besides the kind's own parameters:

- ``pool``, ``pool_seed``: the window's inputs, one fixed set drawn on the
  device from ``pool_seed``; a run's seed only puts them in another order
  (`order`), cycled through, so every seed does the same work;
- ``inflight`` (default 1): calls on the device at once; before it makes a
  call the host waits on the completion of the call ``inflight`` back;
- ``whole_passes`` (default false): the window runs on past `seconds` to
  the end of a pass over the pool, so that where the pool's inputs differ
  in work (PageRank's starts take 53 to 65 steps) every seed's window
  holds the same work;
- ``sample``: answers of the window kept for the check, drawn from the
  run's seed (a reservoir over the window's answers);
- ``trace_seconds``: how much of a traced window the profiler records.

A call's latency runs from its issue to the host seeing it complete.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import random
import time
from typing import Callable, List

import torch


def mix(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream of the run, from the run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def make_pool(traffic: dict, kind, n: int, device) -> List[torch.Tensor]:
    """The window's inputs on `device`, in one draw from ``pool_seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(traffic["pool_seed"]))
    return kind.pool(traffic, n, gen, device)


def order(traffic: dict, seed: int) -> List[int]:
    """The order the window takes the pool's entries in (cycling),
    shuffled by the run's seed."""
    idx = list(range(int(traffic["pool"])))
    random.Random(mix(seed, "order")).shuffle(idx)
    return idx


@dataclasses.dataclass
class Window:
    """What the window did, from the host's clock and the port's counts."""
    solves: bool                        # the kind's calls are solves
    columns: int                        # right-hand sides a call completes
    seconds: float = 0.0                # first call to the last completion
    attempted: int = 0
    completed: int = 0                  # returned, and converged if a solve
    raised: int = 0
    unconverged: int = 0
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    host_s: List[float] = dataclasses.field(default_factory=list)
    iterations: int = 0
    matvecs: int = 0
    captures: int = 0                   # launches captured inside the window
    # the part of a traced window after the profiler stopped
    untraced_seconds: float = 0.0
    untraced_completed: int = 0
    untraced_iterations: int = 0
    errors: List[str] = dataclasses.field(default_factory=list)
    samples: list = dataclasses.field(default_factory=list)  # (pool i, Answer)

    @property
    def failed(self) -> int:
        return self.attempted - self.completed


class _Reservoir:
    """A uniform sample of `size` of the window's answers, from the seed."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng, self.seen = size, random.Random(seed), 0
        self.items: list = []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.size:
                self.items[j] = item


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(answer: Callable, kind, traffic: dict, pool: List[torch.Tensor],
           seconds: float, seed: int, device, tracer=None) -> Window:
    """Run the mix for `seconds` of the host's clock through `answer(x)`,
    then wait for what was started. With a `tracer`, its first
    ``trace_seconds`` are profiled."""
    dev = torch.device(device)
    win = Window(solves=bool(kind.SOLVES), columns=int(kind.columns(traffic)))
    keep = _Reservoir(int(traffic["sample"]), mix(seed, "sample"))
    depth = int(traffic.get("inflight", 1))
    whole = bool(traffic.get("whole_passes", False))
    span = tracer.span if tracer is not None else contextlib.nullcontext
    pending = collections.deque()  # (issued at, completion event, Answer)

    def finish() -> None:
        issued, done, ans = pending.popleft()
        if done is not None:
            with span("portbench.wait"):
                done.synchronize()
        win.latencies_s.append(time.perf_counter() - issued)
        win.iterations += ans.iterations
        win.matvecs += ans.matvecs
        if ans.converged:
            win.completed += 1
        else:
            win.unconverged += 1

    seq = order(traffic, seed)
    if tracer is not None:
        tracer.start()
    t0 = time.perf_counter()
    end = t0 + seconds
    trace_end = t0 + float(traffic["trace_seconds"]) if tracer else None
    untraced_t0, at_stop = t0, (0, 0)
    i = 0
    while True:
        now = time.perf_counter()
        if trace_end is not None and now >= trace_end:
            while pending:
                finish()
            _sync(dev)
            tracer.stop()
            trace_end = None
            untraced_t0 = time.perf_counter()
            at_stop = (win.completed, win.iterations)
        if now >= end and not (whole and i % len(seq)):
            break
        while len(pending) >= depth:
            finish()
        p = seq[i % len(seq)]
        t = time.perf_counter()
        win.attempted += 1
        i += 1
        try:
            with span("portbench.call"):
                ans = answer(pool[p])
        except Exception as exc:  # a failed call is counted, not fatal
            win.raised += 1
            win.errors.append(f"{type(exc).__name__}: {exc}")
            continue
        win.host_s.append(time.perf_counter() - t)
        done = None
        if dev.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))
        pending.append((t, done, ans))
        keep.offer((p, ans))
    while pending:
        finish()
    _sync(dev)
    t_end = time.perf_counter()
    win.seconds = t_end - t0
    if trace_end is not None:  # the window ended before the trace did
        tracer.stop()
        untraced_t0, at_stop = t_end, (win.completed, win.iterations)
    win.untraced_seconds = t_end - untraced_t0
    win.untraced_completed = win.completed - at_stop[0]
    win.untraced_iterations = win.iterations - at_stop[1]
    win.samples = keep.items
    return win
