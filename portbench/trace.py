"""The device trace of a window: torch.profiler over the window's first
seconds, reduced to what the per-layer metrics and the breakdown read.

Busy time is the union of the device's activity intervals (kernels,
copies, sets; the profiler's user-annotation ranges on the device are not
work and are left out); the traced window is the host's clock from the
profiler's start to its stop, after the device has drained. An idle gap
between two device activities is put down to the innermost host event
that spans the gap's middle (the benchmark's own ``portbench.*`` spans, or
the port's and torch's host calls inside them).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import re
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

#: How many of the longest gaps are put down to host events.
GAPS_LABELLED = 256


@dataclasses.dataclass
class Summary:
    busy_s: float
    window_s: float
    kernels: Dict[str, Tuple[int, float]]   # name -> (launches, seconds)
    device_ops: List[Tuple[str, float]]     # the ten longest by name
    idle_gaps: List[Tuple[str, float]]      # the ten largest by host event


def short_name(name: str) -> str:
    """A kernel's name without its argument list and return type."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)",
                                               "{anonymous}")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            return name[:i]
    return name


class Tracer:
    """torch.profiler around part of a window, started and stopped by the
    window loop (`drive.window`)."""

    def __init__(self, device: torch.device):
        self.device = device
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._active = False
        self._t0 = 0.0
        self.window_s = 0.0

    def start(self) -> None:
        self._prof.__enter__()
        self._active = True
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        self.window_s = time.perf_counter() - self._t0
        self._active = False
        self._prof.__exit__(None, None, None)

    def span(self, name: str):
        """A host span, recorded while the profiler runs."""
        if self._active:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def summary(self) -> Summary:
        dev: List[Tuple[int, int, str]] = []
        host: List[Tuple[int, int, str]] = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not e.is_user_annotation():
                    dev.append((e.start_ns(), e.end_ns(), e.name()))
            else:
                host.append((e.start_ns(), e.end_ns(), e.name()))
        return summarize(dev, host, self.window_s)


def summarize(dev: List[Tuple[int, int, str]],
              host: List[Tuple[int, int, str]], window_s: float) -> Summary:
    """Busy time, kernels by name and idle gaps from device and host
    intervals (ns)."""
    kernels: Dict[str, list] = collections.defaultdict(lambda: [0, 0.0])
    for s, e, name in dev:
        k = kernels[short_name(name)]
        k[0] += 1
        k[1] += (e - s) * 1e-9
    busy = 0
    gaps: List[Tuple[int, int]] = []
    cur_s = cur_e = None
    for s, e, _ in sorted(dev):
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    ops = sorted(((n, v[1]) for n, v in kernels.items()),
                 key=lambda t: -t[1])[:10]
    return Summary(
        busy_s=busy * 1e-9, window_s=window_s,
        kernels={n: (v[0], v[1]) for n, v in kernels.items()},
        device_ops=ops, idle_gaps=_label_gaps(gaps, host),
    )


def _label_gaps(gaps: List[Tuple[int, int]],
                host: List[Tuple[int, int, str]]) -> List[Tuple[str, float]]:
    if not gaps:
        return []
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:GAPS_LABELLED]
    starts = np.array([h[0] for h in host], dtype=np.int64)
    ends = np.array([h[1] for h in host], dtype=np.int64)
    names = [h[2] for h in host]
    by_label: Dict[str, float] = collections.defaultdict(float)
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        label = "(no host event)"
        if len(starts):
            cover = np.nonzero((starts <= mid) & (ends >= mid))[0]
            if len(cover):
                label = names[cover[np.argmin(ends[cover] - starts[cover])]]
        by_label[label] += (g1 - g0) * 1e-9
    return sorted(by_label.items(), key=lambda t: -t[1])[:10]


def kernel_seconds(summary: Optional[Summary], pattern: str
                   ) -> Optional[Tuple[int, float]]:
    """(launches, device seconds) of the kernels whose short name matches
    `pattern`, or None where none ran."""
    if summary is None:
        return None
    rx = re.compile(pattern)
    n, secs = 0, 0.0
    for name, (count, s) in summary.kernels.items():
        if rx.search(name):
            n += count
            secs += s
    return (n, secs) if n else None
