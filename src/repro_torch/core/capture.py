"""A step function over static buffers captured as one CUDA graph: what the
port has for `repro`'s ``jax.jit`` of a step (`generate`'s one-token step,
`train`'s update).

The recipe of PyTorch's whole-network capture: the step runs once eagerly
on a side stream (`on_side_stream`, the warm-up: allocations, cuBLAS
handles, autograd's first pass), then `CapturedStep` captures it there once
and each call replays the graph. The step reads and writes only tensors
that live across calls, so a replay reads what the caller copied into them.
"""
from __future__ import annotations

from typing import Callable

import torch


def on_side_stream(side: torch.cuda.Stream, fn: Callable):
    """``fn()`` on `side` after the current stream's work, the current
    stream then waiting for it: the eager warm-up before a capture there."""
    current = torch.cuda.current_stream(side.device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        out = fn()
    current.wait_stream(side)
    return out


class CapturedStep:
    """`step` (a function of no arguments over static buffers) captured as
    one CUDA graph on `stream`, where its warm-up ran. Calling it replays
    the graph and returns what `step` returned during the capture (its
    static outputs); the kernel launches the graph holds are added to the
    wrappers' counts on each replay (`kernels.ops.CapturedLaunches`). A
    capture that fails raises ``RuntimeError(f"{failure} into a CUDA graph
    (...)")``: there is no eager fallback."""

    def __init__(self, step: Callable, stream: torch.cuda.Stream,
                 failure: str):
        from repro_torch.kernels.ops import CapturedLaunches

        self.graph = torch.cuda.CUDAGraph()
        try:
            with CapturedLaunches() as launches, \
                    torch.cuda.graph(self.graph, stream=stream):
                self.outputs = step()
        except Exception as exc:
            raise RuntimeError(f"{failure} into a CUDA graph ({exc})") \
                from exc
        self.launches = launches

    def __call__(self):
        self.graph.replay()
        self.launches.replayed()
        return self.outputs
