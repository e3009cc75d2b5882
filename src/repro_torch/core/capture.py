"""A step function over static buffers captured as one CUDA graph: what the
port has for `repro`'s ``jax.jit`` of a step (`generate`'s one-token step,
`train`'s update).

The recipe of PyTorch's whole-network capture: the step runs once eagerly
on a side stream (`on_side_stream`, the warm-up: allocations, cuBLAS
handles, autograd's first pass), then `CapturedStep` captures it there once
and each call replays the graph. The step reads and writes only tensors
that live across calls, so a replay reads what the caller copied into them.
`HostReads` finds, on any device, the ops of a step that a capture refuses.
"""
from __future__ import annotations

from typing import Callable, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode


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
    (...)")``: there is no eager fallback.

    With `process_group` (a step of DTensors on an NCCL mesh) the capture
    restricts only this thread (``capture_error_mode="thread_local"``):
    ProcessGroupNCCL's watchdog thread goes on querying the events of the
    warm-up's collectives while the capture runs, and in the default
    global mode CUDA may refuse such a call from any thread during a
    capture, failing a capture that does not hold it. Every communicator
    the step uses was created by its warm-up (NCCL makes them at a group's
    first collective), so the capture only records collectives."""

    def __init__(self, step: Callable, stream: torch.cuda.Stream,
                 failure: str, *, process_group: bool = False):
        from repro_torch.kernels.ops import CapturedLaunches

        self.graph = torch.cuda.CUDAGraph()
        mode = "thread_local" if process_group else "global"
        try:
            with CapturedLaunches() as launches, \
                    torch.cuda.graph(self.graph, stream=stream,
                                     capture_error_mode=mode):
                self.outputs = step()
        except Exception as exc:
            raise RuntimeError(f"{failure} into a CUDA graph ({exc})") \
                from exc
        self.launches = launches

    def __call__(self):
        self.graph.replay()
        self.launches.replayed()
        return self.outputs


class HostReads(TorchDispatchMode):
    """The ops of a step, run inside ``with HostReads() as reads:``, that a
    CUDA graph cannot hold because the host waits on the device: a read of
    a value (``aten._local_scalar_dense``: ``.item()``, ``float()``,
    ``bool()``), a result whose shape depends on the data (``aten.nonzero``)
    and a copy from the host to the card (``torch.tensor`` of a Python
    value on the card, a CPU tensor copied in). ``reads.ops`` lists their
    names in order. On DTensors it sees the local ops DTensor runs (it
    hands each DTensor op back to DTensor first), so it runs on a gloo
    grid on the CPU as on the card."""

    READS = ("aten._local_scalar_dense", "aten.nonzero")

    def __init__(self):
        super().__init__()
        self.ops: List[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from repro_torch.sharding.dtensor import _dtensor_cls

        kwargs = kwargs or {}
        if any(issubclass(t, _dtensor_cls()) for t in types):
            return NotImplemented
        name = str(func.overloadpacket._qualified_op_name).replace("::", ".")
        if name in self.READS or _host_to_card(func, args, kwargs):
            self.ops.append(name)
        return func(*args, **kwargs)


def _host_to_card(func, args, kwargs) -> bool:
    """Whether `func` copies a CPU tensor onto a card."""
    aten = torch.ops.aten
    if func.overloadpacket is aten.copy_:
        dst, src = args[0], args[1]
        return src.device.type == "cpu" and dst.device.type != "cpu"
    if func.overloadpacket is aten._to_copy:
        dev = kwargs.get("device")
        return args[0].device.type == "cpu" and dev is not None \
            and torch.device(dev).type != "cpu"
    return False
