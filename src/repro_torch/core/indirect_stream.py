"""Framework-facing coalesced indirect access (port of
`repro.core.indirect_stream`).

`coalesced_gather(table, indices, ...)` is the library's indirect-stream
primitive. Backends, as in `core.gather_engine`:
  * "index":     ``table[indices]`` — the uncoalesced baseline.
  * "coalesced": the schedule executed in torch — bitwise identical output,
                 structurally the coalesced access pattern.
  * "cuda":      the hand-written kernel (`kernels.coalesced_gather`) driven
                 by the same plan (its plain version on a CPU table). It has
                 no gradient: on a table that requires grad while autograd
                 records it raises NotImplementedError on both devices, as
                 `repro`'s "pallas" backend does under ``jax.grad``.
  * "auto":      cuda on a CUDA table, coalesced on a CPU one (so under
                 autograd it raises on the card and differentiates on the
                 CPU).

An eager index stream resolves through the content-addressed
`get_gather_engine` cache (a digest of the ids on the host), so repeat
streams (a decode loop's fixed page table) reuse the cached schedule and
plan. A stream inside a compiled step — a CUDA graph being captured
(``torch.cuda.is_current_stream_capturing()``), or any call inside
`in_step()`, which `launch.serve.generate` wraps its one-token step in on
both devices — is `repro`'s traced stream: `gather_in_step` plans it in
the step, on the table's device, with no digest, no engine and no copy to
the host (`repro`'s ``_gather_in_trace``). So does a call with a prebuilt
`schedule=`, which that path runs on the backend asked for, as `repro`'s
does.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from .coalescer import resolve_schedule, schedule_gather_reference
from .gather_engine import get_gather_engine, resolve_gather_backend

_IN_STEP: contextvars.ContextVar = contextvars.ContextVar("in_step",
                                                          default=False)


@contextlib.contextmanager
def in_step():
    """A context whose gathers plan in the step (`gather_in_step`), as the
    gathers of `repro`'s jitted decode step do: `launch.serve.generate`
    runs its one-token step, eager or captured, inside it."""
    token = _IN_STEP.set(True)
    try:
        yield
    finally:
        _IN_STEP.reset(token)


def _traced(table: torch.Tensor) -> bool:
    return _IN_STEP.get() or (
        table.is_cuda and torch.cuda.is_current_stream_capturing())


def gather_in_step(
    table: torch.Tensor,
    flat: torch.Tensor,
    schedule=None,
    *,
    window: int,
    block_rows: int,
    backend: str,
) -> torch.Tensor:
    """`repro`'s ``_gather_in_trace``: ``table[flat]`` (n, D) with the
    stream planned here, on the table's device, every call: ``index`` is
    ``table[flat]``; ``coalesced`` builds the schedule
    (`coalescer.resolve_schedule`) and runs it (`schedule_gather_reference`);
    ``cuda`` runs `kernels.ops.coalesced_gather` on a schedule built at
    ``max_warps = window``, untrimmed (nothing read back to size it);
    ``auto`` is cuda on a CUDA table, coalesced on a CPU one. No digest, no
    engine, no host copy: a captured step replays it on each new batch of
    ids."""
    flat = flat.to(table.device)
    resolved = resolve_gather_backend(backend, table.device)
    if resolved == "index":
        return table[flat.to(torch.int64)]
    if resolved == "coalesced":
        sched, _ = resolve_schedule(flat, window=window,
                                    block_rows=block_rows, schedule=schedule)
        return schedule_gather_reference(table, sched, n_out=flat.shape[0])
    from repro_torch.kernels import ops as kops

    return kops.coalesced_gather(table, flat, window=window,
                                 block_rows=block_rows, schedule=schedule)


def coalesced_gather(
    table: torch.Tensor,
    indices,
    *,
    window: int = 256,
    block_rows: int = 8,
    backend: str = "coalesced",
    schedule=None,
) -> torch.Tensor:
    """Gather rows of `table` (R, D) at `indices` (...,) -> (..., D) on the
    table's device. An eager stream plans through the engine cache; a
    prebuilt `schedule`, or a stream inside a compiled step (see the module
    docstring), takes `gather_in_step`."""
    indices = torch.as_tensor(indices)
    flat = indices.reshape(-1)
    if schedule is not None or (flat.numel() > 0 and _traced(table)):
        out = gather_in_step(table, flat, schedule, window=window,
                             block_rows=block_rows, backend=backend)
    elif flat.numel() == 0:
        out = table[flat.to(torch.int64).to(table.device)]
    else:
        eng = get_gather_engine(
            tuple(table.shape), flat, window=window, block_rows=block_rows,
            backend=backend, device=table.device,
        )
        out = eng.gather(table)
    return out.reshape(*indices.shape, table.shape[-1])
