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

Every index stream resolves through the content-addressed
`get_gather_engine` cache, so repeat streams (a decode loop's fixed page
table) reuse the cached schedule and plan. The JAX package also has an
in-trace fallback that re-plans a *traced* stream inside a jit; torch runs
eagerly and every stream here is concrete, so the port has no such path. A
prebuilt `schedule=` goes straight to the kernel dispatch
(`kernels.ops.coalesced_gather`), which runs it on the table's device.
"""
from __future__ import annotations

import torch

from .gather_engine import get_gather_engine


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
    table's device."""
    indices = torch.as_tensor(indices)
    flat = indices.reshape(-1)
    if schedule is not None:
        from repro_torch.kernels import ops as kops

        out = kops.coalesced_gather(
            table, flat, window=window, block_rows=block_rows,
            schedule=schedule,
        )
    elif flat.numel() == 0:
        out = table[flat.to(torch.int64).to(table.device)]
    else:
        eng = get_gather_engine(
            tuple(table.shape), flat, window=window, block_rows=block_rows,
            backend=backend, device=table.device,
        )
        out = eng.gather(table)
    return out.reshape(*indices.shape, table.shape[-1])
