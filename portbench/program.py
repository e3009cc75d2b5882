"""The system under test, `repro_torch`, as the benchmark drives it.

It hands the port the matrix the benchmark made, plans one engine
(`get_engine`), and hands that engine to the traffic kind's `call`
(`kinds/<kind>.py`), which calls the entry the window times. It reads the
port's counters: the kernel wrappers' launch counts and the plan's
geometry. Besides `call` in the kinds, the only module of the benchmark
that imports the port.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import solvers
from repro_torch.core.engine import get_engine
from repro_torch.core.formats import CSRMatrix
from repro_torch.kernels import ops


class Port:
    """`repro_torch` on one device. ``value_dtype`` is the engine's value
    storage (None: the right-hand side's float32; "bf16": the port's lower
    precision)."""

    def __init__(self, device, *, value_dtype: Optional[str] = None):
        self.device = torch.device(device)
        self.value_dtype = value_dtype
        self.engine = None

    def plan(self, cfg: dict, n: int, indptr, indices, data) -> None:
        """CSR in hand to a planned engine: the operator the configuration
        names, converted, planned and its values placed on the device."""
        operators = {"matrix": lambda A: A,
                     "transition": solvers.transition_matrix}
        if cfg["operator"] not in operators:
            raise KeyError(f"no operator {cfg['operator']!r} "
                           f"(have {sorted(operators)})")
        A = operators[cfg["operator"]](CSRMatrix(n, n, indptr, indices, data))
        # "cuda" is what "auto" picks on the card; on a CPU engine it runs
        # the kernels' plain versions over the same plan (the tests).
        engine = get_engine(A, device=self.device,
                            value_dtype=self.value_dtype, backend="cuda")
        engine.device_matvec()  # the schedule and the device plan
        engine.plan_values(torch.float32)
        self.engine = engine

    def plan_elements(self) -> int:
        """Elements the kernels walk per pass: the plan's slices x chunks x
        window (every slice padded to the widest)."""
        plan = self.engine.device_plan
        return plan.n_slices * plan.n_chunks * plan.window

    def answer(self, kind, traffic: dict, x: torch.Tensor):
        """One call of the window: the kind's entry over the engine."""
        return kind.call(self.engine, traffic, x)

    @staticmethod
    def captures() -> int:
        """Kernel launches captured into CUDA graphs so far (a capture in
        the window would be compilation inside it)."""
        return sum(w.captured for w in ops.KERNEL_WRAPPERS.values())

    def release(self) -> None:
        """Drop the engine and the port's plan caches."""
        from repro_torch.core.engine import clear_engine_cache, \
            clear_schedule_cache

        self.engine = None
        clear_engine_cache()
        clear_schedule_cache()
