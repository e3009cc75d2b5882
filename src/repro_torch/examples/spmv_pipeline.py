"""SpMV pipeline example: the paper's Fig. 5 experiment as a library user —
iterative SpMV (power iteration) over the coalesced data path, with the
perf model reporting what each adapter variant would cost on the VPC (port
of ``examples/spmv_pipeline.py``).

The solver plans once through `SpMVEngine` (schedule construction happens
before the loop) and then only executes: every iteration reuses the cached
coalescer schedule, which is the engine's whole point for iterative and
multi-RHS workloads. On the card each matvec launches the `sell_spmv`
kernel.

Run: PYTHONPATH=src python -m repro_torch.examples.spmv_pipeline
         [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.engine import get_engine
from repro_torch.core.formats import csr_to_sell
from repro_torch.core.matrices import banded, powerlaw
from repro_torch.core.runtime import resolve_device


def power_iteration(engine, n_iters: int = 20):
    n_cols = engine.sell.n_cols
    x = torch.ones((n_cols,), dtype=torch.float32,
                   device=engine.device) / np.sqrt(n_cols)
    for _ in range(n_iters):
        y = engine.matvec(x)
        y = y[:n_cols] if y.shape[0] >= n_cols else torch.nn.functional.pad(
            y, (0, n_cols - y.shape[0]))
        norm = torch.linalg.norm(y)
        x = y / torch.clamp(norm, min=1e-30)
    return float(norm)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Runs the example; returns each matrix's SELL form and the |A x|/|x|
    its power iteration reached, by name."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.spmv_pipeline")
    ap.add_argument("--device", type=str, default="cuda",
                    choices=["cuda", "cpu"])
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)
    results = {}
    for name, gen in (
        ("banded-8k", banded(8192, 16, 0.7)),
        ("powerlaw-8k", powerlaw(8192, 12)),
    ):
        csr = gen(rng)
        sell = csr_to_sell(csr)
        # backend="auto" serves through the sell_spmv kernel on the card and
        # the reference executor on the CPU; the plan (and its persistent
        # cache — set $REPRO_SCHEDULE_CACHE) is shaped for whichever runs.
        engine = get_engine(sell, block_rows=8, backend="auto", device=dev)
        lam = power_iteration(engine, n_iters=10)
        results[name] = dict(sell=sell, lam=lam)
        rep = engine.plan_report()
        print(
            f"{name}: nnz={csr.nnz}  |A x|/|x| -> {lam:.3f}  "
            f"backend={rep['backend_resolved']}  "
            f"(plan: {rep['wide_accesses']} wide accesses, "
            f"coalesce_rate={rep['coalesce_rate']:.2f}, "
            f"plan_width={rep['plan_width']}, "
            f"schedule_cached={rep['schedule_cached']})"
        )
        for system in ("base", "pack0", "pack256"):
            r = rep["perf"][system]
            print(
                f"    {system:8s} modeled {r['runtime_ms']:7.3f} ms/SpMV  "
                f"util={r['mem_utilization']:5.1%}  "
                f"traffic={r['traffic_ratio']:4.2f}x ideal"
            )
    return results


if __name__ == "__main__":
    main()
