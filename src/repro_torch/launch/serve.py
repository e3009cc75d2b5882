"""Batched SpMV serving (port of the ``--spmv`` mode of `repro.launch.serve`).

`python -m repro_torch.launch.serve --spmv banded --spmv-rows 1000000
--batch 64 --requests 8` stands up an `SpMVEngine` for one synthetic matrix
on the card and serves batches of right-hand sides through the cached
coalescer plan (`matmat`, the fused `sell_spmm` kernel), reporting the plan,
the backend, the perf model's matmat prediction, steady-state SpMV/s and
GFLOP/s, and the schedule cache counters. ``--device cpu`` runs on the CPU
(the reference backend under ``--backend auto``).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np

from repro_torch.core import matrices as _matgen

_SPMV_MATRICES = {
    "banded": lambda n: _matgen.banded(n, 24, 0.8),
    "powerlaw": lambda n: _matgen.powerlaw(n, 12),
    "random": lambda n: _matgen.random_uniform(n, 16),
}


def serve_spmv(args) -> Dict[str, object]:
    """Batched SpMV serving: one engine, many right-hand-side batches.
    Prints the report and returns the engine, the first request batch and
    its served result, and the measured rates."""
    from repro_torch.core.engine import get_engine, schedule_cache_stats

    gen = _SPMV_MATRICES[args.spmv](args.spmv_rows)
    csr = gen(np.random.default_rng(args.seed))
    t0 = time.time()
    engine = get_engine(
        csr, backend=args.backend, window=args.window,
        block_rows=args.block_rows, device=args.device,
    )
    # Forces the (lazy) schedule build; k= folds the matmat prediction in.
    rep = engine.plan_report(k=args.batch if args.batch > 1 else None)
    plan_s = time.time() - t0
    print(
        f"spmv-serve: {args.spmv} {rep['n_rows']}x{rep['n_cols']} "
        f"nnz_padded={rep['nnz_padded']} planned in {plan_s:.3f}s "
        f"(schedule_cached={rep['schedule_cached']})"
    )
    print(
        f"  backend: {rep['backend']} -> {rep['backend_resolved']} on "
        f"{rep['device']} (cols_per_chunk={rep['cols_per_chunk']}, "
        f"plan_width={rep['plan_width']}, "
        f"matmat={rep['matmat_mode']}, k_tile={rep['k_tile']})"
    )
    print(
        f"  plan: window={rep['window']} block_rows={rep['block_rows']} "
        f"max_warps={rep['max_warps']} "
        f"wide_accesses={rep['wide_accesses']} "
        f"coalesce_rate={rep['coalesce_rate']:.2f}"
    )
    if args.batch > 1:
        mm = rep["matmat"]
        pred = mm["perf"]["pack256"]
        print(
            f"  matmat: k_tile={mm['k_tile']} mode={mm['mode']} — model "
            f"predicts x{pred['speedup']:.3f} fused vs vmapped at "
            f"k={args.batch} (matrix stream amortized "
            f"x{pred['amortization']:.1f}, crossover k="
            f"{pred['crossover_k']})"
        )
    # Host-side request batches, pregenerated so RHS generation stays out of
    # the timed loop (the host->device transfer is part of serving).
    rng = np.random.default_rng(args.seed + 1)
    batches = [
        rng.standard_normal((csr.n_cols, args.batch)).astype(np.float32)
        for _ in range(args.requests)
    ]
    # warm the path outside the timed loop
    y_first = engine.finalize(engine.matmat(batches[0]))
    t0 = time.time()
    for B in batches:
        engine.finalize(engine.matmat(B))
    dt = time.time() - t0
    spmvs = args.requests * args.batch
    spmv_per_s = spmvs / max(dt, 1e-12)
    gflops = 2.0 * csr.nnz * spmvs / max(dt, 1e-12) / 1e9
    print(
        f"  served {args.requests} batches x {args.batch} RHS in {dt:.3f}s "
        f"sync ({spmv_per_s:.1f} SpMV/s, {gflops:.3f} GFLOP/s equivalent)"
    )
    print(f"  schedule cache: {schedule_cache_stats()}")
    return {
        "engine": engine,
        "csr": csr,
        "batch": batches[0],
        "y": y_first,
        "seconds": dt,
        "spmv_per_s": spmv_per_s,
        "gflops": gflops,
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="serve batched SpMV through the plan-once engine"
    )
    ap.add_argument(
        "--spmv", choices=sorted(_SPMV_MATRICES), required=True,
        help="synthetic matrix family to serve",
    )
    ap.add_argument("--spmv-rows", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--window", type=int, default=None,
        help="coalescer window (default: 256 for the reference backend, "
        "cols_per_chunk*slice_height for cuda)",
    )
    ap.add_argument("--block-rows", type=int, default=8)
    ap.add_argument(
        "--backend", choices=("reference", "cuda", "auto"), default="auto",
        help="execution backend (cuda runs the hand-written kernels; auto "
        "picks cuda on a CUDA device, the reference on the CPU)",
    )
    ap.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the plan and the execution live",
    )
    return ap


def main(argv=None) -> None:
    serve_spmv(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
