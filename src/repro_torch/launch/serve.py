"""Serving launcher (port of the ``--spmv`` and ``--paged`` modes of
`repro.launch.serve`).

`python -m repro_torch.launch.serve --spmv banded --spmv-rows 1000000
--batch 64 --requests 8` stands up an `SpMVEngine` for one synthetic matrix
on the card and serves batches of right-hand sides through the cached
coalescer plan (`matmat`, the fused `sell_spmm` kernel), reporting the plan,
the backend, the perf model's matmat prediction, steady-state SpMV/s and
GFLOP/s, and the schedule cache counters.

`python -m repro_torch.launch.serve --arch llama3-8b --paged --batch 16
--prompt-len 1024 --decode-steps 16 --page-block 16` serves end-to-end paged
decode at the config's widths (layers, heads, KV heads, head_dim; random
K/V/q from --seed, no weights): per-layer paged KV caches
(`models.paged_kv`) whose page gathers run through the shared
`core.gather_engine` plan cache (the `coalesced_gather` kernel on the card),
with per-layer gather plan reports, tokens/s, a paged-vs-dense parity gate
(1e-5) and a zero-steady-state-plan-builds gate. Generation with the model
stack (``--arch`` without ``--paged``) is not ported yet.

``--device cpu`` runs either mode on the CPU (the reference executors under
``--backend auto``).
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


def serve_paged(args) -> Dict[str, object]:
    """End-to-end paged decode: per-layer paged KV caches, a prefill +
    `append_token`/`paged_attention` decode loop, per-layer gather plan
    reports from the shared `GatherEngine`, tokens/s, and a paged-vs-dense
    parity gate (the paged path must reproduce `_sdpa` over the same K/V).

    The random numbers are drawn in the JAX package's order (each token: k
    then v per layer; each decode step: q per layer), one draw per token or
    step. The static allocator keeps every layer's page table constant, so
    all steady-state gathers resolve through one cached engine: the loop
    raises unless the decode steps after the first build zero schedules.
    Returns the caches, the rates, the parity error, the builds and the
    per-layer plan reports."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.engine import schedule_cache_stats
    from repro_torch.core.gather_engine import gather_engine_cache_stats
    from repro_torch.core.runtime import resolve_device
    from repro_torch.models.layers import _sdpa
    from repro_torch.models.paged_kv import (
        alloc_paged, append_token, kv_plan_report, paged_attention,
    )

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    B, L = args.batch, cfg.n_layers
    n_kv, hd, H = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_heads
    block, steps = args.page_block, args.decode_steps
    max_len = args.prompt_len + steps
    max_pages = -(-max_len // block)
    # serve's --backend names the SpMV backends; the gather engine calls the
    # schedule executed in torch "coalesced" and takes "reference" for it.
    backend = args.backend
    print(
        f"paged-serve: {args.arch} ({'reduced' if args.reduced else 'full'}) "
        f"layers={L} batch={B} n_kv={n_kv} head_dim={hd} heads={H} "
        f"page_block={block} prompt={args.prompt_len} decode={steps} "
        f"backend={backend} device={dev}"
    )

    # One paged cache per layer (pool sized exactly for the batch), plus a
    # dense mirror of everything appended on the same device — the parity
    # reference.
    caches = [
        alloc_paged(
            n_pages=B * max_pages, block=block, n_kv=n_kv, hd=hd,
            batch=B, max_len=max_len, dtype=torch.float32, device=dev,
        )
        for _ in range(L)
    ]
    dense_k = torch.zeros((L, B, max_len, n_kv, hd), dtype=torch.float32,
                          device=dev)
    dense_v = torch.zeros_like(dense_k)
    rng = np.random.default_rng(args.seed)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def append_all(pos: int) -> None:
        """One token's K/V per layer into both the paged and dense caches
        (one draw of (L, 2, B, n_kv, hd): the same numbers, in the same
        order, as a k draw and a v draw per layer)."""
        kv = torch.as_tensor(
            rng.standard_normal((L, 2, B, n_kv, hd)).astype(np.float32),
            device=dev,
        )
        dense_k[:, :, pos] = kv[:, 0]
        dense_v[:, :, pos] = kv[:, 1]
        for li in range(L):
            caches[li] = append_token(caches[li], kv[li, 0], kv[li, 1])

    # --- prefill: stage the prompt into every layer's cache
    t0 = time.time()
    for pos in range(args.prompt_len):
        append_all(pos)
    sync()
    prefill_s = time.time() - t0

    # --- decode loop: append one token then attend over the paged cache,
    # checking every layer against dense SDPA on the mirrored K/V
    max_err = torch.zeros((), dtype=torch.float32, device=dev)
    builds_after_first = None
    t0 = time.time()
    for step in range(steps):
        pos = args.prompt_len + step
        append_all(pos)
        cur = pos + 1
        mask = torch.ones((B, 1, 1, cur), dtype=torch.bool, device=dev)
        q_all = torch.as_tensor(
            rng.standard_normal((L, B, 1, H, hd)).astype(np.float32),
            device=dev,
        )
        for li in range(L):
            q = q_all[li]
            out_p = paged_attention(q, caches[li], n_heads=H, backend=backend)
            out_d = _sdpa(q, dense_k[li, :, :cur], dense_v[li, :, :cur], mask)
            max_err = torch.maximum(max_err, (out_p - out_d).abs().max())
        if step == 0:
            builds_after_first = schedule_cache_stats()["built"]
    sync()
    decode_s = time.time() - t0
    builds_warm = (schedule_cache_stats()["built"] - builds_after_first
                   if steps else 0)
    max_err = float(max_err)

    # --- per-layer gather plan report (identical tables -> one shared plan)
    reports = []
    for li in range(L):
        rep = kv_plan_report(caches[li], backend=backend)
        reports.append(rep)
        gp = rep["gather_perf"]
        print(
            f"  layer {li}: pages={rep['n_indices']} "
            f"wide_accesses={rep['wide_accesses']} "
            f"coalesce_rate={rep['coalesce_rate']:.2f} "
            f"cached={rep['schedule_cached']} "
            f"meta_bytes={rep['metadata']['meta_bytes']} "
            f"model_speedup=x{gp['speedup']:.2f}"
        )
    toks = B * steps
    tok_per_s = toks / max(decode_s, 1e-12)
    print(
        f"  prefill {args.prompt_len} tokens in {prefill_s:.3f}s; decoded "
        f"{steps} steps x {B} requests in {decode_s:.3f}s "
        f"({tok_per_s:.1f} tok/s, {L} layers)"
    )
    stats = schedule_cache_stats()
    eng_stats = gather_engine_cache_stats()
    print(
        f"  parity vs dense cache: max_abs_err={max_err:.2e} (tol=1e-5); "
        f"plan builds: total={stats['built']}, steady-state={builds_warm}; "
        f"engine cache: {eng_stats}"
    )
    if not (max_err <= 1e-5):
        raise SystemExit(
            f"paged-serve: paged attention diverged from the dense cache "
            f"(max_abs_err={max_err:.3e} > 1e-5)"
        )
    if builds_warm != 0:
        raise SystemExit(
            f"paged-serve: plan-reuse violation — {builds_warm} schedule "
            f"build(s) after the first decode step (expected 0)"
        )
    return {
        "caches": caches,
        "config": cfg,
        "prefill_s": prefill_s,
        "decode_s": decode_s,
        "tok_per_s": tok_per_s,
        "max_err": max_err,
        "builds_warm": builds_warm,
        "reports": reports,
    }


def run(args) -> Dict[str, object]:
    """Serve the mode the flags select: ``--spmv`` or ``--arch --paged``."""
    if args.spmv and args.arch:
        raise ValueError("pass either --spmv or --arch --paged, not both")
    if args.spmv:
        return serve_spmv(args)
    if not args.arch:
        raise ValueError("pass --spmv FAMILY or --arch ID --paged")
    if not args.paged:
        raise NotImplementedError(
            "generation is not ported yet (ROADMAP A13); --arch serves "
            "paged decode with --paged"
        )
    return serve_paged(args)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="serve batched SpMV or paged decode through the "
        "plan-once engines"
    )
    ap.add_argument(
        "--spmv", choices=sorted(_SPMV_MATRICES),
        help="synthetic matrix family to serve",
    )
    ap.add_argument(
        "--arch",
        help="architecture id (repro_torch.configs); with --paged, serve "
        "paged decode at its widths",
    )
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced (CPU-sized) variant")
    ap.add_argument(
        "--paged", action="store_true",
        help="serve end-to-end paged decode for --arch: per-layer paged KV "
        "caches with the page gather resolved through the shared "
        "GatherEngine, gated on paged-vs-dense parity and zero steady-state "
        "plan builds",
    )
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="prompt tokens prefilled per request for --paged")
    ap.add_argument(
        "--decode-steps", type=int, default=16,
        help="decode steps for --paged (tokens generated per request)",
    )
    ap.add_argument("--page-block", type=int, default=4,
                    help="KV page size in tokens for --paged")
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
        "picks cuda on a CUDA device, the reference on the CPU; for --paged "
        "the reference is the schedule executed in torch)",
    )
    ap.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the plan and the execution live",
    )
    return ap


def main(argv=None) -> None:
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
