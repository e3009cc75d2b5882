"""Serving launcher (port of the ``--spmv``, ``--solve`` and ``--paged``
modes of `repro.launch.serve`).

`python -m repro_torch.launch.serve --spmv banded --spmv-rows 1000000
--batch 64 --requests 8` stands up an `SpMVEngine` for one synthetic matrix
on the card and serves batches of right-hand sides through the cached
coalescer plan (`matmat`, the fused `sell_spmm` kernel), reporting the plan,
the backend, the perf model's matmat prediction, steady-state SpMV/s and
GFLOP/s, and the schedule cache counters. ``--stream depth=D,microbatch=B``
serves the same batches again through `core.runtime.StreamingExecutor`
(pinned staging ring, copy stream) and reports its parity with the
synchronous result, its SpMV/s and the perf model's overlap prediction.
``--schedule-cache DIR`` keeps plans in the persistent store
(`core.schedule_store`, the JAX package's file format);
``--assert-warm-cache`` exits non-zero unless the process planned nothing.
``--tune [model|measure]`` picks the plan knobs with `core.tune.autotune`
first (winners persist under ``--tune-cache DIR``, so a repeat serve runs
zero trials). ``--mesh SPEC`` serves through `core.dist.ShardedSpMVEngine`
(row shards over the mesh's ``data`` axis, RHS columns over ``model``;
``--partition`` picks the shard boundaries) and reports the partition's
imbalance, one line per shard and per-device throughput; it composes with
``--stream``, ``--schedule-cache``, ``--assert-warm-cache`` and ``--chaos
shard_fail:...`` (a failed shard is recomputed by the reference executor).

``--spmv FAMILY --solve cg|pagerank|jacobi|power`` serves an iterative
solver (`core.solvers`) over the family's matrix (cg/jacobi make it SPD with
`make_spd`): a cold solve, then ``--requests`` warm ones, with iterations,
iters/s and schedule builds; it exits non-zero unless the solve converged,
the cold solve built one schedule and the warm ones none.

`python -m repro_torch.launch.serve --arch llama3-8b --paged --batch 16
--prompt-len 1024 --decode-steps 16 --page-block 16` serves end-to-end paged
decode at the config's widths (layers, heads, KV heads, head_dim; random
K/V/q from --seed, no weights): per-layer paged KV caches
(`models.paged_kv`) whose page gathers run through the shared
`core.gather_engine` plan cache (the `coalesced_gather` kernel on the card),
with per-layer gather plan reports, tokens/s, a paged-vs-dense parity gate
(1e-5) and a zero-steady-state-plan-builds gate. With ``--chaos`` and
``--schedule-cache`` one layer's gather plan makes a round trip through the
store.

`python -m repro_torch.launch.serve --arch llama3-8b --batch 8 --prompt-len
512 --tokens 32` generates with the model stack (`models.build_model`,
seeded random weights drawn on the card): `generate` prefills the prompts
through one multi-token `decode_step`, then decodes ``--tokens`` greedy
steps, the one-token step captured as one CUDA graph on the card and
replayed a token (eager on the CPU), and the report gives ``generated (B,
T) in … s (… tok/s batched)`` with the prefill's ms and the decode's ms per
step. ``--reduced`` serves the
config's CPU-sized variant, e.g. ``--arch tinyllama-1.1b --reduced --tokens
8 --device cpu``.

``--chaos SPEC`` runs the selected mode under deterministic fault injection
(`core.faults`) and exits non-zero unless a fault was injected, every
injected fault recovered, and parity with the fault-free result held.

``--device cpu`` runs any mode on the CPU (the reference executors under
``--backend auto``); without it every mode runs on the card, and raises
where there is none.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

from repro_torch.core import faults
from repro_torch.core import matrices as _matgen

_SPMV_MATRICES = {
    "banded": lambda n: _matgen.banded(n, 24, 0.8),
    "powerlaw": lambda n: _matgen.powerlaw(n, 12),
    "random": lambda n: _matgen.random_uniform(n, 16),
}

# The JAX package's tolerance for each solver served by --solve.
SOLVE_TOLS = {"cg": 1e-6, "jacobi": 1e-6, "pagerank": 1e-7, "power": 1e-5}


def _sync(device) -> None:
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_solve(args) -> Dict[str, object]:
    """Iterative-solver serving: one plan-once engine, a device-resident
    loop per solve (`core.solvers`, CUDA-graph blocks on the card). Prints
    the cold solve (with the schedules it built — exactly one) and the warm
    solves' iterations/s over --requests repeats; returns the operator, the
    right-hand side and every solve's result."""
    from repro_torch.core import solvers
    from repro_torch.core.matrices import make_spd

    gen = _SPMV_MATRICES[args.spmv](args.spmv_rows)
    csr = gen(seed=args.seed)
    if args.solve in ("cg", "jacobi"):
        csr = make_spd(csr)  # CG/Jacobi need SPD / diag-dominant input
    tol = SOLVE_TOLS[args.solve]
    kw = dict(
        backend=args.backend, window=args.window, block_rows=args.block_rows,
        cache_dir=args.schedule_cache, device=args.device,
    )
    solver = {
        "cg": lambda m, b: solvers.cg(m, b, tol=tol, **kw),
        "jacobi": lambda m, b: solvers.jacobi(m, b, tol=tol, **kw),
        "pagerank": lambda m, b: solvers.pagerank(m, tol=tol, **kw),
        "power": lambda m, b: solvers.power_iteration(m, tol=tol, **kw),
    }[args.solve]
    b = np.random.default_rng(args.seed + 1).standard_normal(
        csr.n_rows
    ).astype(np.float32)

    t0 = time.time()
    cold = solver(csr, b)
    cold_s = time.time() - t0
    print(
        f"solve-serve: {args.solve} on {args.spmv} {csr.n_rows}x"
        f"{csr.n_cols} nnz={csr.data.size} backend={args.backend} "
        f"device={args.device} tol={tol:g}"
    )
    print(
        f"  cold: {cold.iterations} iters in {cold_s:.3f}s "
        f"(schedule_builds={cold.schedule_builds}, loop={cold.loop})"
    )
    t0 = time.time()
    iters = 0
    warm = []
    for _ in range(max(1, args.requests)):
        warm.append(solver(csr, b))
        iters += warm[-1].iterations
    warm_s = time.time() - t0
    res = warm[-1]
    extra = (
        f" eigenvalue={res.eigenvalue:.6g}" if res.eigenvalue is not None
        else ""
    )
    print(
        f"  warm: {len(warm)} solves, "
        f"{iters / warm_s:.1f} iters/s "
        f"(schedule_builds={res.schedule_builds}, residual="
        f"{res.residual:.3e}, converged={res.converged}{extra})"
    )
    if not res.converged:
        raise SystemExit(f"solve-serve: {args.solve} did not converge")
    if cold.schedule_builds != 1 or res.schedule_builds != 0:
        raise SystemExit(
            f"solve-serve: plan-reuse violation (cold built "
            f"{cold.schedule_builds}, warm built {res.schedule_builds})"
        )
    return {
        "csr": csr,
        "b": b,
        "tol": tol,
        "cold": cold,
        "cold_s": cold_s,
        "warm": warm,
        "warm_s": warm_s,
        "iters_per_s": iters / warm_s,
    }


def serve_spmv(args) -> Dict[str, object]:
    """Batched SpMV serving: one engine, many right-hand-side batches, then
    (``--stream``) the same batches through the streaming pipeline. Prints
    the report and returns the engine, the request batches, the first
    batch's served result, and the measured rates."""
    from repro_torch.core.engine import get_engine, schedule_cache_stats
    from repro_torch.core.runtime import StreamingExecutor, parse_stream_spec

    gen = _SPMV_MATRICES[args.spmv](args.spmv_rows)
    csr = gen(np.random.default_rng(args.seed))
    out: Dict[str, object] = {"csr": csr}
    # Plan knobs: CLI defaults, unless the autotuner picks them. The tuned
    # cols_per_chunk implies the kernels' window, so an explicit --window is
    # dropped in favor of the derived one when tuning. As in the JAX
    # package's serve, the winner's value_dtype is not applied.
    knobs = dict(window=args.window, block_rows=args.block_rows)
    if args.tune:
        from repro_torch.core.tune import autotune

        t0 = time.time()
        tuned = autotune(
            csr, k=args.batch, backend=args.backend, mode=args.tune,
            cache_dir=args.tune_cache, device=args.device,
        )
        tune_s = time.time() - t0
        print(
            f"spmv-tune: cols_per_chunk={tuned.cols_per_chunk} "
            f"block_rows={tuned.block_rows} k_tile={tuned.k_tile} "
            f"packed={tuned.packed} buffer_depth={tuned.buffer_depth} "
            f"(mode={tuned.mode}, source={tuned.source}, "
            f"trials={tuned.trials}, cost={tuned.cost:.3g}, "
            f"{tune_s:.3f}s)"
        )
        knobs = dict(
            window=None,
            block_rows=tuned.block_rows,
            cols_per_chunk=tuned.cols_per_chunk,
            k_tile=tuned.k_tile,
            packed=bool(tuned.packed),
            buffer_depth=tuned.buffer_depth,
        )
        out.update(tuned=tuned, tune_s=tune_s)
    t0 = time.time()
    if args.mesh:
        from repro_torch.core.dist import ShardedSpMVEngine
        from repro_torch.launch.mesh import parse_mesh_spec

        engine = ShardedSpMVEngine(
            csr,
            mesh=parse_mesh_spec(args.mesh, device=args.device),
            backend=args.backend,
            partition=args.partition,
            cache_dir=args.schedule_cache,
            **knobs,
        )
        # Forces every shard's schedule build; k= folds the matmat
        # amortization prediction into the same report pass.
        rep = engine.plan_report(k=args.batch if args.batch > 1 else None)
        plan_s = time.time() - t0
        _print_sharded_plan(args, rep, plan_s)
    else:
        engine = get_engine(
            csr, backend=args.backend, device=args.device,
            cache_dir=args.schedule_cache, **knobs,
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
    out.update(engine=engine, report=rep)
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
    stream_cfg = parse_stream_spec(args.stream) if args.stream else None
    streamer = stream_pred = None
    if stream_cfg is not None:
        streamer = StreamingExecutor(
            engine,
            microbatch=stream_cfg["microbatch"],
            depth=stream_cfg["depth"],
            # Under chaos, budget micro-batch retries so injected dispatch
            # timeouts heal inside the pipeline instead of failing batches.
            retries=2 if faults.active_plan() is not None else 0,
        )
        # The serving loop feeds every request through one pipeline, so the
        # overlap term sees the whole stream of columns.
        stream_pred = engine.plan_report(
            stream={**stream_cfg, "k": args.batch * args.requests}
        )["streaming"]["perf"]["pack256"]
        hidden_side = (
            "transfer" if stream_pred["bottleneck"] == "compute"
            else "compute"
        )
        print(
            f"  stream: depth={stream_cfg['depth']} "
            f"microbatch={stream_cfg['microbatch']} — model predicts "
            f"x{stream_pred['speedup']:.3f} streamed speedup "
            f"({stream_pred['bottleneck']}-bound, "
            f"{stream_pred['overlap_efficiency'] * 100.0:.0f}% of "
            f"{hidden_side} hidden)"
        )
    # Host-side request batches, pregenerated so RHS generation stays out of
    # the timed loops (the host->device transfer is part of serving).
    rng = np.random.default_rng(args.seed + 1)
    batches = [
        rng.standard_normal((csr.n_cols, args.batch)).astype(np.float32)
        for _ in range(args.requests)
    ]
    # warm the path outside the timed loop
    y_first = engine.matmat(batches[0])
    _sync(engine.device)
    out.update(batches=batches, batch=batches[0], y=y_first)
    if faults.active_plan() is not None:
        # Chaos parity: the same batch with injection suspended is the
        # fault-free oracle; recovery must be bit-identical on the reference
        # backend and within float tolerance on the kernels.
        with faults.suspended():
            y_ref = engine.matmat(batches[0])
        chaos_err = float((y_first - y_ref).abs().max()) \
            if y_ref.numel() else 0.0
        chaos_tol = 0.0 if rep["backend_resolved"] == "reference" else 1e-5
        print(
            f"  chaos parity vs fault-free matmat: "
            f"max_abs_err={chaos_err:.2e} (tol={chaos_tol:g})"
        )
        if not chaos_err <= chaos_tol:
            raise SystemExit(
                f"--chaos: recovered result diverged from fault-free oracle "
                f"(max_abs_err={chaos_err:.2e} > tol={chaos_tol:g})"
            )
        out["chaos_err"] = chaos_err
    if streamer is not None:
        y_stream = streamer.matmat(batches[0])
        err = float((y_stream - y_first).abs().max()) \
            if y_first.numel() else 0.0
        print(f"  stream parity vs sync matmat: max_abs_err={err:.2e}")
        out.update(y_stream=y_stream, stream_err=err)
    t0 = time.time()
    for B in batches:
        engine.matmat(B)
        _sync(engine.device)
    dt = time.time() - t0
    spmvs = args.requests * args.batch
    spmv_per_s = spmvs / max(dt, 1e-12)
    gflops = 2.0 * csr.nnz * spmvs / max(dt, 1e-12) / 1e9
    print(
        f"  served {args.requests} batches x {args.batch} RHS in {dt:.3f}s "
        f"sync ({spmv_per_s:.1f} SpMV/s, {gflops:.3f} GFLOP/s equivalent)"
    )
    out.update(seconds=dt, spmv_per_s=spmv_per_s, gflops=gflops)
    if streamer is not None:
        staging_before = streamer.staging
        t0 = time.time()
        for B in batches:
            streamer.submit(B)  # the bounded window applies backpressure
        outs = streamer.drain()
        _sync(engine.device)
        dt_stream = time.time() - t0
        if outs.failures:
            first = outs.failures[0]
            raise SystemExit(
                f"stream: {len(outs.failures)} batch(es) failed after "
                f"{first.retries} retry(ies): {first.error!r}"
            )
        staging_after = streamer.staging
        staging = {key: staging_after[key] - staging_before[key]
                   for key in staging_before}
        gflops_s = 2.0 * csr.nnz * spmvs / max(dt_stream, 1e-12) / 1e9
        print(
            f"  streamed the same {args.requests} batches in {dt_stream:.3f}s "
            f"({spmvs / dt_stream:.1f} SpMV/s, {gflops_s:.3f} GFLOP/s, "
            f"x{dt / max(dt_stream, 1e-12):.2f} vs sync); staging "
            f"{staging['microbatches']} micro-batches: host packing "
            f"{staging['pack_s'] * 1e3:.3f} ms, host-to-device copies "
            f"{staging['copy_ms']:.3f} ms on the device"
        )
        out.update(streamer=streamer, stream_outs=list(outs),
                   stream_seconds=dt_stream,
                   stream_spmv_per_s=spmvs / max(dt_stream, 1e-12),
                   stream_pred=stream_pred, staging=staging)
    if args.mesh:
        out["per_device_gflops"] = _per_device_throughput(args, engine, csr,
                                                          dt)
        rec = engine.recovery_report()
        print(f"  recovery: recovered={rec['recovered']} "
              f"injected={rec['injected']}")
        if rec["recovered"] != rec["injected"]:
            raise SystemExit(
                f"--mesh: {rec['recovered'] - rec['injected']} shard(s) were "
                f"recomputed after a failure that was not injected"
            )
    stats = schedule_cache_stats()
    print(f"  schedule cache: {stats}")
    out.update(plan_s=plan_s, cache_stats=stats)
    if args.assert_warm_cache:
        # A process pointed at a warm on-disk cache must not plan from
        # scratch even once.
        if stats["built"] != 0:
            raise SystemExit(
                f"--assert-warm-cache: expected zero cold plans but "
                f"build_block_schedule ran {stats['built']} time(s) "
                f"(disk_hits={stats['disk_hits']}, "
                f"disk_rejects={stats['disk_rejects']})"
            )
        print(
            f"  warm-cache assertion OK: zero cold plans "
            f"(disk_hits={stats['disk_hits']})"
        )
    return out


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
    drill = None
    if faults.active_plan() is not None and args.schedule_cache:
        drill = _gather_store_drill(caches[0], backend, args.schedule_cache)
    return {
        "caches": caches,
        "config": cfg,
        "prefill_s": prefill_s,
        "decode_s": decode_s,
        "tok_per_s": tok_per_s,
        "max_err": max_err,
        "builds_warm": builds_warm,
        "reports": reports,
        "store_drill": drill,
    }


def _copy_back(cache, new, where="cache") -> None:
    """Every tensor of `new` (the cache a step returned) that is not the
    one `cache` holds there copied into `cache`'s own: the advanced index
    and the recurrent state (Mamba2, mLSTM, sLSTM) land in the buffers the
    next step, and a captured graph, read. The KV caches are written in
    place and skipped."""
    if torch.is_tensor(new):
        if new is not cache:
            if new.shape != cache.shape or new.dtype != cache.dtype:
                raise ValueError(
                    f"{where}: the step returned {new.dtype} "
                    f"{tuple(new.shape)} for a {cache.dtype} "
                    f"{tuple(cache.shape)} buffer")
            cache.copy_(new)
    elif isinstance(new, dict):
        for k, v in new.items():
            _copy_back(cache[k], v, f"{where}[{k!r}]")
    elif isinstance(new, (list, tuple)):
        for i, v in enumerate(new):
            _copy_back(cache[i], v, f"{where}[{i}]")


def one_token_step(model, params, tokens, cache, rt):
    """The one-token step `generate` runs after the prefill, over static
    buffers: `tokens` (B, 1) int32 and `cache`, whose index and recurrent
    state each call advances in place (`_copy_back`). The gathers plan in
    the step (`core.indirect_stream.in_step`, `repro`'s jitted step).
    Returns a function of no arguments that runs one step and returns its
    logits (B, 1, V)."""
    from repro_torch.core.indirect_stream import in_step

    def step():
        with in_step():
            logits, new = model.decode_step(params, tokens, cache, rt)
        _copy_back(cache, new)
        return logits

    return step


class CapturedStep:
    """A step function (`one_token_step`) captured as one CUDA graph on
    `stream` (where its warm-up ran), for `name`'s model. Calling it replays
    the graph and returns its static logits; the kernel launches it holds
    are added to the wrappers' counts on each replay
    (`kernels.ops.CapturedLaunches`). A capture that fails raises: there is
    no eager fallback."""

    def __init__(self, step, stream, name: str):
        from repro_torch.kernels.ops import CapturedLaunches

        self.graph = torch.cuda.CUDAGraph()
        try:
            with CapturedLaunches() as launches, \
                    torch.cuda.graph(self.graph, stream=stream):
                self.logits = step()
        except Exception as exc:
            raise RuntimeError(
                f"{name}: generate could not capture the decode step into a "
                f"CUDA graph ({exc})") from exc
        self.launches = launches

    def __call__(self):
        self.graph.replay()
        self.launches.replayed()
        return self.logits


def generate(model, params, prompt, *, max_new_tokens: int, rt,
             extras_batch=None, greedy: bool = True, generator=None,
             capture=None, step_hook=None):
    """Prefill the prompt (one multi-token `decode_step`, eager), then decode
    `max_new_tokens` steps, each appending the last token, as `repro`'s
    `generate` does (which jits the step, not the prefill). `params` is the
    family module `model.init` (or `core.interop.model_params_from_numpy`)
    returned; the prompt (B, S) moves to its device. Greedy takes the
    argmax; otherwise each token is drawn from the softmax with `generator`
    (on the params' device); both outside the step.

    The step is `one_token_step` over a static token buffer and the cache
    (sized ``S + max_new_tokens``, which bounds the cache index the step
    advances on the device). On the card (``capture`` None or True) the
    first step runs eagerly on a side stream, the capture's warm-up, then
    the step is captured once as a CUDA graph on that stream
    (`CapturedStep`) and each later token is one replay; a capture that
    fails raises. ``capture=False`` runs every step eagerly, as the CPU
    does. ``step_hook(kind, ids, run)``, when given, is called for each
    step instead of ``run()`` and returns what ``run()`` returns: kind
    ``"prefill"``, ``"step"`` (eager), ``"capture"`` (``run()`` returns the
    `CapturedStep`) or ``"replay"``, the step's input ids, and the step,
    which returns its logits (B, S, V) (on a replay the graph's static
    buffer: clone them to keep them).
    Returns the (B, max_new_tokens) int32 tokens."""
    B, S = prompt.shape
    device = params.device
    if capture is None:
        capture = device.type == "cuda"
    if capture and device.type != "cuda":
        raise ValueError(f"capture=True needs the card; the params lie on "
                         f"{device}")

    def run(kind, ids, fn):
        return fn() if step_hook is None else step_hook(kind, ids, fn)

    prompt = prompt.to(device=device, dtype=torch.int32)
    with torch.inference_mode():
        cache = model.init_cache(B, S + max_new_tokens, rt, device=device)
        if model.cfg.family == "audio":
            cache["enc_out"] = model.extras["encode"](
                params, extras_batch["enc_input"], rt)
        if model.cfg.family == "vlm":
            cache["image_embeds"] = extras_batch["image_embeds"]
        out = {}

        def prefill():
            logits, out["cache"] = model.decode_step(params, prompt, cache,
                                                     rt)
            return logits

        logits = run("prefill", prompt, prefill)
        cache = out.pop("cache")
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        tokens = tok.clone()
        step = one_token_step(model, params, tokens, cache, rt)
        side = torch.cuda.Stream(device) if capture else None
        graph = None
        outs = []
        for i in range(max_new_tokens):
            outs.append(tok)
            tokens.copy_(tok)
            if graph is not None:
                logits = run("replay", tokens, graph)
            elif side is not None:
                side.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.stream(side):
                    logits = run("step", tokens, step)
                torch.cuda.current_stream(device).wait_stream(side)
                if i + 1 < max_new_tokens:
                    graph = run("capture", tokens, lambda: CapturedStep(
                        step, side, model.cfg.name))
            else:
                logits = run("step", tokens, step)
            if greedy:
                tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            else:
                tok = torch.multinomial(torch.softmax(logits[:, -1], -1), 1,
                                        generator=generator)
            tok = tok.to(torch.int32)
    return torch.cat(outs, dim=1)


def serve_generate(args) -> Dict[str, object]:
    """Batched generation with the model stack: seeded random weights
    (``--seed``) and prompts (``--seed`` + 1) on the device, `generate` with
    `repro`'s default `Runtime()`, and the report line of `repro`'s serve
    plus the prefill's ms and the decode's ms per step (host clock,
    synchronised after each step; on the card the replays of the captured
    step). Returns the model, its params, the batch, the tokens and the
    times (``step_seconds``: each step's, by `generate`'s kind)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.runtime import resolve_device
    from repro_torch.models import Runtime, build_model, make_input_batch

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    model = build_model(cfg)
    rt = Runtime()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed),
                        device=dev)
    batch = make_input_batch(
        cfg, args.batch, args.prompt_len,
        torch.Generator(device=dev).manual_seed(args.seed + 1), device=dev)
    _sync(dev)
    init_s = time.perf_counter() - t0
    print(f"generate: {args.arch} ({'reduced' if args.reduced else 'full'}) "
          f"layers={cfg.n_layers} d_model={cfg.d_model} "
          f"vocab={cfg.vocab_size} dtype={cfg.dtype} batch={args.batch} "
          f"prompt={args.prompt_len} tokens={args.tokens} device={dev}; "
          f"weights and prompts drawn in {init_s:.2f}s")

    secs = {}  # kind -> host seconds of each step of that kind

    def timed(kind, ids, run):
        t = time.perf_counter()
        out = run()
        _sync(dev)
        secs.setdefault(kind, []).append(time.perf_counter() - t)
        return out

    t0 = time.perf_counter()
    out = generate(model, params, batch["tokens"],
                   max_new_tokens=args.tokens, rt=rt, extras_batch=batch,
                   step_hook=timed)
    _sync(dev)
    dt = time.perf_counter() - t0
    total = args.batch * args.tokens
    prefill_ms = secs["prefill"][0] * 1e3
    # the decode's ms a step: the replays' on the card (the first step, the
    # capture's eager warm-up, and the capture are printed apart), every
    # eager step's on the CPU
    decode = secs.get("replay") or secs.get("step") or []
    decode_ms = float(np.mean(decode)) * 1e3 if decode else 0.0
    how = "captured, replayed" if "replay" in secs else "eager"
    extra = "".join(
        f", {kind} {secs[kind][0] * 1e3:.3f} ms"
        for kind in ("step", "capture") if "replay" in secs and kind in secs)
    print(f"generated {tuple(out.shape)} in {dt:.2f}s "
          f"({total / dt:.1f} tok/s batched); prefill {prefill_ms:.3f} ms, "
          f"decode {decode_ms:.3f} ms/step over {len(decode)} steps "
          f"({how}{extra})")
    print(out[0][:16].tolist())
    return {
        "config": cfg, "model": model, "params": params, "batch": batch,
        "rt": rt, "tokens": out, "seconds": dt, "tok_per_s": total / dt,
        "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
        "init_s": init_s, "step_seconds": secs,
    }


def _gather_store_drill(cache, backend: str, cache_dir: str) -> str:
    """Chaos drill of the paged path: decode plans in memory only, so one
    layer's gather plan makes a round trip through the self-healing store to
    give the store's fault sites something to hit (store_write retries
    inside persist; a store_read corruption heals by quarantine and
    re-persist). Returns how the round trip went."""
    from repro_torch.core import schedule_store
    from repro_torch.models.paged_kv import _kv_engine

    eng = _kv_engine(cache, backend=backend)
    eng.schedule  # force the plan before persisting
    path = eng.persist_schedule(cache_dir)
    healed = "clean"
    try:
        schedule_store.load_schedule(
            path, expect_stream_digest=eng.digest, device=eng.device
        )
    except schedule_store.ScheduleCacheMismatch:
        schedule_store.quarantine(path)
        eng.persist_schedule(cache_dir)
        faults.note_recovered("store_read")
        healed = "quarantined + re-persisted"
        with faults.suspended():  # oracle read: verify the healed file
            try:
                schedule_store.load_schedule(
                    path, expect_stream_digest=eng.digest, device=eng.device
                )
            except Exception as exc:
                raise SystemExit(
                    f"paged-serve: gather plan unreadable after "
                    f"quarantine + re-persist: {exc!r}"
                )
    print(f"  chaos store drill: gather plan round-trip {healed}")
    return healed


def _print_sharded_plan(args, rep, plan_s: float) -> None:
    """The sharded engine's plan report: mesh, partition and its imbalance,
    one line per shard."""
    cached = [s["schedule_cached"] for s in rep["shards"]]
    print(
        f"spmv-serve: {args.spmv} {rep['n_rows']}x{rep['n_cols']} "
        f"nnz_padded={rep['nnz_padded']} planned in {plan_s:.3f}s "
        f"(schedules_cached={sum(bool(c) for c in cached)}"
        f"/{len(cached)})"
    )
    print(
        f"  mesh: data={rep['mesh']['data']} model={rep['mesh']['model']}"
        f" ({rep['n_devices']} devices), {rep['n_shards']} row shards, "
        f"backend {rep['backend']} -> {rep['backend_resolved']}"
    )
    print(
        f"  plan: block_rows={rep['block_rows']} "
        f"wide_accesses={rep['wide_accesses']} "
        f"coalesce_rate={rep['coalesce_rate']:.2f}"
    )
    part = rep["partition"]
    imb = part["imbalance"]
    print(
        f"  partition: {part['strategy']} "
        f"imbalance={imb['ratio']:.3f} "
        f"(max={imb['max_shard_cycles']:.0f} / "
        f"mean={imb['mean_shard_cycles']:.0f} model cycles/shard)"
    )
    for s in rep["shards"]:
        print(
            f"    shard {s['shard']} [{s['device_str']}]: rows "
            f"[{s['rows'][0]}, {s['rows'][1]}) width={s['width']} "
            f"window={s['window']} "
            f"wide_accesses={s['wide_accesses']} "
            f"coalesce_rate={s['coalesce_rate']:.2f} "
            f"cached={s['schedule_cached']}"
        )


def _per_device_throughput(args, engine, csr, dt: float) -> Dict[str, float]:
    """Each grid device owns one (row shard, column group) block of every
    batch; its share of the real FLOPs (the shard's rows of csr.nnz) over
    the synchronous serving time is its rate."""
    from repro_torch.core.dist import device_str

    per_dev: Dict[str, float] = {}
    for blk in engine.placement(args.batch):
        lo, hi = blk["rows"]
        nnz_shard = int(csr.indptr[hi]) - int(csr.indptr[lo])
        c0, c1 = blk["cols"]
        key = device_str(blk["device"])
        per_dev[key] = per_dev.get(key, 0.0) + (
            2.0 * nnz_shard * (c1 - c0) * args.requests)
    rates = {key: flops / max(dt, 1e-12) / 1e9
             for key, flops in per_dev.items()}
    print(f"  per-device throughput ({len(rates)} active devices):")
    for key in sorted(rates):
        print(f"    {key} {rates[key]:.3f} GFLOP/s")
    return rates


def run(args) -> Dict[str, object]:
    """Serve the mode the flags select (``--spmv`` [``--solve``] or ``--arch``
    [``--paged``]); with ``--chaos`` under that fault plan, gated on injection,
    recovery and parity (the plan's report lands in the result as
    ``"chaos"``)."""
    if args.chaos is None:
        return _run_mode(args)
    plan = faults.FaultPlan(args.chaos)
    with plan:
        out = _run_mode(args)
    rep = plan.report()
    print(
        f"chaos: spec={args.chaos!r} injected={rep['injected']} "
        f"recovered={rep['recovered']} unrecovered={rep['unrecovered']}"
    )
    for site, s in sorted(rep["sites"].items()):
        print(
            f"  {site}: events={s['events']} injected={s['injected']} "
            f"recovered={s['recovered']}"
        )
    if rep["injected"] == 0:
        raise SystemExit(
            "--chaos: spec injected no faults — nothing was exercised "
            "(check the site names / after= thresholds against this mode)"
        )
    if rep["unrecovered"]:
        raise SystemExit(
            f"--chaos: {rep['unrecovered']} injected fault(s) were not "
            f"recovered"
        )
    print("chaos: all injected faults recovered")
    out["chaos"] = rep
    return out


def _run_mode(args) -> Dict[str, object]:
    if args.spmv and args.arch:
        raise ValueError("pass either --spmv or --arch, not both")
    if args.solve and not args.spmv:
        raise ValueError("--solve requires --spmv to pick the matrix family")
    if args.spmv:
        return serve_solve(args) if args.solve else serve_spmv(args)
    if not args.arch:
        raise ValueError("pass --spmv FAMILY or --arch ID")
    return serve_paged(args) if args.paged else serve_generate(args)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="serve batched SpMV, solvers, generation or paged "
        "decode through the plan-once engines"
    )
    ap.add_argument(
        "--spmv", choices=sorted(_SPMV_MATRICES),
        help="synthetic matrix family to serve",
    )
    ap.add_argument(
        "--arch",
        help="architecture id (repro_torch.configs): generate with its "
        "model, or with --paged serve paged decode at its widths",
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
                    help="prompt tokens prefilled per request")
    ap.add_argument("--tokens", type=int, default=32,
                    help="tokens generated per request by --arch without "
                    "--paged")
    ap.add_argument(
        "--decode-steps", type=int, default=16,
        help="decode steps for --paged (tokens generated per request)",
    )
    ap.add_argument("--page-block", type=int, default=4,
                    help="KV page size in tokens for --paged")
    ap.add_argument("--spmv-rows", type=int, default=8192)
    ap.add_argument(
        "--solve", choices=("cg", "pagerank", "jacobi", "power"),
        help="serve an iterative solver (core.solvers) over the --spmv "
        "matrix family instead of raw SpMV batches (cg/jacobi SPD-ify the "
        "matrix via make_spd)",
    )
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
    ap.add_argument(
        "--mesh", default=None, metavar="SPEC",
        help="shard --spmv serving over a device mesh: 'data,model' "
        "auto-factors all visible devices, '4,2' pins explicit (data, "
        "model) sizes (with --device cpu any size, repeating the CPU); row "
        "slices shard over data, RHS columns over model "
        "(core.dist.ShardedSpMVEngine)",
    )
    ap.add_argument(
        "--partition", default="auto",
        choices=("auto", "even", "nnz", "cost", "cost2d"),
        help="row-shard partition strategy for --mesh "
        "(core.partition.shard_bounds): 'even' splits slices uniformly, "
        "'nnz' balances padded nnz, 'cost' balances the perf-model shard "
        "cost (straggler-aware; what 'auto' resolves to), 'cost2d' adds a "
        "column-segment grid to the objective",
    )
    ap.add_argument(
        "--tune", nargs="?", const="model", choices=("model", "measure"),
        default=None,
        help="autotune (cols_per_chunk, block_rows, k_tile) for this matrix "
        "and batch width before serving (core.tune.autotune): 'model' "
        "scores candidates with the fused-matmat cycle model, 'measure' "
        "times real matmats; winners persist content-addressed (see "
        "--tune-cache) so repeat serves run zero trials",
    )
    ap.add_argument(
        "--tune-cache", default=None, metavar="DIR",
        help="persistent tuner cache directory (default: $REPRO_TUNE_CACHE, "
        "falling back to the schedule cache directory)",
    )
    ap.add_argument(
        "--stream", default=None, metavar="SPEC",
        help="also serve the --spmv batches through the streaming pipeline "
        "(core.runtime.StreamingExecutor): 'depth=D,microbatch=B' (either "
        "key optional; defaults depth=2, microbatch=32)",
    )
    ap.add_argument(
        "--schedule-cache", default=None, metavar="DIR",
        help="persistent BlockSchedule cache directory (default: "
        "$REPRO_SCHEDULE_CACHE); cold processes load known plans from here",
    )
    ap.add_argument(
        "--assert-warm-cache", action="store_true",
        help="exit nonzero unless this process planned zero schedules from "
        "scratch (requires a warm --schedule-cache)",
    )
    ap.add_argument(
        "--chaos", default=None, metavar="SPEC",
        help="run the selected mode under deterministic fault injection "
        "(core.faults spec, e.g. 'store_read:rate=1,count=1;"
        "dispatch_timeout:after=1,count=1' or, with --mesh, "
        "'shard_fail:after=1,count=1'); exits nonzero unless at least "
        "one fault was injected, every injected fault recovered, and parity "
        "with the fault-free oracle held",
    )
    return ap


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.chaos is not None:
        try:
            faults.parse_fault_spec(args.chaos)
        except ValueError as exc:
            ap.error(str(exc))
    run(args)


if __name__ == "__main__":
    main()
