#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. Environment and build: torch/CUDA versions, the card and its power limit,
   the kernels built from `src/repro_torch/kernels/csrc` with nvcc for
   sm_90a (build seconds, ptxas register lines).
2. Kernels against their plain torch versions on the card: `sell_spmv` and
   `sell_spmm` on the full-size banded plan (1,000,000 rows) and on a
   random-family plan (131,072 rows, 16 nonzeros a row, ~256 warps a
   window: its windows are staged in groups of warps), packed and unpacked
   metadata, float32 and bfloat16 values, k in {1, 7, 32, 33, 64, 65,
   128, 200} (k not a multiple of 4 or 8; 32 and 64 the streamed and the
   sync paths' k; k = 200 takes two 128-column grid columns), each at
   buffer_depth 1, 2 and 4. Tolerance
   ``|kernel - plain| <= 1e-5 + 1e-5 * |plain|`` elementwise: float32 sums
   of at most ~40 products per row, taken in another order. Then
   `coalesced_gather`, which must equal its plain version and
   ``table[idx]`` bitwise (as bytes) on every path a case can take (the
   TMA bulk path where rows and bases are 16-byte multiples, the vector-unit
   path always), on (a) the paged-KV shape of phase 5:
   a (1040, 16384) float32 page pool gathered through the static page
   table, block_rows 1, window 256, packed and unpacked metadata; (b) the
   same pool with the first 48 of each request's 65 pages shared (a
   768-token system prompt); (c) llama3-8b's token table (128256, 4096)
   bfloat16 with 8,192 zipf(1.1) ids, block_rows 8; (d) a (1001, 3)
   bfloat16 table, block_rows 8 (rows not a multiple of it, 2-byte units);
   (e) a table holding -0.0, inf and nan.
3. The main path: `repro_torch.launch.serve` with ``--spmv banded
   --spmv-rows 1000000 --batch 64 --requests 8`` in process, then one
   full-size `engine.matvec`, with both kernels' launch counts set to 0
   just before and read just after; the served batch and the matvec are
   checked against the reference backend on the card, and a small matrix
   against a float64 dense product.
4. Times at the main paths' shapes (CUDA events, warmed up, the run queued
   behind a spin kernel so that the host's launch overhead stays out of
   them): each kernel,
   its plain version, a PyTorch call computing the same function (a
   yardstick only: sparse-CSR products, `torch.index_select`), and the
   bound: the bytes the function must move over 3.35 TB/s, or its float32
   operations over 67 TFLOP/s, whichever is larger. For the SELL kernels
   the bytes are the matrix's (each nonzero's value and a 4-byte index, the
   tags), the right-hand side read once and the output written once; the
   operations are 2 per nonzero and column. The padding the plan adds is
   not counted there; the plan's own bytes are printed beside it, with
   each kernel's share of both, the X bytes a launch stages into shared
   memory (read from L2 or HBM), and the kernels' times at buffer_depth 1
   and 2. For the
   gather (shape (a); (b) and (c) are printed too) the bytes are each
   distinct row read once, the output rows written once, and the plan's
   metadata and tags; beside it, the rows the kernel reads by design (each
   distinct row of a window once), the time those bytes take, and the
   unit path's time on the same data; the same kernel through a plan that
   makes every element a key of its own (one read per element, no row
   read once for several outputs: what the fan-out saves); for (a), a
   device copy of the pool (``Tensor.copy_``) as the card's practical rate
   for the same bytes. Then both paths at 16-byte-aligned float32 rows of
   64 bytes to 8 KB through (c)'s index stream, where the wrapper's choice
   between them (`BULK_MIN_ROW_BYTES`) lies.
5. The paged path: `repro_torch.launch.serve` with ``--arch llama3-8b
   --paged --batch 16 --prompt-len 1024 --decode-steps 16 --page-block 16``
   in process (32 layers, 32 heads, 8 KV heads, head_dim 128; 65 pages a
   request, 1,040 pages a layer), with every launch count set to 0 just
   before and read just after; serve itself gates the
   paged attention against dense SDPA at 1e-5 and the decode steps after
   the first at zero schedule builds. Then one decode step split on the
   host clock (draws, appends, gathers, attention, the dense parity
   reference), the gather kernel's own share in CUDA events, and the
   device's busy share and time by kernel from torch.profiler.

6. Solvers: ``serve --spmv banded --spmv-rows 1000000 --solve cg``
   (``make_spd`` of the banded matrix) and ``--spmv powerlaw --solve
   pagerank``, in process, a cold solve and 2 warm ones each: iterations,
   iters/s, schedule builds (serve itself gates convergence, one build cold
   and none warm); `sell_spmv`'s launches equal the solves' own count of
   matvecs (CUDA graph replays counted); cg's true residual ``||b - A x|| /
   ||b||`` in float64 from the CSR on the card, PageRank's sum of x within
   1e-5 of 1; one more solve on each loop (``python``: launches equal
   iterations, plus cg's initial residual) with its host time per iteration;
   ``loop="while"`` (graph) bitwise equal to ``loop="python"`` on 131,072
   rows; `sell_spmv` timed at the CG and the PageRank matrices' shapes
   beside its byte bound and ``torch.mv`` on the same CSR.
7. Streaming: ``serve --spmv banded --spmv-rows 1000000 --batch 64
   --requests 8 --stream depth=2,microbatch=32``: every streamed batch
   within ``1e-5 + 1e-5 * |y|`` of the synchronous one and each of its
   32-column micro-batches of `sell_spmm_plain` on the same plan, sync and
   streamed
   SpMV/s, the perf model's predicted speedup, staging split into host
   packing and the host-to-device copy, depth 1 and 2 in turns on the same
   batches, and a torch.profiler window over two requests (copy and kernel
   intervals, and the time they ran at once).
8. Plan store and chaos: the banded serve at 131,072 rows cold with
   ``--schedule-cache`` (a directory under ``build/``, removed at the end;
   the plan file's size is printed), then warm with ``--assert-warm-cache``
   (zero builds), cold and warm plan seconds; the 1M banded schedule alone
   built, built and saved, and loaded; ``--chaos 'store_read:rate=1,count=1;
   store_write:count=1;dispatch_timeout:after=1,count=1'`` with ``--stream``
   on a 131,072-row banded matrix, and ``--paged --chaos
   store_read:rate=1,count=1`` on llama3-8b at full width (prompt 128, 2
   decode steps), each with every injected fault recovered.

9. Tuner: ``serve --spmv banded --spmv-rows 131072 --batch 64 --tune
   model --tune-cache build/tune-store-<pid>`` cold (72 trials: the
   default space with k_tile, which the kernels do not have, cut to one
   value) and warm
   (0 trials, the same winner, the same served batch), with the seconds of
   each; then `get_tuned_engine(mode="measure")` at the PageRank operator's
   1M shape (k = 1, `sell_spmv`; 27 geometries: cols_per_chunk and
   block_rows in {4, 8, 16}, buffer_depth in {1, 2, 4}) and at the banded
   1M shape (k = 64, `sell_spmm`; the 9 (cols_per_chunk, block_rows) pairs
   at depth 2): every candidate's time, the infeasible ones, the winner
   beside the default geometry (8, 8, 2), and the winner's engine within
   ``1e-5 + 1e-5 * |plain|`` of `sell_spmv_plain` / `sell_spmm_plain`.
10. Sharded engine: `ShardedSpMVEngine` with 4 shards on a 1x1 grid of the
   card for partitions even, nnz, cost (and cost2d when its bounds take
   under 30 s; their time is printed) at the banded 1M shape (matmat,
   k = 64) and the PageRank operator (matvec), each against the
   single-device engine at ``1e-5 + 1e-5 * |y|``, with every shard's width,
   padded plan elements, coalesce rate and kernel time beside the single
   plan's; a ``shard_fail`` drill (one shard recomputed by the reference
   executor, against the fault-free result); ``serve --spmv banded
   --spmv-rows 1000000 --batch 64 --requests 8 --mesh 1,1 --partition
   cost`` with and without ``--chaos 'shard_fail:after=1,count=1'``; and
   sharded CG (the host loop) on phase 6's CG matrix, converged within
   2 * tol true residual.

11. Generation with the model stack: (a) ``serve --arch llama3-8b --batch 8
   --prompt-len 512 --tokens 32`` in process at full width and depth (32
   layers, d_model 4096, GQA 32/8, d_ff 14336, vocab 128256, bf16; ~16 GB
   of seeded weights drawn on the card), `Runtime()` (the index
   embedding); (b) the same prompts through `generate` with
   ``Runtime(embed_backend="cuda")`` (the `coalesced_gather` kernel on the
   128256 x 4096 bf16 table: 8 KB rows, the TMA bulk path), in turns with
   the index embedding (index, cuda, cuda, index): every step's logits
   equal bitwise, the tokens equal serve's, 33 gather launches (1 prefill
   + 32 decode steps); the host ms of planning each step's ids and the
   kernel's ms; the kernel at the prefill stream (8 x 512 ids) beside its
   byte bound, its plain version and `torch.index_select`; torch.profiler
   over one decode step; (c) the prefill (one multi-token `decode_step`)
   of every prefix of 1 x 16 tokens against token-by-token decode, both
   through a float32 cache, within ``2e-2 + 2e-2 * |ref|`` (the paths
   differ only in layer 0's bf16 q/k/v projections; the f32 cache promotes
   the rest to float32); (d) every other family at full width, its depth
   cut to one repeating unit (printed on its line): logits finite, the
   prefill through `decode_step` against `forward` at the last position
   (within 2e-2 + 2e-2 * |ref| in bf16 for the attention families; zamba2
   and xlstm, whose two paths are the recurrent and the chunked scan, on a
   float32 copy within 1e-3 + 1e-3 * |ref|, the bf16 difference printed),
   and `dispatch_report` on the card for deepseek-v2-lite and
   llama4-maverick.
12. Training with the model stack (no kernel of the three runs here: the
   index embedding, and the cuda gather has no gradient): (a) `train()` in
   process on tinyllama-1.1b at full width and depth (22 layers, d_model
   2048, GQA 32/4, d_ff 5632, vocab 32000, bf16), batch 8 x 512 tokens,
   ``OptConfig(lr=1e-3, warmup_steps=5, total_steps=20)``, 20 steps, the
   update captured (`train`'s default on the card: the first step eager on
   a side stream, then one CUDA graph replayed a step): each
   step's loss, grad_norm and ms, tokens/s and the model-FLOP share
   ``6 * N_params * tokens/s / 989e12`` (bf16 dense peak) beside the card's
   power limit, peak device memory; gate: every loss and grad_norm finite,
   the last loss below the first by more than 0.3; then ``python -m
   repro_torch.launch.train --arch tinyllama-1.1b --steps 2 --batch 8 --seq
   512`` in process through its `main`; (b) the card against the CPU on a
   float32 copy at full width, 2 layers, batch 2 x 64, the same numpy
   parameters on both (`core.interop`): loss within ``1e-5 * |loss|``,
   every gradient leaf within ``1e-4 * max|g_cpu| + 1e-6`` (TF32 off); then
   one `make_update_fn` update at microbatches 2 and one with compression,
   the loss and the first moment held the same way (compression: at most
   0.1% of a leaf one int8 step apart, where a scaled gradient sits on a
   rounding tie); (c) (a)'s step with remat "full" and "dots" against
   "none": losses within 1e-6 relative, peak memory of each, "full" below
   "none"; (d) a checkpoint/restart drill at full width, one layer, bf16
   (~1.75 GB a checkpoint, under ``build/train-ckpt-<pid>``, removed at
   the end): `run_with_recovery` with ``ckpt_every=4`` over 8 steps, a
   failure raised once after step 5's update, final parameters against an
   uninterrupted run (bitwise where the step is deterministic on the card,
   else within 1e-6 relative: the case is printed), the seconds of a save
   and a restore, and the port's bf16 checkpoint restored byte for byte;
   then the same drill with the update captured (`train.loop.
   update_over_buffers`, warmed up and captured as `train` does it with
   `core.capture`), the restore copying into the captured buffers, its
   final state against the uninterrupted run; (e) the captured update
   against the same update eager from one state, in turns: (a)'s training
   10 steps each (every step's loss, grad norm and lr, then every parameter
   and moment, bitwise, else within (b)'s tolerances with the reason
   printed: whether eager repeats itself; the captured losses equal (a)'s
   first 10), step ms eager and a replay (medians), the first step's and
   the capture's ms, one replay under torch.profiler, the peak memory of
   each; then at (a)'s width, 2 layers, 3 steps: microbatches 2 with
   compression on, and remat "full" and "dots"; (g) C19:
   ``embed_backend="cuda"`` (and "auto") under autograd raises
   NotImplementedError on the card; "coalesced" and "index" give the same
   loss and embedding gradients within ``1e-6 * max|g|``; (f) every other
   family at full width with phase 11's cut takes three updates eager and
   three replays of its captured update (after the warm-up, the state put
   back to the seed's) from one state: every step's metrics and the final
   parameters and moments bitwise (the MoE combine adds in a fixed order,
   so deepseek's update repeats itself too); losses and parameters finite
   (llama4-maverick is left out: its one unit's parameters, gradients and
   moments need ~224 GB).
13. The sharded training step (no kernel of the three runs here either):
   (a) `train()` on a 1x1 NCCL process mesh (`launch.mesh.
   make_process_mesh`), tinyllama-1.1b at full width and depth with phase
   12 (a)'s seed, batch 8 x 512 and optimizer, 10 steps: every parameter
   and moment a DTensor placed by `sharding.rules.param_pspecs`; each
   step's loss within ``1e-5 * |loss|`` of phase 12 (a)'s at the same step
   (bitwise printed); step ms (median of steps 1-9; the sharded update
   stays eager, ROADMAP A4), tokens/s and peak device memory beside phase
   12 (e)'s eager step and (a)'s replay and peak, and what DTensor adds to
   a step;
   (b) on the host's CPU, ``python -m torch.distributed.run
   --nproc-per-node 4 -m repro_torch.launch.train --arch tinyllama-1.1b
   --reduced --mesh 2,2 --device cpu --steps 4``: four gloo ranks of the
   2x2 grid under the machine's torch, `repro`'s JSON printed once with
   finite losses.
14. The dry-run (`repro_torch.launch.dryrun`; nothing allocated on the
   card, no kernel launched): (a) every arch x applicable shape (32 cells)
   on a fake 16x16 world and the decode cells (decode_32k, long_500k) on
   2x16x16, one `run_cell` each with ``device="cuda"`` in 8 spawned
   processes, one line a cell (FLOPs, collective bytes, argument and temp
   bytes a device, the card's allocated bytes before and after and its
   peak, and each worker's peak over its first fake world and mesh); gate:
   every cell ``ok`` and the card's allocated bytes unchanged; (b)
   tinyllama-1.1b at phase 12 (a)'s 8 x 512 with its `Runtime()` on a fake
   1x1 world: argument bytes exactly those of phase 12 (a)'s parameters,
   optimizer state and batch, and FLOPs exactly the same counter's over the
   real unsharded step on the card (zeros); the predicted peak (arguments +
   temp) beside phase 12 (a)'s ``max_memory_allocated`` and the real
   step's, the forward + backward predicted under each remat beside
   phase 12 (c)'s peaks, with their ratios, and what the same step moves
   on a fake 16x16 world (a batch of 8 replicated over a data axis of 16),
   by collective site.
15. The four examples on the card, each's `main` as ``python -m
   repro_torch.examples.<name>`` calls it (in process): quickstart,
   spmv_pipeline, serve_decode and ``train_tinylm --steps 10`` (checkpoints
   under ``build/tinylm-ckpt-<pid>``, removed at the end); each returns,
   and their launches of `sell_spmv` and `coalesced_gather` join the
   kernels line. What went through a kernel is held to its plain version
   on the same inputs (tolerance TOL + TOL*|ref|): quickstart's SpMV
   errors against dense below TOL and its gather exact, spmv_pipeline's
   |A x|/|x| against the reference backend's power iteration,
   serve_decode's paged attention against the ``index`` gather's;
   train_tinylm's losses finite.
16. The hill-climb (`repro_torch.tools.hillclimb`; nothing allocated, no
   kernel launched): its 18 runs (phases 1-3 of its table: data-local MoE
   dispatch, ZeRO-1, remat, capacity, sequence-sharded attention, the EP
   constraint, FSDP, 2-D experts) at full size on the fake 16x16 world, in
   phase 14's worker processes (submitted when phase 14's cells are done,
   so they run beside phase 14 (b) and phase 15), each run's `show` line
   against phase 14's baseline of its cell; gate: every run ``ok``, the
   card's allocated bytes unchanged, no launch in its worker, and each run
   with a layout lever on
   (``seq_shard_attention``, ``moe_ep_constraint``) counting other
   temporaries or collective bytes than the same run without it, where the
   table (or phase 14's baseline) holds that run.

Every served path (the serve runs of phases 3 and 5-11; phase 3's matvec;
phase 11's first cuda-embedding run; phases 12 and 13's training; phase
14's dry-run and phase 16's hill-climb, which launch nothing; phase 15's
examples) is
driven with the launch counts set to 0 just before it and read just after;
the JSON line before the card line sums them per kernel (one entry
per kernel; `sell_spmv`'s times are at the solver shape whose served solves
launched it most). The launches of phase 6's extra solves, phase 7's checks
and timing runs, phase 9's measured searches and phase 10's engine runs and
sharded CG are printed apart and not summed. The seconds of each phase are
printed at the end. The last line is ``{"ok": true, "device": {...}}``.
Needs one CUDA device.
"""
import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
TOL = 1e-5
MAIN_ROWS = 1_000_000
MAIN_BATCH = 64
RANDOM_ROWS = 131_072
KS = (1, 7, 32, 33, 64, 65, 128, 200)
DEPTHS = (1, 2, 4)
KERNELS = {
    "sell_spmv": dict(
        source="src/repro_torch/kernels/csrc/sell_spmv.cu",
        replaces="src/repro/kernels/sell_spmv.py:472",
    ),
    "sell_spmm": dict(
        source="src/repro_torch/kernels/csrc/sell_spmm.cu",
        replaces="src/repro/kernels/sell_spmm.py:176",
    ),
    "coalesced_gather": dict(
        source="src/repro_torch/kernels/csrc/coalesced_gather.cu",
        replaces="src/repro/kernels/coalesced_gather.py:163",
    ),
}
# The paged path: llama3-8b's widths, vLLM's default page of 16 tokens.
PAGED_ARGV = ["--arch", "llama3-8b", "--paged", "--batch", "16",
              "--prompt-len", "1024", "--decode-steps", "16",
              "--page-block", "16"]
PAGED_BATCH, PAGED_PAGES, PAGE_ROW = 16, 65, 16 * 8 * 128
TOKEN_ROWS, TOKEN_DIM = 128256, 4096  # llama3-8b's vocabulary and width
GATHER_WINDOW = 256
# ptxas names the gather unit path's vector unit by its mangled type.
_GATHER_UNITS = {"5uint4": "16B", "5uint2": "8B", "j": "4B", "t": "2B",
                 "h": "1B"}
GATHER_PATHS = ("bulk", "unit")
# Row bytes at which phase 4 times both gather paths on aligned rows.
ALIGNED_ROW_BYTES = (64, 128, 256, 512, 1024, 2048, 4096, 8192)


def _phase(name):
    print(f"\n== {name}", flush=True)


def _max_err(got, want, tol=TOL):
    """Max |got - want|; raises when any element breaks the tolerance
    ``tol + tol * |want|``."""
    err = (got.float() - want.float()).abs()
    bad = err > tol + tol * want.float().abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{int(bad.sum())} elements beyond {tol:g} + {tol:g}*|ref| "
            f"(max abs err {float(err.max()):.3e})"
        )
    return float(err.max()) if err.numel() else 0.0


# Cycles of a spin kernel queued ahead of a timed run (~10 ms on an H100):
# the host enqueues the whole run meanwhile, so the events time the device,
# not the wrappers' host overhead between launches.
HEAD_START_CYCLES = 20_000_000


def _time_ms(fn, iters=20, warmup=3):
    """Device milliseconds a call, from CUDA events around `iters` calls
    queued behind a spin kernel (when the host is slower than the spin, the
    gaps count too)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(HEAD_START_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def environment_and_build():
    import torch

    from repro_torch.kernels import _build

    _phase("1. environment and build")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}")
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    t0 = time.perf_counter()
    _build.library()
    print(f"kernels built from {_build.CSRC.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.2f}s -> "
          f"{_build.library_dir().relative_to(ROOT)}")
    source = entry = None
    for line in _build.build_log().splitlines():
        m = re.search(
            r"sell_kernelI(f|13__nv_bfloat16)Lb([01])ELi(\d+)ELi(\d+)E", line)
        mg = re.search(
            r"gather_(bulk|unit)_kernelI(5uint4|5uint2|j|t|h)?Lb([01])", line)
        if line.startswith("== "):
            source = line[3:]
        elif "Compiling entry" in line and m:
            entry = (f"{source} sell_kernel<"
                     f"{'f32' if m.group(1) == 'f' else 'bf16'},"
                     f"{'packed' if m.group(2) == '1' else 'unpacked'},"
                     f"NC={m.group(3)},X {m.group(4)}B>")
        elif "Compiling entry" in line and mg:
            unit = (f"{_GATHER_UNITS[mg.group(2)]},"
                    if mg.group(1) == "unit" else "")
            entry = (f"{source} gather_{mg.group(1)}_kernel<{unit}"
                     f"{'packed' if mg.group(3) == '1' else 'unpacked'}>")
        elif "Used" in line and entry:
            print(f"  ptxas {entry}: {line.split(':', 1)[1].strip()}")
    return smi


def _plan(csr, device, packed):
    """(values f64 numpy (n_slices, W, H), DevicePlan) at the engine's
    default kernel geometry (cols_per_chunk 8, block_rows 8)."""
    from repro_torch.core.engine import cached_block_schedule
    from repro_torch.core.runtime import normalize_to_sell, pad_width
    from repro_torch.core.spmv import _sell_padded
    from repro_torch.kernels.sell_spmv import build_device_plan

    sell = normalize_to_sell(csr)
    ci, va, _ = _sell_padded(sell)
    ci, va, _ = pad_width(ci, va, multiple=8)
    sched, _ = cached_block_schedule(
        ci.reshape(-1), window=8 * sell.slice_height, block_rows=8,
        device=device,
    )
    del ci
    plans = {
        p: build_device_plan(sched, n_slices=sell.n_slices, cols_per_chunk=8,
                             slice_height=sell.slice_height, packed=p)
        for p in packed
    }
    return va, plans


def kernels_against_plain(device):
    import torch

    from repro_torch.core import matrices
    from repro_torch.core.engine import clear_schedule_cache
    from repro_torch.kernels.sell_spmm import sell_spmm_cuda, sell_spmm_plain
    from repro_torch.kernels.sell_spmv import sell_spmv_cuda, sell_spmv_plain

    _phase("2. kernels against their plain versions")
    worst = {name: 0.0 for name in KERNELS}
    families = {
        "banded": (matrices.banded(MAIN_ROWS, 24, 0.8),
                   np.random.default_rng(0)),
        "random": (matrices.random_uniform(RANDOM_ROWS, 16),
                   np.random.default_rng(1)),
    }
    for family, (gen, rng) in families.items():
        csr = gen(rng)
        va, plans = _plan(csr, device, (True, False))
        plan0 = plans[True]
        print(f"{family}: {csr.n_rows} rows, nnz={csr.nnz}, plan "
              f"{tuple(va.shape)}, max_warps={plan0.max_warps}")
        x = torch.as_tensor(
            rng.standard_normal(csr.n_cols).astype(np.float32), device=device)
        X = torch.as_tensor(
            rng.standard_normal((csr.n_cols, max(KS))).astype(np.float32),
            device=device)
        for dtype in (torch.float32, torch.bfloat16):
            values = torch.as_tensor(va).to(dtype).to(device)
            for packed, plan in plans.items():
                tag = (f"{family} {str(dtype).split('.')[-1]} "
                       f"{'packed' if packed else 'unpacked'}")
                want = sell_spmv_plain(None, values, x, plan=plan)
                errs = []
                for depth in DEPTHS:
                    y = sell_spmv_cuda(None, values, x, plan=plan,
                                       buffer_depth=depth)
                    torch.cuda.synchronize()
                    e = _max_err(y, want)
                    errs.append(f"d{depth}:{e:.1e}")
                    worst["sell_spmv"] = max(worst["sell_spmv"], e)
                print(f"  {tag}: sell_spmv {' '.join(errs)}")
                errs = []
                for k in KS:
                    Xk = X[:, :k]
                    want = sell_spmm_plain(None, values, Xk, plan=plan)
                    for depth in DEPTHS:
                        Y = sell_spmm_cuda(None, values, Xk, plan=plan,
                                           buffer_depth=depth)
                        torch.cuda.synchronize()
                        e = _max_err(Y, want)
                        worst["sell_spmm"] = max(worst["sell_spmm"], e)
                        errs.append(f"k{k}/d{depth}:{e:.1e}")
                    del want, Y
                print(f"  {tag}: sell_spmm {' '.join(errs)}")
            del values
        del va, plans, plan0, x, X
        clear_schedule_cache()
        torch.cuda.empty_cache()
    worst["coalesced_gather"] = gather_against_plain(device)
    print(f'kernels: {json.dumps(list(KERNELS))}')
    return worst


def _bytes_equal(got, want):
    """Bitwise equality (as bytes: -0.0 differs from 0.0, nan equals the
    same nan); raises otherwise."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(
            got.contiguous().view(-1).view(torch.uint8),
            want.contiguous().view(-1).view(torch.uint8)):
        raise AssertionError(
            f"gather differs bitwise: {tuple(got.shape)} {got.dtype} against "
            f"{tuple(want.shape)} {want.dtype}")


def paged_stream(batch, pages, shared):
    """The flattened page table of `batch` requests of `pages` pages each,
    the first `shared` of them common to all requests and the rest private
    (the static allocator when shared is 0)."""
    rows, nxt = [], shared
    for _ in range(batch):
        rows.append(np.concatenate([np.arange(shared),
                                    np.arange(nxt, nxt + pages - shared)]))
        nxt += pages - shared
    return np.concatenate(rows).astype(np.int32)


def gather_cases(device):
    """name -> (table on the card, index stream, block_rows): the cases
    (a)-(e) of phase 2, from fixed seeds."""
    import torch

    gen = torch.Generator(device=device).manual_seed(11)
    n_pages = PAGED_BATCH * PAGED_PAGES
    pool = torch.randn((n_pages, PAGE_ROW), generator=gen, device=device)
    rng = np.random.default_rng(12)
    tokens = torch.randn((TOKEN_ROWS, TOKEN_DIM), generator=gen,
                         device=device).to(torch.bfloat16)
    narrow = torch.randn((1001, 3), generator=gen, device=device).to(
        torch.bfloat16)
    special = torch.randn((200, 33), generator=gen, device=device)
    special[3, 1] = float("inf")
    special[7, 5] = -0.0
    special[9] = float("nan")
    special[11, ::2] = float("-inf")
    special[13] = -0.0
    ids_special = np.concatenate([rng.integers(0, 200, 400),
                                  np.repeat([3, 7, 9, 11, 13], 8)])
    rng.shuffle(ids_special)
    return {
        "a paged pool f32": (pool, paged_stream(PAGED_BATCH, PAGED_PAGES, 0),
                             1),
        "b shared prefix f32": (
            pool, paged_stream(PAGED_BATCH, PAGED_PAGES, 48), 1),
        "c token table bf16": (
            tokens, ((rng.zipf(1.1, 8192) - 1) % TOKEN_ROWS).astype(np.int32),
            8),
        "d narrow D=3 bf16": (narrow, rng.integers(0, 1001, 3000).astype(
            np.int32), 8),
        "e -0.0/inf/nan f32": (special, ids_special.astype(np.int32), 8),
    }


def gather_plans(idx, block_rows, device):
    """{packed: plan} of one index stream at the gather window."""
    from repro_torch.core.engine import cached_block_schedule
    from repro_torch.kernels.coalesced_gather import build_gather_plan

    sched, _ = cached_block_schedule(idx, window=GATHER_WINDOW,
                                     block_rows=block_rows, device=device)
    return {p: build_gather_plan(sched, packed=p) for p in (True, False)}


def gather_paths(table, out_ptr):
    """The kernel's paths a table can take (the bulk path needs 16-byte
    rows and bases), and the one `gather_launch_config` picks."""
    from repro_torch.kernels.coalesced_gather import auto_path, gather_unit

    row_bytes = table.shape[1] * table.element_size()
    unit = gather_unit(row_bytes, table.data_ptr(), out_ptr)
    return ((GATHER_PATHS if unit == 16 else ("unit",)),
            auto_path(row_bytes, unit), unit)


def gather_against_plain(device):
    import torch

    from repro_torch.core.coalescer import coalesce_stats
    from repro_torch.kernels.coalesced_gather import coalesced_gather_cuda, \
        coalesced_gather_plain

    worst = 0.0
    for name, (table, idx, br) in gather_cases(device).items():
        wide, rate = coalesce_stats(idx, window=GATHER_WINDOW, block_rows=br)
        want_ref = table[torch.as_tensor(idx, device=device).long()]
        paths, auto, unit = gather_paths(table, want_ref.data_ptr())
        for packed, plan in gather_plans(idx, br, device).items():
            kw = dict(window=GATHER_WINDOW, block_rows=br, plan=plan,
                      n_out=len(idx))
            want = coalesced_gather_plain(table, None, **kw)
            for path in paths:
                got = coalesced_gather_cuda(table, None, path=path, **kw)
                torch.cuda.synchronize()
                _bytes_equal(got, want)
                _bytes_equal(got, want_ref)
                if bool(torch.isfinite(want_ref).all()):
                    worst = max(worst, float(
                        (got.float() - want_ref.float()).abs().max()))
                del got
        print(f"  coalesced_gather {name}: table {tuple(table.shape)}, "
              f"{len(idx)} ids, block_rows {br}, max_warps "
              f"{plan.max_warps}, {wide} wide accesses (coalesce rate "
              f"{rate:.2f}), {unit}-byte units, paths {'/'.join(paths)} "
              f"(auto: {auto}): bitwise equal to the plain version and "
              f"table[idx], packed and unpacked, on every path")
    torch.cuda.empty_cache()
    return worst


def main_path(device, smi):
    import torch

    from repro_torch.core import matrices
    from repro_torch.core.engine import SpMVEngine, clear_engine_cache, \
        clear_schedule_cache, get_engine
    from repro_torch.core.formats import dense_to_csr
    from repro_torch.launch import serve

    _phase(f"3. main path: serve --spmv banded (in process) + matvec "
           f"({smi})")
    clear_engine_cache()
    clear_schedule_cache()
    argv = ["--spmv", "banded", "--spmv-rows", str(MAIN_ROWS), "--batch",
            str(MAIN_BATCH), "--requests", "8"]
    print("serve " + " ".join(argv))
    _reset_launches()
    out = serve.run(serve.build_parser().parse_args(argv))
    engine = out["engine"]
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(
        engine.n_cols).astype(np.float32), device=device)
    y = engine.matvec(x)
    torch.cuda.synchronize()
    launches = _read_launches()
    print(f"kernel launches on the main path: {launches}")
    for name in ("sell_spmv", "sell_spmm"):
        if launches[name] < 1:
            raise AssertionError(f"the main path never launched {name}")
    if engine.backend_resolved != "cuda":
        raise AssertionError(f"serve ran backend {engine.backend_resolved}")

    Y = out["y"]
    if tuple(Y.shape) != (engine.n_rows, MAIN_BATCH) or not bool(
            torch.isfinite(Y).all()):
        raise AssertionError(f"served batch has shape {tuple(Y.shape)} or "
                             f"non-finite values")
    ref = get_engine(out["csr"], backend="reference", device=device)
    B = torch.as_tensor(out["batch"], device=device)
    # the reference executor is per column; 8 columns at a time bounds memory
    Y_ref = torch.cat([ref.matmat(B[:, j:j + 8])
                       for j in range(0, MAIN_BATCH, 8)], dim=1)
    print(f"served batch vs reference backend: max abs err "
          f"{_max_err(Y, Y_ref):.3e}")
    print(f"matvec vs reference backend: max abs err "
          f"{_max_err(y, ref.matvec(x)):.3e}")
    small = matrices.banded(4096, 24, 0.8)(seed=3)
    Xs = np.random.default_rng(8).standard_normal((4096, 5))
    dense = np.zeros((4096, 4096))
    rows = np.repeat(np.arange(4096), np.diff(small.indptr))
    np.add.at(dense, (rows, small.indices), small.data)
    Ys = SpMVEngine(dense_to_csr(dense), device=device).matmat(
        Xs.astype(np.float32))
    err = float(np.abs(Ys.cpu().numpy() - dense @ Xs).max())
    print(f"small banded matmat vs float64 dense product: max abs err "
          f"{err:.3e} (tol 2e-4)")
    if not err <= 2e-4:
        raise AssertionError("small-matrix check failed")
    print(f"served: {out['spmv_per_s']:.1f} SpMV/s, {out['gflops']:.3f} "
          f"GFLOP/s ({out['seconds']:.3f}s for 8 batches x {MAIN_BATCH})")
    # One request split on the host clock: staging the numpy batch on the
    # card (packing it into pinned memory, then the copy), then the fused
    # kernel up to the finalize sync.
    stage_s, copy_ms, run_s = [], [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        staged = engine.stage(out["batch"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        engine.finalize(engine.dispatch(staged))
        stage_s.append(t1 - t0)
        copy_ms.append(staged.copy_ms())
        run_s.append(time.perf_counter() - t1)
    st, rn = np.median(stage_s) * 1e3, np.median(run_s) * 1e3
    print(f"one request (median of 5): stage {st:.3f} ms (pinned packing "
          f"and host->device copy of {out['batch'].nbytes} B; the copy "
          f"alone {np.median(copy_ms):.3f} ms on the device), "
          f"dispatch+finalize {rn:.3f} ms, the kernel's part "
          f"{rn / (st + rn) * 100:.1f}% of the request")
    return out, launches


def times(out, smi):
    import torch

    from repro_torch.kernels.sell_spmm import sell_spmm_cuda, sell_spmm_plain
    from repro_torch.kernels.sell_spmv import sell_spmv_cuda, sell_spmv_plain

    _phase(f"4. times at the main path's shapes ({smi})")
    engine, csr = out["engine"], out["csr"]
    dev = engine.device
    plan = engine.device_plan
    values = engine.plan_values(torch.float32)
    X = torch.as_tensor(out["batch"], device=dev)
    x = X[:, 0].contiguous()
    k = X.shape[1]
    kt = engine.k_tile
    A = torch.sparse_csr_tensor(
        torch.as_tensor(csr.indptr, dtype=torch.int64, device=dev),
        torch.as_tensor(csr.indices, dtype=torch.int64, device=dev),
        torch.as_tensor(csr.data, dtype=torch.float32, device=dev),
        size=(csr.n_rows, csr.n_cols),
    )
    # The bound counts what the matrix needs, not the plan's padding: each
    # nonzero's value and one 4-byte index word, the tags, the right-hand
    # side and the output once each, and 2 flops per nonzero and column.
    # The plan's own traffic (every padded element) is printed beside it.
    matrix_bytes = (csr.nnz * (values.element_size() + 4)
                    + plan.tags.numel() * 4)
    plan_bytes = (values.numel() * values.element_size()
                  + plan.elem_meta.numel() * 4 + plan.tags.numel() * 4)
    print(f"matrix: nnz {csr.nnz}, {matrix_bytes} B of values, indices and "
          f"tags; the plan's own traffic {plan_bytes} B "
          f"({values.numel()} padded elements)")
    depth = engine.buffer_depth
    tags = plan.tags
    real_slots = tags.shape[0] + int((tags[:, 1:] > tags[:, :-1]).sum())
    rows = {}
    for name, kernel, plain, library, rhs, kk in (
        ("sell_spmv", lambda d: sell_spmv_cuda(None, values, x, plan=plan,
                                               buffer_depth=d),
         lambda: sell_spmv_plain(None, values, x, plan=plan),
         lambda: torch.mv(A, x), x, 1),
        ("sell_spmm",
         lambda d: sell_spmm_cuda(None, values, X, plan=plan, k_tile=kt,
                                  buffer_depth=d),
         lambda: sell_spmm_plain(None, values, X, plan=plan, k_tile=kt),
         lambda: torch.sparse.mm(A, X), X, k),
    ):
        io_bytes = rhs.numel() * 4 + csr.n_rows * kk * 4
        nbytes = matrix_bytes + io_bytes
        flops = 2.0 * csr.nnz * kk
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOP_PER_S * 1e3
        # buffer_depth 1 and 2 in turns (1, 2, 2, 1), each the mean of two
        by_depth = {1: [], 2: []}
        for d in (1, 2, 2, 1):
            by_depth[d].append(_time_ms(lambda: kernel(d)))
        by_depth = {d: float(np.mean(t)) for d, t in by_depth.items()}
        rows[name] = dict(
            ms=by_depth[depth] if depth in by_depth else _time_ms(
                lambda: kernel(depth)),
            plain_ms=_time_ms(plain, iters=5),
            library_ms=_time_ms(library),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
        )
        r = rows[name]
        plan_ms = (plan_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
        # Every window stages each of its unique tags' block_rows rows of
        # kk columns (padding slots are skipped): read from L2, or HBM on a
        # miss, into shared memory once per launch.
        staged = real_slots * plan.block_rows * kk * 4
        print(f"{name}: kernel {r['ms']:.4f} ms at buffer_depth {depth} "
              f"(depth 1 {by_depth[1]:.4f} ms, depth 2 {by_depth[2]:.4f} "
              f"ms), plain {r['plain_ms']:.4f} ms, torch sparse CSR "
              f"{r['library_ms']:.4f} ms ({r['library_ms'] / r['ms']:.2f}x "
              f"the kernel's time), bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}: {nbytes} B, {flops:.3g} flop) -> "
              f"{r['bound_ms'] / r['ms'] * 100:.1f}% of the bound; the "
              f"plan's own bytes once {plan_ms:.4f} ms -> "
              f"{plan_ms / r['ms'] * 100:.1f}% of that floor; X bytes "
              f"staged a launch {staged} B")
    rows["coalesced_gather"] = gather_times(dev)
    return rows


def rows_read_by_design(idx, window=GATHER_WINDOW):
    """Rows the gather kernel reads: each distinct row of a window once."""
    return sum(len(np.unique(idx[i:i + window]))
               for i in range(0, len(idx), window))


def per_element_plan(idx, device):
    """A gather plan in which every element is a key of its own (its row as
    the tag of its own warp, block_rows 1): the kernel then reads each
    element's row once per element, as if it had no fan-out."""
    import torch

    from repro_torch.core.coalescer import BlockSchedule
    from repro_torch.kernels.coalesced_gather import build_gather_plan

    W = GATHER_WINDOW
    n_w = -(-len(idx) // W)
    tags = np.concatenate([idx, np.full(n_w * W - len(idx), idx[0])])
    cols = np.arange(n_w * W).reshape(n_w, W)

    def t(a, dtype=torch.int32):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return build_gather_plan(BlockSchedule(
        tags=t(tags.reshape(n_w, W)),
        n_warps=t(np.minimum(W, len(idx) - np.arange(n_w) * W)),
        elem_warp=t(cols % W), elem_offset=t(np.zeros_like(cols)),
        elem_valid=t(cols < len(idx), torch.bool), window=W, block_rows=1))


def gather_times(device):
    """Times of the gather at cases (a), (b) and (c) of phase 2 (packed
    plans), on the path the wrapper picks, on the unit path and through a
    plan of one key per element, then both paths on aligned rows;
    returns case (a)'s row."""
    import torch

    from repro_torch.kernels.coalesced_gather import coalesced_gather_cuda, \
        coalesced_gather_plain

    rows = {}
    for name, (table, idx, br) in gather_cases(device).items():
        if name[0] not in "abc":
            continue
        plan = gather_plans(idx, br, device)[True]
        kw = dict(window=GATHER_WINDOW, block_rows=br, plan=plan,
                  n_out=len(idx))
        idx_t = torch.as_tensor(idx, device=device).long()
        row_bytes = table.shape[1] * table.element_size()
        distinct = len(np.unique(idx))
        by_design = rows_read_by_design(idx)
        nbytes = (distinct + len(idx)) * row_bytes + (
            plan.elem_meta.numel() + plan.tags.numel()) * 4
        _, auto, _ = gather_paths(table, table.data_ptr())
        r = dict(
            ms=_time_ms(lambda: coalesced_gather_cuda(table, None, **kw)),
            plain_ms=_time_ms(lambda: coalesced_gather_plain(
                table, None, **kw), iters=5),
            library_ms=_time_ms(lambda: torch.index_select(table, 0, idx_t)),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        )
        unit_ms = _time_ms(lambda: coalesced_gather_cuda(
            table, None, path="unit", **kw))
        each = dict(kw, block_rows=1, plan=per_element_plan(idx, device))
        _bytes_equal(coalesced_gather_cuda(table, None, **each),
                     table[idx_t])
        each_ms = _time_ms(lambda: coalesced_gather_cuda(table, None, **each))
        design_ms = ((by_design + len(idx)) * row_bytes + (
            plan.elem_meta.numel() + plan.tags.numel()) * 4
        ) / HBM_BYTES_PER_S * 1e3
        print(f"coalesced_gather {name}: kernel {r['ms']:.4f} ms ({auto} "
              f"path; unit path {unit_ms:.4f} ms), plain "
              f"{r['plain_ms']:.4f} ms, torch.index_select "
              f"{r['library_ms']:.4f} ms ({r['library_ms'] / r['ms']:.2f}x "
              f"the kernel's time), bound {r['bound_ms']:.4f} ms (bytes: "
              f"{nbytes} B, {distinct} distinct rows of {row_bytes} B read, "
              f"{len(idx)} written, metadata and tags) -> "
              f"{r['bound_ms'] / r['ms'] * 100:.1f}% of the bound; rows the "
              f"kernel reads by design {by_design} (each distinct row of a "
              f"window once), those bytes once {design_ms:.4f} ms -> "
              f"{design_ms / r['ms'] * 100:.1f}%; one key per element "
              f"({len(idx)} rows read) {each_ms:.4f} ms, "
              f"{each_ms / r['ms']:.3f}x the kernel's time")
        if name[0] == "a":
            # the card's practical rate for the same bytes: one device copy
            # of the pool (every row read once and written once)
            dst = torch.empty_like(table)
            copy_ms = _time_ms(lambda: dst.copy_(table))
            print(f"  device copy of the pool ({2 * table.numel() * 4} B "
                  f"moved): {copy_ms:.4f} ms, the kernel "
                  f"{r['ms'] / copy_ms:.2f}x that")
            del dst
        rows[name[0]] = r
        if name[0] == "c":
            aligned_rows_both_paths(device, idx, br)
    torch.cuda.empty_cache()
    return rows["a"]


def aligned_rows_both_paths(device, idx, block_rows):
    """Both gather paths on 16-byte-aligned float32 rows of
    `ALIGNED_ROW_BYTES` through one index stream (case (c)'s)."""
    import torch

    from repro_torch.kernels.coalesced_gather import BULK_MIN_ROW_BYTES, \
        coalesced_gather_cuda

    plan = gather_plans(idx, block_rows, device)[True]
    kw = dict(window=GATHER_WINDOW, block_rows=block_rows, plan=plan,
              n_out=len(idx))
    gen = torch.Generator(device=device).manual_seed(13)
    cells = []
    for row_bytes in ALIGNED_ROW_BYTES:
        table = torch.randn((TOKEN_ROWS, row_bytes // 4), generator=gen,
                            device=device)
        want = table[torch.as_tensor(idx, device=device).long()]
        ms = {}
        for path in GATHER_PATHS:
            _bytes_equal(coalesced_gather_cuda(table, None, path=path, **kw),
                         want)
            ms[path] = _time_ms(lambda: coalesced_gather_cuda(
                table, None, path=path, **kw))
        cells.append(f"{row_bytes} B bulk {ms['bulk']:.4f} unit "
                     f"{ms['unit']:.4f}")
    print(f"  aligned f32 rows, (c)'s ids, ms by path (bulk from "
          f"{BULK_MIN_ROW_BYTES} B by default): " + "; ".join(cells))


def paged_path(device, smi):
    import torch

    from repro_torch.core.engine import clear_engine_cache, \
        clear_schedule_cache
    from repro_torch.core.gather_engine import clear_gather_engine_cache
    from repro_torch.launch import serve

    _phase(f"5. paged path: serve --arch llama3-8b --paged (in process; "
           f"{smi})")
    clear_engine_cache()
    clear_schedule_cache()
    clear_gather_engine_cache()
    torch.cuda.empty_cache()
    print("serve " + " ".join(PAGED_ARGV))
    torch.cuda.reset_peak_memory_stats(device)
    _reset_launches()
    out = serve.run(serve.build_parser().parse_args(PAGED_ARGV))
    launches = _read_launches()
    print(f"kernel launches on the paged path: {launches}")
    if launches["coalesced_gather"] < 1:
        raise AssertionError("the paged path never launched coalesced_gather")
    if not out["max_err"] <= 1e-5 or out["builds_warm"] != 0:
        raise AssertionError(f"paged serve: max_err {out['max_err']}, "
                             f"steady-state builds {out['builds_warm']}")
    cfg, cache = out["config"], out["caches"][0]
    shape = (PAGED_BATCH * PAGED_PAGES, 16, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    if (cfg.n_layers, cfg.n_heads) != (32, 32) or tuple(
            cache.k_pages.shape) != shape or not bool(
            torch.isfinite(cache.k_pages).all()):
        raise AssertionError(f"paged caches: {cfg.n_layers} layers, "
                             f"{tuple(cache.k_pages.shape)}")
    rep = out["reports"][0]
    print(f"paged: {out['tok_per_s']:.1f} tok/s over "
          f"{out['decode_s']:.3f}s of decode (prefill {out['prefill_s']:.3f}"
          f"s), parity {out['max_err']:.3e}, steady-state builds "
          f"{out['builds_warm']}, {rep['n_indices']} pages a layer in "
          f"{rep['n_windows']} windows, peak device memory "
          f"{torch.cuda.max_memory_allocated(device)} B")
    paged_step_breakdown(out, device)
    del out, cache
    torch.cuda.empty_cache()
    return launches


def paged_step_breakdown(out, device, repeats=3):
    """Where one decode step of the paged path goes, after the served run
    (the caches are full, so the step rewrites the last token): on the host
    clock, synchronised after each part, median of `repeats`; the gather
    kernel's own time in CUDA events; and, from torch.profiler over one
    step, the device's busy share and its time by kernel."""
    import torch

    from repro_torch.kernels.coalesced_gather import coalesced_gather_cuda
    from repro_torch.models.layers import _sdpa
    from repro_torch.models.paged_kv import _kv_engine, append_token, \
        gather_kv, paged_attention

    cfg = out["config"]
    L, B, H = cfg.n_layers, PAGED_BATCH, cfg.n_heads
    n_kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    caches = [dataclasses.replace(c, lengths=c.lengths - 1)
              for c in out["caches"]]
    S = caches[0].page_table.shape[1] * caches[0].block
    mask = torch.ones((B, 1, 1, S), dtype=torch.bool, device=device)
    rng = np.random.default_rng(99)
    dense = gather_kv(caches[0], backend="auto")
    q_all = None

    def draws():
        nonlocal q_all
        kv = torch.as_tensor(rng.standard_normal((L, 2, B, n_kv, hd)).astype(
            np.float32), device=device)
        q_all = torch.as_tensor(rng.standard_normal((L, B, 1, H, hd)).astype(
            np.float32), device=device)
        return kv

    def append(kv):
        for li in range(L):
            append_token(caches[li], kv[li, 0], kv[li, 1])

    def gathers():
        for li in range(L):
            gather_kv(caches[li], backend="auto")

    def attention():
        for li in range(L):
            paged_attention(q_all[li], caches[li], n_heads=H, backend="auto")

    def parity():
        for li in range(L):
            _sdpa(q_all[li], dense[0], dense[1], mask)

    def step():
        append(draws())
        attention()
        parity()

    def host_ms(fn, *args):
        times_ = []
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            times_.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times_))

    kv = draws()
    parts = {
        "host draws + copy to the card": host_ms(draws),
        "append_token x L": host_ms(append, kv),
        "gather_kv x L (2 gathers each)": host_ms(gathers),
        "paged_attention x L (gathers included)": host_ms(attention),
        "dense _sdpa x L (the parity reference)": host_ms(parity),
        "whole step": host_ms(step),
    }
    eng = _kv_engine(caches[0], backend="auto")
    plan, n = eng.device_plan, eng.n_indices
    tables = [c.k_pages.reshape(c.n_pages, -1) for c in caches]
    kernel_ms = _time_ms(lambda: [coalesced_gather_cuda(
        t, None, window=eng.window, block_rows=1, plan=plan, n_out=n)
        for t in tables], iters=5) * 2
    print(f"one decode step, host clock (median of {repeats}): " + "; ".join(
        f"{k} {v:.3f} ms" for k, v in parts.items()))
    print(f"  the gather kernel's own time: {kernel_ms:.3f} ms a step "
          f"({2 * L} launches), {kernel_ms / parts['whole step'] * 100:.1f}% "
          f"of the step")
    _profile_busy(step, "one step")


def _profile_busy(fn, what):
    """torch.profiler over one call of `fn`: the device's busy share of the
    wall time and its time by kernel. Returns what `fn` returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((evt.time_range.start, evt.time_range.end))
            by_name[evt.name] = by_name.get(evt.name, 0.0) + (
                evt.time_range.end - evt.time_range.start)
    if not spans:
        print("  device busy share: not measured (the profiler recorded no "
              "device events)")
        return out
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    top = sorted(by_name.items(), key=lambda kv_: -kv_[1])[:6]
    print(f"  torch.profiler over {what}: device busy {busy / 1e3:.3f} ms "
          f"of {wall_us / 1e3:.3f} ms wall ({busy / wall_us * 100:.1f}%), "
          f"{len(spans)} device events; by name (ms): " + "; ".join(
              f"{name[:60]} {t / 1e3:.3f}" for name, t in top))
    return out


def _reset_launches():
    from repro_torch.kernels.ops import KERNEL_WRAPPERS

    for wrapper in KERNEL_WRAPPERS.values():
        wrapper.launches = 0


def _read_launches():
    from repro_torch.kernels.ops import KERNEL_WRAPPERS

    return {name: w.launches for name, w in KERNEL_WRAPPERS.items()}


def _serve(argv):
    """`serve.run` in process with every launch count set to 0 just before;
    returns its result and the launches it made."""
    from repro_torch.launch import serve

    print("serve " + " ".join(argv), flush=True)
    _reset_launches()
    out = serve.run(serve.build_parser().parse_args(argv))
    return out, _read_launches()


def _fresh_caches():
    import torch

    from repro_torch.core.engine import clear_engine_cache, \
        clear_schedule_cache
    from repro_torch.core.gather_engine import clear_gather_engine_cache

    clear_engine_cache()
    clear_schedule_cache()
    clear_gather_engine_cache()
    torch.cuda.empty_cache()


def _csr_on_card(csr, device, dtype):
    import torch

    return torch.sparse_csr_tensor(
        torch.as_tensor(csr.indptr, dtype=torch.int64, device=device),
        torch.as_tensor(csr.indices, dtype=torch.int64, device=device),
        torch.as_tensor(csr.data, dtype=dtype, device=device),
        size=(csr.n_rows, csr.n_cols),
    )


def _solve_launch_check(name, results, launches):
    """Every matvec of the solves went through sell_spmv (graph replays
    counted), and nothing else launched it."""
    matvecs = sum(r.matvecs for r in results)
    print(f"{name}: sell_spmv launches {launches['sell_spmv']}, the solves' "
          f"own count of matvecs {matvecs} (per solve: "
          f"{[r.matvecs for r in results]}; iterations "
          f"{[r.iterations for r in results]})")
    if launches["sell_spmv"] != matvecs or matvecs < 1:
        raise AssertionError(f"{name}: {launches['sell_spmv']} sell_spmv "
                             f"launches for {matvecs} matvecs")


def _add(into, launches):
    for name, n in launches.items():
        into[name] = into.get(name, 0) + n


def solver_path(device, smi):
    """Phase 6: serve --solve cg and pagerank at 1,000,000 rows, their
    launches, true residuals, the graph loop against the python loop, and
    sell_spmv at both solvers' shapes. Returns the kernels-line row (the
    shape whose served solves launched sell_spmv most), the worst error,
    and the launches of the served solves and of the check and timing runs
    apart."""
    import torch

    from repro_torch.core import matrices, solvers
    from repro_torch.core.engine import get_engine
    from repro_torch.kernels.sell_spmv import sell_spmv_cuda, sell_spmv_plain

    _phase(f"6. solvers: serve --solve cg and pagerank at {MAIN_ROWS} rows "
           f"(in process; {smi})")
    _fresh_caches()
    served, checks, cases, served_spmv = {}, {}, {}, {}
    for solve, family in (("cg", "banded"), ("pagerank", "powerlaw")):
        out, launches = _serve(["--spmv", family, "--spmv-rows",
                                str(MAIN_ROWS), "--solve", solve,
                                "--requests", "2"])
        _add(served, launches)
        served_spmv[solve] = launches["sell_spmv"]
        runs = [out["cold"]] + out["warm"]
        _solve_launch_check(f"{solve} (cold + 2 warm)", runs, launches)
        op = out["csr"] if solve == "cg" else solvers.transition_matrix(
            out["csr"])
        eng = get_engine(op, device=device)
        print(f"{solve}: cold {out['cold'].iterations} iterations in "
              f"{out['cold_s']:.3f}s (schedule builds "
              f"{out['cold'].schedule_builds}), warm "
              f"{[r.iterations for r in out['warm']]} iterations, "
              f"{out['iters_per_s']:.1f} iters/s (schedule builds "
              f"{[r.schedule_builds for r in out['warm']]}), loop "
              f"{out['cold'].loop}")
        A64 = _csr_on_card(op, device, torch.float64)
        x64 = out["warm"][-1].x.double()
        if solve == "cg":
            b64 = torch.as_tensor(out["b"], device=device).double()
            true = float(torch.linalg.norm(b64 - torch.mv(A64, x64))
                         / torch.linalg.norm(b64))
            print(f"cg: true residual ||b - A x|| / ||b|| = {true:.3e} in "
                  f"float64 (tol {out['tol']:g})")
            if not true <= 2 * out["tol"]:
                raise AssertionError(f"cg true residual {true:.3e}")
        else:
            total = float(x64.sum())
            y = 0.85 * torch.mv(A64, x64)
            y = y + (1.0 - float(y.sum())) / op.n_rows
            fixed = float((y - x64).abs().sum())
            print(f"pagerank: sum(x) = {total!r}, float64 L1 distance of x "
                  f"from one more step {fixed:.3e} (tol {out['tol']:g})")
            if not abs(total - 1.0) <= 1e-5:
                raise AssertionError(f"pagerank x sums to {total!r}")
        # one more solve each way, launches counted per solve, and the host
        # time per iteration of each loop
        run = (lambda loop: solvers.cg(eng, out["b"], tol=out["tol"],
                                       loop=loop)) if solve == "cg" else (
            lambda loop: solvers.pagerank(eng, tol=out["tol"], loop=loop))
        per_iter, per_mv = {}, {}
        for loop in ("python", "while"):
            _reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run(loop)
            dt = time.perf_counter() - t0
            launches = _read_launches()
            _add(checks, launches)
            _solve_launch_check(f"{solve} loop={loop}", [res], launches)
            if loop == "python" and res.matvecs != res.iterations + (
                    solve == "cg"):
                raise AssertionError(f"{solve}: {res.matvecs} matvecs for "
                                     f"{res.iterations} iterations")
            per_iter[loop] = dt / res.iterations * 1e3
            per_mv[loop] = dt / res.matvecs * 1e3
        print(f"{solve}: host time per iteration (per matvec), loop=python "
              f"{per_iter['python']:.4f} ms ({per_mv['python']:.4f}), "
              f"loop=while (CUDA graph blocks of {solvers.WHILE_BLOCKS}) "
              f"{per_iter['while']:.4f} ms ({per_mv['while']:.4f}); "
              f"{res.matvecs} matvecs for {res.iterations} iterations")
        cases[solve] = (eng, op, out["b"])
        del out, A64, x64
    # while (graph) against python, bit for bit, on 131,072 rows
    for solve, family in (("cg", "banded"), ("pagerank", "powerlaw")):
        csr = (matrices.banded(RANDOM_ROWS, 24, 0.8) if family == "banded"
               else matrices.powerlaw(RANDOM_ROWS, 12))(seed=5)
        b = np.random.default_rng(6).standard_normal(RANDOM_ROWS).astype(
            np.float32)
        xs = {}
        for loop in ("python", "while", "while"):
            _reset_launches()
            res = (solvers.cg(matrices.make_spd(csr), b, loop=loop,
                              device=device) if solve == "cg" else
                   solvers.pagerank(csr, tol=1e-7, loop=loop, device=device))
            launches = _read_launches()
            _add(checks, launches)
            _solve_launch_check(f"{solve} {RANDOM_ROWS} rows loop={loop}",
                                [res], launches)
            if loop in xs and not torch.equal(xs[loop][0], res.x):
                raise AssertionError(f"{solve}: warm graph replay differs")
            xs.setdefault(loop, (res.x, res.iterations))
        same = torch.equal(xs["python"][0], xs["while"][0]) and (
            xs["python"][1] == xs["while"][1])
        print(f"{solve} at {RANDOM_ROWS} rows: loop=while (graph) and "
              f"loop=python bitwise equal: {same} ({xs['python'][1]} "
              f"iterations)")
        if not same:
            raise AssertionError(f"{solve}: graph and python loops differ")
    # sell_spmv at the two solvers' shapes; the kernels line takes the one
    # whose served solves launched it most
    rows = {}
    for solve, (eng, op, b) in cases.items():
        plan, values = eng.device_plan, eng.plan_values(torch.float32)
        x = torch.as_tensor(b, device=device) if solve == "cg" else \
            torch.full((op.n_rows,), 1.0 / op.n_rows, device=device)
        A = _csr_on_card(op, device, torch.float32)
        want = sell_spmv_plain(None, values, x, plan=plan)
        err = _max_err(sell_spmv_cuda(None, values, x, plan=plan), want)
        nbytes = op.nnz * 8 + plan.tags.numel() * 4 + 2 * op.n_rows * 4
        flops = 2.0 * op.nnz
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOP_PER_S * 1e3
        row = dict(
            ms=_time_ms(lambda: sell_spmv_cuda(None, values, x, plan=plan)),
            plain_ms=_time_ms(lambda: sell_spmv_plain(None, values, x,
                                                      plan=plan), iters=5),
            library_ms=_time_ms(lambda: torch.mv(A, x)),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
        )
        widths = np.asarray(eng.sell.slice_widths)
        print(f"sell_spmv at the {solve} shape ({op.n_rows} rows, nnz "
              f"{op.nnz}, plan {tuple(values.shape)}, slice widths max "
              f"{int(widths.max())} / mean {widths.mean():.1f}, max_warps "
              f"{plan.max_warps}): kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, torch.mv on sparse CSR "
              f"{row['library_ms']:.4f} ms ({row['library_ms'] / row['ms']:.2f}"
              f"x the kernel's time), bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}: {nbytes} B, {flops:.3g} flop) -> "
              f"{row['bound_ms'] / row['ms'] * 100:.1f}% of the bound; max "
              f"abs err against plain {err:.3e}")
        rows[solve] = (row, err)
        del A, want
    top = max(served_spmv, key=served_spmv.get)
    print(f"kernels line: sell_spmv at the {top} shape, which the served "
          f"solves launched it at most (launches by solve {served_spmv})")
    err = max(e for _, e in rows.values())
    _fresh_caches()
    return rows[top][0], err, served, checks


def _at_once(copies, kernels):
    """Time (in the intervals' unit) during which a copy and a kernel ran
    at once; copies never overlap each other (one copy stream), nor do
    kernels (one compute stream)."""
    return sum(max(0.0, min(a1, b1) - max(a0, b0))
               for a0, a1 in copies for b0, b1 in kernels)


def _overlap(prof):
    """From a torch.profiler trace: host-to-device copy intervals and SELL
    kernel intervals (microseconds), and every device event's name."""
    import torch

    copies, kernels, names = [], [], []
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        names.append(evt.name)
        span = (evt.time_range.start, evt.time_range.end)
        if "HtoD" in evt.name:
            copies.append(span)
        elif "sell_kernel" in evt.name:
            kernels.append(span)
    return copies, kernels, names


def stream_path(device, smi):
    """Phase 7: serve --stream at 1,000,000 rows, parity with sync and with
    the plain version, SpMV/s streamed and sync, a depth=1 control, the
    staging split, and a profiler window over two requests. Returns the
    launches of the served run and of the check and timing runs apart."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.runtime import StreamingExecutor, \
        microbatch_slices
    from repro_torch.kernels.sell_spmm import sell_spmm_plain

    _phase(f"7. streaming: serve --spmv banded --stream at {MAIN_ROWS} rows "
           f"(in process; {smi})")
    _fresh_caches()
    out, launches = _serve(["--spmv", "banded", "--spmv-rows", str(MAIN_ROWS),
                            "--batch", str(MAIN_BATCH), "--requests", "8",
                            "--stream", "depth=2,microbatch=32"])
    engine = out["engine"]
    if launches["sell_spmm"] < 1:
        raise AssertionError("the stream path never launched sell_spmm")
    _reset_launches()
    errs = [_max_err(out["y_stream"], out["y"])]
    for B, got in zip(out["batches"], out["stream_outs"]):
        errs.append(_max_err(got, engine.matmat(B)))
    print(f"stream parity against sync (every batch, 1e-5 + 1e-5*|y|): max "
          f"abs err {max(errs):.3e}")
    # each streamed micro-batch (k = 32) against the kernel's plain version
    # on the same plan
    plan, values = engine.device_plan, engine.plan_values(torch.float32)
    errs = []
    for B, got in zip(out["batches"], out["stream_outs"]):
        Bd = torch.as_tensor(B, device=device)
        for sl in microbatch_slices(MAIN_BATCH, 32):
            want = sell_spmm_plain(None, values, Bd[:, sl].contiguous(),
                                   plan=plan, k_tile=engine.k_tile)
            errs.append(_max_err(got[:, sl], want))
        del Bd, want
    print(f"stream against sell_spmm_plain ({len(errs)} micro-batches of 32 "
          f"columns, 1e-5 + 1e-5*|y|): max abs err {max(errs):.3e}")
    del values
    st = out["staging"]
    n_mb = st["microbatches"]
    print(f"served sync {out['spmv_per_s']:.1f} SpMV/s, streamed "
          f"{out['stream_spmv_per_s']:.1f} SpMV/s (depth 2, microbatch 32); "
          f"the model predicted x{out['stream_pred']['speedup']:.3f} "
          f"({out['stream_pred']['bottleneck']}-bound); staging {n_mb} "
          f"micro-batches of {engine.n_cols * 32 * 4} B: host packing "
          f"{st['pack_s'] * 1e3 / n_mb:.3f} ms and host-to-device copy "
          f"{st['copy_ms'] / n_mb:.3f} ms (device) a micro-batch")

    def streamed(depth, batches):
        streamer = StreamingExecutor(engine, microbatch=32, depth=depth)
        streamer.matmat(batches[0][:, :32])  # the ring, outside the timing
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for B in batches:
            streamer.submit(B)
        outs = streamer.drain()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not outs.ok:
            raise AssertionError(f"stream failures: {outs.failures}")
        return len(batches) * MAIN_BATCH / dt, streamer.staging

    rates = {1: [], 2: []}
    for depth in (1, 2, 2, 1):
        rates[depth].append(streamed(depth, out["batches"])[0])
    print(f"depth control, same batches, in turns 1,2,2,1: depth 1 "
          f"{np.mean(rates[1]):.1f} SpMV/s ({rates[1][0]:.1f}, "
          f"{rates[1][1]:.1f}), depth 2 {np.mean(rates[2]):.1f} SpMV/s "
          f"({rates[2][0]:.1f}, {rates[2][1]:.1f})")
    streamer = StreamingExecutor(engine, microbatch=32, depth=2)
    streamer.matmat(out["batches"][0][:, :32])
    torch.cuda.synchronize()
    # The same window in CUDA events: each micro-batch's copy on the copy
    # stream (its own timed events), and its kernel between the events
    # recorded around `dispatch` on the compute stream (it starts no
    # earlier than its copy's end).
    marks = []
    real_dispatch = engine.dispatch

    def timed_dispatch(staged):
        before = torch.cuda.Event(enable_timing=True)
        before.record()
        pending = real_dispatch(staged)
        after = torch.cuda.Event(enable_timing=True)
        after.record()
        marks.append((staged, before, after))
        return pending

    engine.dispatch = timed_dispatch
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ref = torch.cuda.Event(enable_timing=True)
            ref.record()
            t0 = time.perf_counter()
            for B in out["batches"][:2]:
                streamer.submit(B)
            streamer.drain()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        del engine.dispatch
    checks = _read_launches()
    ev_copies = [(ref.elapsed_time(st.copy_start), ref.elapsed_time(st.copied))
                 for st, _, _ in marks]
    ev_kernels = [(max(ref.elapsed_time(b), ref.elapsed_time(st.copied)),
                   ref.elapsed_time(a)) for st, b, a in marks]
    print(f"window over two requests ({wall_ms:.3f} ms wall), CUDA events: "
          f"{len(ev_copies)} host-to-device copies busy "
          f"{sum(b - a for a, b in ev_copies):.3f} ms, {len(ev_kernels)} "
          f"sell_spmm launches busy {sum(b - a for a, b in ev_kernels):.3f} "
          f"ms, copy and kernel at once "
          f"{_at_once(ev_copies, ev_kernels):.3f} ms; intervals (ms from "
          f"the window's start) copies "
          + " ".join(f"[{a:.2f},{b:.2f}]" for a, b in ev_copies)
          + " kernels "
          + " ".join(f"[{a:.2f},{b:.2f}]" for a, b in ev_kernels))
    copies, kernels, names = _overlap(prof)
    if not copies or not kernels:
        print(f"  torch.profiler, same window: not measured ({len(names)} "
              f"device events, {len(copies)} copies, {len(kernels)} SELL "
              f"kernels; names {sorted(set(names))[:4]})")
    else:
        print(f"  torch.profiler, same window: {len(copies)} host-to-device "
              f"copies busy {sum(b - a for a, b in copies) / 1e3:.3f} ms, "
              f"{len(kernels)} sell_spmm launches busy "
              f"{sum(b - a for a, b in kernels) / 1e3:.3f} ms, copy and "
              f"kernel at once {_at_once(copies, kernels) / 1e3:.3f} ms")
    del out
    _fresh_caches()
    return launches, checks


def store_and_chaos(device, smi):
    """Phase 8: the banded serve at 131,072 rows cold into a plan store
    under build/ and warm from it (zero builds), the 1M schedule alone
    built, built and saved, and loaded, then the chaos drills of the stream
    path and the paged path; the store is removed at the end."""
    import shutil

    import torch

    from repro_torch.core.engine import SpMVEngine, _sell_content_digest
    from repro_torch.core.runtime import normalize_to_sell

    _phase(f"8. plan store and chaos ({smi})")
    store = ROOT / "build" / f"plan-store-{os.getpid()}"
    totals = {}

    def serve_counted(argv):
        out, launches = _serve(argv)
        for name, n in launches.items():
            totals[name] = totals.get(name, 0) + n
        return out

    try:
        argv = ["--spmv", "banded", "--spmv-rows", str(RANDOM_ROWS),
                "--batch", str(MAIN_BATCH), "--requests", "8",
                "--schedule-cache", str(store / "main")]
        _fresh_caches()
        cold = serve_counted(argv)
        files = sorted((store / "main").glob("*.npz"))
        if cold["cache_stats"]["built"] != 1 or len(files) != 1:
            raise AssertionError(f"cold store run: {cold['cache_stats']}, "
                                 f"{len(files)} files")
        y_cold, cold_s = cold["y"], cold["plan_s"]
        del cold
        _fresh_caches()
        warm = serve_counted(argv + ["--assert-warm-cache"])
        err = _max_err(warm["y"], y_cold)
        print(f"plan store: {files[0].name}, {files[0].stat().st_size} B on "
              f"disk; plan seconds cold {cold_s:.3f} (build and save), warm "
              f"{warm['plan_s']:.3f} (load, {warm['cache_stats']['built']} "
              f"builds, {warm['cache_stats']['disk_hits']} disk hit); warm "
              f"batch against cold: max abs err {err:.3e}")
        del warm, y_cold
        # serve's "planned in" holds the plan report too: the schedule
        # alone, built, built and saved, and loaded (matrix and digests
        # ready beforehand)
        sell = normalize_to_sell(_banded_main())
        _sell_content_digest(sell)
        sched_s = {}
        for label, cache_dir in (("built", None),
                                 ("built and saved", store / "solo"),
                                 ("loaded", store / "solo")):
            _fresh_caches()
            eng = SpMVEngine(sell, device=device, cache_dir=cache_dir and
                             str(cache_dir))
            eng._ensure_plan()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.schedule
            torch.cuda.synchronize()
            sched_s[label] = time.perf_counter() - t0
        del eng, sell
        print("schedule alone, seconds: " + ", ".join(
            f"{k} {v:.3f}" for k, v in sched_s.items()))
        # the stream path under chaos, on a plan file made fault-free first
        chaos = ("store_read:rate=1,count=1;store_write:count=1;"
                 "dispatch_timeout:after=1,count=1")
        argv = ["--spmv", "banded", "--spmv-rows", str(RANDOM_ROWS),
                "--batch", str(MAIN_BATCH), "--requests", "4", "--stream",
                "depth=2,microbatch=32", "--schedule-cache",
                str(store / "stream")]
        _fresh_caches()
        serve_counted(argv)
        _fresh_caches()
        out = serve_counted(argv + ["--chaos", chaos])
        _chaos_check("stream", out)
        _max_err(out["y_stream"], out["y"])
        del out
        _fresh_caches()
        out = serve_counted(PAGED_ARGV[:5] + [
            "--prompt-len", "128", "--decode-steps", "2", "--page-block",
            "16", "--schedule-cache", str(store / "paged"), "--chaos",
            "store_read:rate=1,count=1"])
        _chaos_check("paged", out)
        if out["store_drill"] != "quarantined + re-persisted":
            raise AssertionError(f"paged drill: {out['store_drill']}")
        del out
    finally:
        shutil.rmtree(store, ignore_errors=True)
        _fresh_caches()
    return totals


def _chaos_check(name, out):
    rep = out["chaos"]
    print(f"chaos drill ({name}): injected {rep['injected']}, recovered "
          f"{rep['recovered']}, unrecovered {rep['unrecovered']}; by site "
          + ", ".join(f"{site} {v['injected']}/{v['recovered']}"
                      for site, v in sorted(rep["sites"].items())))
    if rep["injected"] < 1 or rep["unrecovered"]:
        raise AssertionError(f"chaos drill ({name}): {rep}")


# Phase 9's measured searches: PageRank's operator (k = 1, sell_spmv) over
# cols_per_chunk x block_rows x buffer_depth, the banded matrix (k = 64,
# sell_spmm) over the 9 (cols_per_chunk, block_rows) pairs at depth 2.
TUNE_SPACE_PAGERANK = {"cols_per_chunk": (4, 8, 16), "block_rows": (4, 8, 16),
                       "buffer_depth": (1, 2, 4), "k_tile": (8,),
                       "packed": (1,), "value_dtype": ("native",)}
TUNE_SPACE_BANDED = dict(TUNE_SPACE_PAGERANK, buffer_depth=(2,))
DEFAULT_GEOMETRY = (8, 8, 2)  # the engine's cols_per_chunk, block_rows, depth
SHARDS = 4
COST2D_LIMIT_S = 30.0


def _geometry(cand):
    return (cand["cols_per_chunk"], cand["block_rows"], cand["buffer_depth"])


@functools.lru_cache(maxsize=None)
def _pagerank_operator():
    from repro_torch.core import matrices, solvers

    return solvers.transition_matrix(matrices.powerlaw(MAIN_ROWS, 12)(seed=0))


@functools.lru_cache(maxsize=None)
def _banded_main():
    from repro_torch.core import matrices

    return matrices.banded(MAIN_ROWS, 24, 0.8)(np.random.default_rng(0))


def _measured_search(name, csr, k, space, device):
    """`get_tuned_engine(mode="measure")` over `space`; prints every
    candidate's time, the infeasible ones and the winner beside the
    engine's default geometry, and holds the winner's engine against the
    kernel's plain version. Returns the worst error."""
    import torch

    from repro_torch.core import tune
    from repro_torch.core.runtime import normalize_to_sell
    from repro_torch.kernels.sell_spmm import sell_spmm_plain
    from repro_torch.kernels.sell_spmv import sell_spmv_plain

    sell = normalize_to_sell(csr)
    cands = tune._candidates(tune._normalize_space(space))
    need = sum(tune.candidate_device_bytes(sell, c, with_schedule=True)
               for c in cands)
    free, total = torch.cuda.mem_get_info(device)
    log, rounds = [], 3
    t0 = time.perf_counter()
    eng, plan = tune.get_tuned_engine(sell, k=k, mode="measure", space=space,
                                      rounds=rounds, device=device,
                                      trial_log=log)
    search_s = time.perf_counter() - t0
    groups = max(t.group for t in log) + 1
    print(f"{name} (k = {k}): {len(cands)} candidates, device bytes bound "
          f"{need} B together against {free} B free of {total}; measured in "
          f"{groups} group(s) in {search_s:.1f}s ({plan.trials} timed calls, "
          f"CUDA events, best of {rounds} interleaved rounds)")
    by_geometry = {}
    for t in sorted(log, key=lambda t: t.us):
        g = _geometry(t.candidate)
        by_geometry[g] = t
        print(f"  cols_per_chunk {g[0]:2d} block_rows {g[1]:2d} buffer_depth "
              f"{g[2]}: " + (f"{t.us / 1e3:.4f} ms (group {t.group})"
                             if t.error is None else
                             f"infeasible ({t.error[:80]})"))
    infeasible = [_geometry(t.candidate) for t in log if t.error is not None]
    default = by_geometry[DEFAULT_GEOMETRY]
    print(f"{name}: winner {_geometry(dataclasses.asdict(plan))} "
          f"{plan.cost / 1e3:.4f} ms against the default "
          f"{DEFAULT_GEOMETRY} {default.us / 1e3:.4f} ms "
          f"(x{default.us / plan.cost:.3f}); infeasible "
          f"{infeasible or 'none'}")
    values = eng.plan_values(torch.float32)
    rhs = torch.as_tensor(np.random.default_rng(17).standard_normal(
        (sell.n_cols, k)).astype(np.float32), device=device)
    kw = _kernel_kw(eng)
    if k == 1:
        got = eng.matvec(rhs[:, 0])
        want = sell_spmv_plain(None, values, rhs[:, 0], **kw)
    else:
        got = eng.matmat(rhs)
        want = sell_spmm_plain(None, values, rhs, k_tile=eng.k_tile, **kw)
    err = _max_err(got, want[:sell.n_rows])
    print(f"{name}: the tuned engine ({eng.backend_resolved}, "
          f"cols_per_chunk {eng.cols_per_chunk}, block_rows "
          f"{eng.block_rows}, buffer_depth {eng.buffer_depth}) against "
          f"{'sell_spmv_plain' if k == 1 else 'sell_spmm_plain'}: max abs "
          f"err {err:.3e}")
    return err


def tuner_path(device, smi):
    """Phase 9: serve --tune model cold and warm into a tune store under
    build/ (removed at the end), then measured searches at the PageRank and
    banded 1M shapes. Returns the launches of the serve runs and of the
    searches and checks apart, and each kernel's worst error against its
    plain version."""
    import shutil

    from repro_torch.core import tune

    _phase(f"9. tuner: serve --tune model, measured searches ({smi})")
    store = ROOT / "build" / f"tune-store-{os.getpid()}"
    served, checks = {}, {}
    try:
        argv = ["--spmv", "banded", "--spmv-rows", str(RANDOM_ROWS),
                "--batch", str(MAIN_BATCH), "--tune", "model",
                "--tune-cache", str(store)]
        runs = []
        for label in ("cold", "warm"):
            _fresh_caches()
            tune.clear_tune_cache()  # what a new process starts with
            out, launches = _serve(argv)
            _add(served, launches)
            runs.append(out)
            t = out["tuned"]
            print(f"tune {label}: {t.trials} trials, source {t.source}, "
                  f"{out['tune_s']:.3f}s; winner cols_per_chunk "
                  f"{t.cols_per_chunk} block_rows {t.block_rows} k_tile "
                  f"{t.k_tile} packed {t.packed} buffer_depth "
                  f"{t.buffer_depth} value_dtype {t.value_dtype}; "
                  f"sell_spmm launches {launches['sell_spmm']}")
        cold, warm = (r["tuned"] for r in runs)
        files = sorted(store.glob("tune-*.json"))
        # the default space with k_tile, which the kernels do not have, cut
        # to one value
        n_cand = int(np.prod([len(v) for v in tune.DEFAULT_SPACE.values()])
                     ) // len(tune.DEFAULT_SPACE["k_tile"])
        if (cold.trials, cold.source) != (n_cand, "search") or (
                warm.trials, warm.source) != (0, "disk") or len(files) != 1:
            raise AssertionError(f"tune store: cold {cold}, warm {warm}, "
                                 f"{len(files)} files")
        if dataclasses.replace(warm, trials=0, source="") != \
                dataclasses.replace(cold, trials=0, source=""):
            raise AssertionError(f"warm winner {warm} differs from {cold}")
        err = _max_err(runs[1]["y"], runs[0]["y"])
        print(f"warm served batch against cold: max abs err {err:.3e}; model "
              f"mode at {RANDOM_ROWS} rows {runs[0]['tune_s'] / n_cand * 1e3:.1f}"
              f" ms of host numpy a candidate")
        del runs
        _fresh_caches()
        worst = {}
        for name, kernel, csr, k, space in (
                ("pagerank operator", "sell_spmv", _pagerank_operator(), 1,
                 TUNE_SPACE_PAGERANK),
                ("banded", "sell_spmm", _banded_main(), MAIN_BATCH,
                 TUNE_SPACE_BANDED)):
            tune.clear_tune_cache()
            _reset_launches()
            worst[kernel] = _measured_search(name, csr, k, space, device)
            _add(checks, _read_launches())
            del csr
            _fresh_caches()
    finally:
        shutil.rmtree(store, ignore_errors=True)
        _fresh_caches()
    return served, checks, worst


def _kernel_kw(eng):
    """The plan and geometry an engine launches its kernels with."""
    return dict(plan=eng.device_plan, cols_per_chunk=eng.cols_per_chunk,
                block_rows=eng.block_rows, buffer_depth=eng.buffer_depth)


def _kernel_call(eng, rhs):
    """The engine's own kernel on a right-hand side already on the card
    (what `matvec`/`matmat` launch, without the staging)."""
    import torch

    from repro_torch.kernels import ops

    values = eng.plan_values(torch.float32)
    kw = _kernel_kw(eng)
    if rhs.dim() == 1:
        return lambda: ops.sell_spmv(None, values, rhs, **kw)
    return lambda: ops.sell_spmm(None, values, rhs, k_tile=eng.k_tile, **kw)


def _plan_line(eng):
    """Width, padded plan elements, wide accesses and coalesce rate of an
    engine's plan (the rate over its padded stream, as `plan_report`)."""
    import torch

    sched = eng.schedule
    elems = eng.plan_values(torch.float32).numel()
    wide = int(sched.n_warps.sum())
    return (int(np.max(eng.sell.slice_widths)), elems, wide,
            elems / (wide * eng.block_rows))


def sharded_path(device, smi):
    """Phase 10: ShardedSpMVEngine with 4 shards on one card for each
    partition at the banded (matmat, k = 64) and PageRank (matvec) 1M
    shapes against the single-device engine, per-shard plans and kernel
    times, a shard_fail drill, serve --mesh 1,1 with and without chaos, and
    sharded CG. Returns the serve runs' launches and the checks' launches.
    (Every comparison here is kernel against kernel or against the
    reference executor, so none enters the kernels line's errors.)"""
    import torch

    from repro_torch.core import matrices, solvers
    from repro_torch.core.dist import ShardedSpMVEngine
    from repro_torch.core.engine import SpMVEngine
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.partition import shard_bounds
    from repro_torch.core.runtime import normalize_to_sell
    from repro_torch.launch.mesh import parse_mesh_spec

    _phase(f"10. sharded engine: {SHARDS} shards on one card, serve --mesh "
           f"({smi})")
    mesh = parse_mesh_spec("1,1")
    served, checks = {}, {}
    banded_single = None
    for name, csr, k in (("banded", _banded_main(), MAIN_BATCH),
                         ("pagerank operator", _pagerank_operator(), 1)):
        _fresh_caches()
        sell = normalize_to_sell(csr)
        del csr
        rng = np.random.default_rng(19)
        rhs = torch.as_tensor(rng.standard_normal(
            (sell.n_cols, k)).astype(np.float32), device=device)
        if k == 1:
            rhs = rhs[:, 0].contiguous()
        single = SpMVEngine(sell, device=device)
        call = single.matvec if k == 1 else single.matmat
        want = call(rhs)
        w, elems, wide, rate = _plan_line(single)
        single_ms = _time_ms(_kernel_call(single, rhs))
        whole_ms = _time_ms(lambda: call(rhs))
        print(f"{name} single device: width {w}, padded plan elements "
              f"{elems}, wide accesses {wide}, coalesce rate {rate:.2f}, "
              f"kernel {single_ms:.4f} ms, {'matvec' if k == 1 else 'matmat'}"
              f" {whole_ms:.4f} ms")
        strategies = ["even", "nnz", "cost"]
        t0 = time.perf_counter()
        shard_bounds(sell, SHARDS, partition="cost2d")
        cost2d_s = time.perf_counter() - t0
        if cost2d_s < COST2D_LIMIT_S:
            strategies.append("cost2d")
        ran = "run" if cost2d_s < COST2D_LIMIT_S else "not run"
        print(f"{name}: cost2d bounds at {sell.n_rows} rows in "
              f"{cost2d_s:.2f}s ({ran}, limit {COST2D_LIMIT_S:.0f}s)")
        for strategy in strategies:
            t0 = time.perf_counter()
            eng = ShardedSpMVEngine(sell, mesh=mesh, n_shards=SHARDS,
                                    partition=strategy)
            _reset_launches()
            got = eng.matvec(rhs) if k == 1 else eng.matmat(rhs)
            torch.cuda.synchronize()
            launches = _read_launches()
            _add(checks, launches)
            built_s = time.perf_counter() - t0
            kernel = "sell_spmv" if k == 1 else "sell_spmm"
            if launches[kernel] != SHARDS:
                raise AssertionError(f"{strategy}: {launches}")
            err = _max_err(got, want)
            sharded_ms = _time_ms(lambda: eng.matvec(rhs) if k == 1
                                  else eng.matmat(rhs))
            lines, kernel_sum, padded = [], 0.0, 0
            for i, shard_eng in enumerate(eng.engines):
                sw, se, swide, srate = _plan_line(shard_eng)
                ms = _time_ms(_kernel_call(shard_eng, rhs))
                kernel_sum += ms
                padded += se
                lo, hi = eng.row_ranges[i]
                lines.append(f"    shard {i}: rows [{lo}, {hi}) width {sw}, "
                             f"padded plan elements {se}, coalesce rate "
                             f"{srate:.2f}, kernel {ms:.4f} ms")
            print(f"{name} {strategy}: {SHARDS} shards planned and run in "
                  f"{built_s:.1f}s; against single device max abs err "
                  f"{err:.3e}; padded plan elements {padded} ("
                  f"{padded / elems:.3f}x the single plan's), shard kernels "
                  f"{kernel_sum:.4f} ms summed (single {single_ms:.4f}), "
                  f"sharded {'matvec' if k == 1 else 'matmat'} "
                  f"{sharded_ms:.4f} ms (single {whole_ms:.4f}); imbalance "
                  f"of the cost model "
                  f"{eng.partition_info['cost_imbalance']:.3f}")
            print("\n".join(lines))
            if strategy == "cost" and k > 1:
                # degraded mode on the card: shard 1 recomputed by the
                # reference executor
                with FaultPlan("shard_fail:after=1,count=1") as plan:
                    rec = eng.matmat(rhs)
                rep = plan.report()
                err = _max_err(rec, got)
                print(f"{name} {strategy}: shard_fail drill injected "
                      f"{rep['injected']}, recovered {rep['recovered']} "
                      f"({eng.recovery_report()['events'][0]['mode']}); "
                      f"against the fault-free result max abs err {err:.3e}")
                if rep["injected"] != 1 or rep["unrecovered"]:
                    raise AssertionError(f"shard_fail drill: {rep}")
            del eng, got
        if k > 1:
            banded_single = single
        del single, want, rhs, sell
    # serve --mesh 1,1 with and without chaos; the first batch against the
    # single-device engine of the same matrix
    requests = 8
    argv = ["--spmv", "banded", "--spmv-rows", str(MAIN_ROWS), "--batch",
            str(MAIN_BATCH), "--requests", str(requests), "--mesh", "1,1",
            "--partition", "cost"]
    for extra in ([], ["--chaos", "shard_fail:after=1,count=1"]):
        out, launches = _serve(argv + extra)
        _add(served, launches)
        # One shard, one column group: one launch a batch. Fault-free: the
        # warm-up and the timed requests. Under chaos the warm-up and its
        # fault-free parity run launch, and the one injected failure (the
        # first timed request) is recomputed by the reference executor.
        rec = out["engine"].recovery_report()
        injected = out["chaos"]["injected"] if extra else 0
        want_launches = requests + 1 + (1 - injected if extra else 0)
        if (launches["sell_spmm"] != want_launches
                or rec["recovered"] != injected
                or rec["injected"] != injected or (extra and injected != 1)):
            raise AssertionError(
                f"serve --mesh{' --chaos' if extra else ''}: sell_spmm "
                f"launches {launches['sell_spmm']} (want {want_launches}), "
                f"recovery {rec['recovered']} of {injected} injected")
        err = _max_err(out["y"], banded_single.matmat(out["batch"]))
        gf = out["per_device_gflops"]
        print(f"serve --mesh{' --chaos' if extra else ''}: "
              f"{out['spmv_per_s']:.1f} SpMV/s, per device {gf}, "
              f"{out['engine'].n_shards} shard(s); first batch against the "
              f"single-device engine max abs err {err:.3e}; launches "
              f"{launches}; shards recovered {rec['recovered']}")
        if extra:
            _chaos_check("serve --mesh shard_fail", out)
        del out
    del banded_single
    # sharded CG (host loop) on the CG matrix of phase 6
    _fresh_caches()
    spd = matrices.make_spd(matrices.banded(MAIN_ROWS, 24, 0.8)(seed=0))
    b = np.random.default_rng(1).standard_normal(MAIN_ROWS).astype(
        np.float32)
    eng = ShardedSpMVEngine(spd, mesh=mesh, n_shards=SHARDS)
    _reset_launches()
    t0 = time.perf_counter()
    res = solvers.cg(eng, b, tol=1e-6)
    dt = time.perf_counter() - t0
    launches = _read_launches()
    _add(checks, launches)
    A64 = _csr_on_card(spd, device, torch.float64)
    b64 = torch.as_tensor(b, device=device).double()
    x64 = torch.as_tensor(res.x, device=device).double()
    true = float(torch.linalg.norm(b64 - torch.mv(A64, x64))
                 / torch.linalg.norm(b64))
    print(f"sharded cg ({SHARDS} shards, loop={res.loop}): {res.iterations} "
          f"iterations in {dt:.3f}s (planning included), converged "
          f"{res.converged}, true residual {true:.3e} in float64 (tol 1e-6); "
          f"sell_spmv launches {launches['sell_spmv']} for {res.matvecs} "
          f"matvecs x {SHARDS} shards")
    if not res.converged or not true <= 2e-6:
        raise AssertionError(f"sharded cg: {res.iterations} iterations, "
                             f"true residual {true:.3e}")
    if launches["sell_spmv"] != res.matvecs * SHARDS:
        raise AssertionError(f"sharded cg launches {launches}")
    del eng, A64, spd
    _fresh_caches()
    return served, checks


# Phase 11: generation with the model stack at llama3-8b's full width and
# depth (32 layers, d_model 4096, GQA 32/8, d_ff 14336, vocab 128256, bf16).
GEN_ARGV = ["--arch", "llama3-8b", "--batch", "8", "--prompt-len", "512",
            "--tokens", "32"]
GEN_STEPS = 32
GEN_SHAPE = (32, 4096, 32, 8, 14336, 128256, "bfloat16")
# Prefill against token-by-token decode, both through a float32 cache: the
# paths differ only in layer 0's bf16 q/k/v projections (one GEMM of 16
# rows against 16 of one row; a bf16 step is 2^-8 of the value): the cache
# promotes everything after layer 0's attention to float32.
TOKEN_TOL = 2e-2
# Every other family at full width, depth cut to one repeating unit.
FAMILY_CUTS = {
    "smollm-360m": dict(n_layers=1),
    "tinyllama-1.1b": dict(n_layers=1),
    "qwen2-1.5b": dict(n_layers=1),
    "deepseek-v2-lite-16b": dict(n_layers=2),  # the lead dense + one MoE
    "llama4-maverick-400b-a17b": dict(n_layers=2),  # one unit: MoE, dense
    "zamba2-1.2b": dict(n_layers=6),  # 6 Mamba2 + the shared block
    "xlstm-1.3b": dict(n_layers=8),  # 7 mLSTM + 1 sLSTM
    "whisper-large-v3": dict(n_layers=1, encoder=1),
    "llama-3.2-vision-11b": dict(n_layers=5),  # 4 self + 1 cross-attention
}
FAMILY_BATCH, FAMILY_SEQ = 2, 16
# `repro`'s own prefill/decode test tolerance; the attention families run
# the same kernels on both paths. The recurrent ones (zamba2's Mamba2,
# xlstm's mLSTM/sLSTM) do not: a prefill through `decode_step` takes the
# recurrent scan, `forward` the chunked one, the same float32 sums in
# another order, rounded to bf16 at other points (the chunked mLSTM rounds
# its numerator and normalizer before dividing, as in `repro`). They are
# held on a float32 copy of the same weights at FLOAT32_TOL; the bf16
# difference is printed.
FAMILY_TOL = 2e-2
FLOAT32_TOL = 1e-3


def _finite(name, *tensors):
    import torch

    if not all(bool(torch.isfinite(t).all()) for t in tensors):
        raise AssertionError(f"{name}: logits that are not finite")


def _recorder(logits, tokens, seconds):
    """A `generate` step hook that keeps each step's input ids, its logits
    (the prefill's and every step's, cloned: a replay's are the graph's
    buffer) and its host seconds by kind (synchronised)."""
    import torch

    def hook(kind, toks, run):
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        seconds.setdefault(kind, []).append(time.perf_counter() - t0)
        if kind != "capture":
            tokens.append(toks.clone())
            logits.append(out.clone())
        return out

    return hook


# Phase 11 (b): the embeddings, eager and captured, in turns (eager,
# captured, captured, eager for each)
GEN_RUNS = (("index", False), ("index", True), ("index", True),
            ("index", False), ("cuda", True), ("cuda", False),
            ("cuda", False), ("cuda", True))


def _step_kinds(secs, captured, steps):
    """The steps `generate` ran, by kind, as it must run them: the prefill,
    then every step eager, or the first eager (the capture's warm-up), one
    capture and a replay a token after it."""
    want = {"prefill": 1, "step": 1, "capture": 1, "replay": steps - 1} \
        if captured else {"prefill": 1, "step": steps}
    got = {k: len(v) for k, v in secs.items()}
    if got != want:
        raise AssertionError(f"generate ran steps {got}, expected {want}")


def generation_path(device, smi):
    """Phase 11: (a) serve --arch llama3-8b (index embedding, the step
    captured), (b) the same prompts through `generate` with the index and
    the hand-written gather as the embedding, each eager and captured, in
    turns, (c) prefill against token-by-token decode, (d) the other
    families at full width, captured against eager. Returns the launches
    of (a) and of (b)'s first captured cuda run."""
    import torch

    from repro_torch.core.gather_engine import gather_engine_cache_stats
    from repro_torch.launch import serve
    from repro_torch.models import Runtime

    _phase(f"11. generation: serve --arch llama3-8b at full width and depth, "
           f"the cuda embedding, eager and captured, prefill vs decode, "
           f"every family ({smi})")
    _fresh_caches()
    torch.cuda.reset_peak_memory_stats(device)
    out, served_a = _serve(GEN_ARGV)
    cfg, model, params = out["config"], out["model"], out["params"]
    tokens, batch = out["tokens"], out["batch"]
    if (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
            cfg.vocab_size, cfg.dtype) != GEN_SHAPE:
        raise AssertionError(f"llama3-8b served at {cfg}")
    n_params = sum(p.numel() for p in params.parameters())
    if tuple(tokens.shape) != (int(GEN_ARGV[GEN_ARGV.index("--batch") + 1]),
                               GEN_STEPS) or not (
            0 <= int(tokens.min()) and int(tokens.max()) < cfg.vocab_size):
        raise AssertionError(f"generated {tuple(tokens.shape)}")
    _step_kinds(out["step_seconds"], True, GEN_STEPS)
    print(f"(a) {n_params} parameters ({n_params * 2} B of bf16) drawn in "
          f"{out['init_s']:.2f}s; prefill {out['prefill_ms']:.3f} ms (the "
          f"process's first), decode {out['decode_ms_per_step']:.3f} ms/step "
          f"(replays of the captured step), {out['tok_per_s']:.1f} tok/s "
          f"batched; peak device memory "
          f"{torch.cuda.max_memory_allocated(device)} B; launches {served_a}")

    # (b) each embedding eager and captured, in turns, each step's logits
    # recorded: every run must give the first one's bytes and serve's tokens
    runs = []
    for name, captured in GEN_RUNS:
        logits, ids, secs = [], [], {}
        _fresh_caches()
        _reset_launches()
        got = serve.generate(model, params, batch["tokens"],
                             max_new_tokens=GEN_STEPS,
                             rt=Runtime(embed_backend=name),
                             capture=captured,
                             step_hook=_recorder(logits, ids, secs))
        torch.cuda.synchronize()
        runs.append(dict(name=name, captured=captured, tokens=got, ids=ids,
                         launches=_read_launches(), secs=secs,
                         engines=gather_engine_cache_stats()))
        how = f"the {name} embedding, {'captured' if captured else 'eager'}"
        _step_kinds(secs, captured, GEN_STEPS)
        if not torch.equal(got, tokens):
            raise AssertionError(f"{how}, generated other tokens than "
                                 f"serve's")
        if len(runs) == 1:
            reference = logits
        if len(logits) != GEN_STEPS + 1:
            raise AssertionError(f"{how}: {len(logits)} logits recorded")
        for a, b in zip(reference, logits):
            _bytes_equal(b, a)
        del logits
        gathers = runs[-1]["launches"]["coalesced_gather"]
        if gathers != (GEN_STEPS + 1 if name == "cuda" else 0):
            raise AssertionError(f"{how}: the gather launched {gathers} "
                                 f"times")
    del reference
    first = next(r for r in runs if r["name"] == "cuda" and r["captured"])
    served_b, engines = first["launches"], first["engines"]
    if engines["size"] != 1:
        raise AssertionError(f"the captured step took the engine cache: "
                             f"{engines}")

    def ms(name, captured, kind):
        return [t * 1e3 for r in runs if r["name"] == name
                and r["captured"] == captured for t in r["secs"][kind]]

    line = []
    for name in ("index", "cuda"):
        eager, replay = ms(name, False, "step"), ms(name, True, "replay")
        e, c = float(np.median(eager)), float(np.median(replay))
        line.append(
            f"{name}: eager {e:.3f}, captured {c:.3f} ({e / c:.2f}x); "
            f"prefill ms " + "/".join(f"{t:.3f}" for t in ms(
                name, False, "prefill") + ms(name, True, "prefill"))
            + "; captured runs' first step (eager, the warm-up) ms "
            + "/".join(f"{t:.3f}" for t in ms(name, True, "step"))
            + ", capture ms "
            + "/".join(f"{t:.3f}" for t in ms(name, True, "capture")))
    print(f"(b) the index and cuda embeddings, eager and captured, in turns "
          f"({', '.join(f'{n} ' + ('captured' if c else 'eager') for n, c in GEN_RUNS)}): "
          f"every step's logits equal the first run's bitwise, tokens equal "
          f"serve's, the gather launched {GEN_STEPS + 1} times a cuda run "
          f"(launches of the first captured cuda run {served_b}); gather "
          f"engines cached after it {engines} (the prefill's only: the "
          f"step plans its ids in the step); decode ms a step (median, "
          f"host clock, synchronised) " + "; ".join(line))
    embedding_plan_times(params.tok.embed.detach(), first["ids"], device)
    del runs, first
    # one warm eager decode step (index embedding) after a prefill, and
    # one replay of the captured step (cuda embedding), profiled
    B, S = batch["tokens"].shape
    with torch.inference_mode():
        cache = model.init_cache(B, S + 1, Runtime(), device=device)
        _, cache = model.decode_step(params, batch["tokens"], cache,
                                     Runtime())
        last = tokens[:, :1]
        _profile_busy(lambda: model.decode_step(params, last, cache,
                                                Runtime()),
                      f"one eager decode step ({B} x 1 tokens, {S} cached)")
    del cache

    def profile_one_replay(kind, toks, run):
        if kind != "replay" or profiled:
            return run()
        profiled.append(run)
        box = []
        _profile_busy(lambda: box.append(run()),
                      f"one replay of the captured step, cuda embedding "
                      f"({B} x 1 tokens, {S + 1} cached)")
        return box[0]

    profiled = []
    serve.generate(model, params, batch["tokens"], max_new_tokens=3,
                   rt=Runtime(embed_backend="cuda"),
                   step_hook=profile_one_replay)
    torch.cuda.synchronize()
    _fresh_caches()

    # (c) prefill (one multi-token decode_step) against one-token steps,
    # at every prefix of 16 tokens, both through a float32 cache
    rt32 = Runtime(cache_dtype="float32")
    toks = batch["tokens"][:1, :16]
    with torch.inference_mode():
        cache = model.init_cache(1, 16, rt32, device=device)
        steps = []
        for t in range(16):
            lg, cache = model.decode_step(params, toks[:, t:t + 1], cache,
                                          rt32)
            steps.append(lg[:, 0])
        pre = []
        for t in range(1, 17):
            lg, _ = model.decode_step(
                params, toks[:, :t],
                model.init_cache(1, 16, rt32, device=device), rt32)
            pre.append(lg[:, 0])
        fwd, _ = model.forward(params, {"tokens": toks}, rt32)
    steps, pre = torch.stack(steps, 1), torch.stack(pre, 1)
    _finite("llama3-8b, 1 x 16 tokens", steps, pre, fwd)
    err = _max_err(steps, pre, TOKEN_TOL)
    agree = float((steps.argmax(-1) == pre.argmax(-1)).float().mean())
    fwd_err = float((fwd - steps).abs().max())
    fwd_agree = float((fwd.argmax(-1) == steps.argmax(-1)).float().mean())
    print(f"(c) 1 x 16 tokens, cache float32: prefill of every prefix "
          f"against token-by-token decode max abs err {err:.3e} (tolerance "
          f"{TOKEN_TOL} + {TOKEN_TOL}*|ref|; logits max |ref| "
          f"{float(pre.abs().max()):.3f}), argmax agreement {agree:.3f}; "
          f"the bf16 forward (no cache) against the steps max abs err "
          f"{fwd_err:.3e}, argmax agreement {fwd_agree:.3f}")
    del out, model, params, cache, fwd
    _fresh_caches()

    families(device)
    return served_a, served_b


def embedding_plan_times(table, streams, device):
    """(b)'s embedding, step by step, on fresh caches: the host ms of
    planning each step's ids eagerly (engine, schedule, plan; synchronised)
    and the kernel's ms (CUDA events); the device ms of the captured step's
    embedding, planned in the step; at the prefill stream (8 x 512 ids, 8 KB
    rows) the kernel beside its byte bound, its plain version and
    `torch.index_select`."""
    import torch

    from repro_torch.core.gather_engine import get_gather_engine
    from repro_torch.core.indirect_stream import gather_in_step
    from repro_torch.kernels.coalesced_gather import coalesced_gather_cuda, \
        coalesced_gather_plain

    plan_ms, kernel_ms = [], []
    for ids in streams:
        _fresh_caches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = get_gather_engine(tuple(table.shape), ids.reshape(-1),
                                window=256, block_rows=8, backend="cuda",
                                device=device)
        plan = eng.device_plan
        torch.cuda.synchronize()
        plan_ms.append((time.perf_counter() - t0) * 1e3)
        kw = dict(window=256, block_rows=8, plan=plan, n_out=eng.n_indices)
        kernel_ms.append(_time_ms(lambda: coalesced_gather_cuda(
            table, None, **kw), iters=10))
    print(f"  embedding per step, eager (host ms to plan the ids; kernel "
          f"ms): prefill {plan_ms[0]:.3f}; {kernel_ms[0]:.4f}; decode steps "
          f"median {float(np.median(plan_ms[1:])):.3f}; "
          f"{float(np.median(kernel_ms[1:])):.4f} (range "
          f"{min(plan_ms[1:]):.3f}-{max(plan_ms[1:]):.3f} ms to plan)")
    # the captured step's embedding: the ids planned in the step, on the
    # card (schedule at max_warps = window, plan, kernel), no host copy
    _fresh_caches()
    step_ms = []
    for ids in streams[1:]:
        flat = ids.reshape(-1)
        _bytes_equal(gather_in_step(table, flat, window=256, block_rows=8,
                                    backend="cuda"), table[flat.long()])
        step_ms.append(_time_ms(lambda: gather_in_step(
            table, flat, window=256, block_rows=8, backend="cuda"),
            iters=10))
    print(f"  embedding per decode step, planned in the step "
          f"(`gather_in_step`, the captured step's; device ms of schedule, "
          f"plan and kernel, CUDA events): median "
          f"{float(np.median(step_ms)):.4f} (range {min(step_ms):.4f}-"
          f"{max(step_ms):.4f}); equal to table[ids] bitwise")
    ids = streams[0].reshape(-1)
    _fresh_caches()
    eng = get_gather_engine(tuple(table.shape), ids, window=256,
                            block_rows=8, backend="cuda", device=device)
    kw = dict(window=256, block_rows=8, plan=eng.device_plan,
              n_out=eng.n_indices)
    idx = ids.long()
    _bytes_equal(coalesced_gather_cuda(table, None, **kw), table[idx])
    row_bytes = table.shape[1] * table.element_size()
    distinct = int(torch.unique(idx).numel())
    nbytes = (distinct + idx.numel()) * row_bytes + idx.numel() * 4
    row = dict(
        ms=_time_ms(lambda: coalesced_gather_cuda(table, None, **kw)),
        plain_ms=_time_ms(lambda: coalesced_gather_plain(table, None, **kw),
                          iters=5),
        library_ms=_time_ms(lambda: torch.index_select(table, 0, idx)),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
    )
    print(f"  coalesced_gather at the prefill stream ({idx.numel()} ids, "
          f"{distinct} distinct, rows of {row_bytes} B, table "
          f"{tuple(table.shape)} {table.dtype}): kernel {row['ms']:.4f} ms, "
          f"plain {row['plain_ms']:.4f} ms, "
          f"torch.index_select {row['library_ms']:.4f} ms "
          f"({row['library_ms'] / row['ms']:.2f}x the kernel's time), bound "
          f"{row['bound_ms']:.4f} ms (bytes: {nbytes} B, distinct rows read "
          f"once, the outputs written, the ids) -> "
          f"{row['bound_ms'] / row['ms'] * 100:.1f}% of the bound; "
          f"launches on (b)'s path: {len(streams)}")
    _fresh_caches()


def _cut(cfg, n_layers, encoder=None):
    if encoder is not None:
        return dataclasses.replace(cfg, n_layers=n_layers,
                                   encdec=dataclasses.replace(
                                       cfg.encdec, n_encoder_layers=encoder))
    return dataclasses.replace(cfg, n_layers=n_layers)


def _prefill_against_forward_f32(cfg, params, batch):
    """The prefill-against-forward check of (d) on a float32 copy of the
    weights, through a float32 cache; returns the max abs error (raises
    past FLOAT32_TOL)."""
    import torch

    from repro_torch.models import Runtime, build_model

    def widen(tree):
        if isinstance(tree, dict):
            return {k: widen(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [widen(v) for v in tree]
        return None if tree is None else tree.float()

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = build_model(cfg32)
    params32 = type(params)(cfg32, widen(params.to_tree()))
    rt = Runtime(cache_dtype="float32")
    with torch.inference_mode():
        fwd, _ = model.forward(params32, batch, rt)
        cache = model.init_cache(FAMILY_BATCH, FAMILY_SEQ, rt,
                                 device=params32.device)
        dec, _ = model.decode_step(params32, batch["tokens"], cache, rt)
    _finite(f"{cfg.name}, float32", fwd, dec)
    return _max_err(dec[:, 0], fwd[:, -1], FLOAT32_TOL)


FAMILY_TOKENS = 4  # (d)'s generate: the warm-up, a capture, 3 replays


def _captured_against_eager(name, model, params, batch, rt):
    """(d): `generate` of FAMILY_TOKENS tokens with the step captured
    against the same step eager, on the card: the kinds of step each ran,
    tokens and every step's logits (bitwise, or FAMILY_TOL where they are
    not; the comparison stops where the tokens part). Returns the line to
    print."""
    import torch

    from repro_torch.launch import serve

    got = {}
    for captured in (False, True):
        logits, ids, secs = [], [], {}
        toks = serve.generate(model, params, batch["tokens"],
                              max_new_tokens=FAMILY_TOKENS, rt=rt,
                              extras_batch=batch, capture=captured,
                              step_hook=_recorder(logits, ids, secs))
        _step_kinds(secs, captured, FAMILY_TOKENS)
        _finite(f"{name}, captured={captured}", *logits)
        got[captured] = (toks, logits, secs)
    (te, le, se), (tc, lc, sc) = got[False], got[True]
    bitwise, err = True, 0.0
    for i, (a, b) in enumerate(zip(le, lc)):
        if not torch.equal(a, b):
            bitwise = False
            err = max(err, _max_err(b, a, FAMILY_TOL))
        if i < FAMILY_TOKENS and not torch.equal(te[:, i], tc[:, i]):
            if bitwise:
                raise AssertionError(f"{name}: captured tokens differ from "
                                     f"eager's with bitwise logits")
            return (f"captured against eager: tokens part at step {i} "
                    f"after logits within {err:.3e} (tolerance "
                    f"{FAMILY_TOL} + {FAMILY_TOL}*|ref|)")
    e = float(np.median(se["step"])) * 1e3
    c = float(np.median(sc["replay"])) * 1e3
    return (f"captured against eager, {FAMILY_TOKENS} tokens: tokens equal, "
            f"every step's logits "
            + ("equal bitwise" if bitwise else
               f"within {err:.3e} (tolerance {FAMILY_TOL} + "
               f"{FAMILY_TOL}*|ref|)")
            + f"; a step {e:.3f} ms eager, {c:.3f} ms a replay (median); "
            f"capture {sc['capture'][0] * 1e3:.1f} ms")


def families(device):
    """(d): every other family at full width, depth cut to one repeating
    unit: logits finite, the prefill through `decode_step` (the cache)
    against `forward` (none) at the last position, `generate` with the step
    captured against eager, and `dispatch_report` on the card for the MoE
    families."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import Runtime, build_model, make_input_batch
    from repro_torch.models import layers as L
    from repro_torch.models.moe import dispatch_report

    rt = Runtime()
    for name, cut in FAMILY_CUTS.items():
        full = get_arch(name)
        cfg = _cut(full, **cut)
        model = build_model(cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        gen = torch.Generator(device=device).manual_seed(11)
        params = model.init(gen, device=device)
        batch = make_input_batch(cfg, FAMILY_BATCH, FAMILY_SEQ, gen,
                                 device=device)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with torch.inference_mode():
            fwd, _ = model.forward(params, batch, rt)
            cache = model.init_cache(FAMILY_BATCH, FAMILY_SEQ + 4, rt,
                                     device=device)
            if cfg.family == "audio":
                cache["enc_out"] = model.extras["encode"](
                    params, batch["enc_input"], rt)
            if cfg.family == "vlm":
                cache["image_embeds"] = batch["image_embeds"]
            dec, cache = model.decode_step(params, batch["tokens"], cache, rt)
            nxt, _ = model.decode_step(params, batch["tokens"][:, :1], cache,
                                       rt)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        if tuple(fwd.shape) != (FAMILY_BATCH, FAMILY_SEQ, cfg.vocab_size):
            raise AssertionError(f"{name}: logits {tuple(fwd.shape)}")
        _finite(name, fwd, dec, nxt)
        if cfg.family in ("hybrid", "ssm"):
            err = float((dec[:, 0] - fwd[:, -1]).abs().max())
            err32 = _prefill_against_forward_f32(cfg, params, batch)
            check = (f"{err:.3e} in bf16 (not gated: recurrent against "
                     f"chunked scan), a float32 copy {err32:.3e} (tolerance "
                     f"{FLOAT32_TOL} + {FLOAT32_TOL}*|ref|)")
        else:
            err = _max_err(dec[:, 0], fwd[:, -1], FAMILY_TOL)
            check = (f"{err:.3e} (tolerance {FAMILY_TOL} + "
                     f"{FAMILY_TOL}*|ref|, bf16)")
        n = sum(p.numel() for p in params.parameters())
        cut_s = (f"layers {cfg.n_layers} of {full.n_layers}" + (
            f", encoder {cfg.encdec.n_encoder_layers} of "
            f"{full.encdec.n_encoder_layers}" if cfg.encdec else ""))
        print(f"(d) {name}: full width (d_model {cfg.d_model}, vocab "
              f"{cfg.vocab_size}), {cut_s}; {n} parameters drawn in "
              f"{init_s:.2f}s; forward + prefill + one step {run_s:.2f}s; "
              f"prefill vs forward max abs err {check}; peak device memory "
              f"{torch.cuda.max_memory_allocated(device)} B")
        print(f"    {_captured_against_eager(name, model, params, batch, rt)}")
        if cfg.moe is not None:
            layer = params.units.pos0[0]
            with torch.inference_mode():
                h = L.rmsnorm_apply(layer.ffn_norm, params._embed(
                    batch["tokens"], rt), cfg.norm_eps)
                rep = dispatch_report(layer.moe, h, moe=cfg.moe)
            g = rep["gather"]
            print(f"    dispatch_report on {h.device}: {rep['assignments']} "
                  f"assignments to {rep['n_experts']} experts, capacity "
                  f"{rep['capacity']}, dropped {rep['dropped']}, max load "
                  f"{rep['max_load']}, imbalance "
                  f"{rep['load_imbalance']:.2f}; plan {g['n_windows']} "
                  f"windows, coalesce rate {g['coalesce_rate']:.3f}")
            if sum(rep["tokens_per_expert"]) != rep["assignments"]:
                raise AssertionError(f"{name}: dispatch_report {rep}")
            del layer, h
        del model, params, batch, fwd, dec, nxt, cache
        _fresh_caches()


# Phase 12: training with the model stack at tinyllama-1.1b's full width
# and depth (22 layers, d_model 2048, GQA 32/4, d_ff 5632, vocab 32000,
# bf16), `repro`'s `test_training_loss_decreases` schedule.
TRAIN_ARCH = "tinyllama-1.1b"
TRAIN_SHAPE = (22, 2048, 32, 4, 5632, 32000, "bfloat16")
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 20
TRAIN_DROP = 0.3
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 peak
# (b) the card against the CPU: a float32 copy, 2 layers, 2 x 64 tokens.
PARITY_LAYERS, PARITY_BATCH, PARITY_SEQ = 2, 2, 64
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
REMAT_RTOL = 1e-6
# (d) the recovery drill: one layer, a failure after step 5's update, the
# restore from step 4's checkpoint (three 1.75 GB saves a drill).
DRILL_STEPS, DRILL_EVERY, DRILL_FAIL = 8, 4, 5
DRILL_RTOL = 1e-6
EMBED_GRAD_RTOL = 1e-6
# (f) every other family: phase 11's cuts; llama4-maverick's one unit
# holds 18.7e9 parameters: 224 GB of parameters, gradients and moments.
TRAIN_FAMILIES = [n for n in FAMILY_CUTS
                  if n not in (TRAIN_ARCH, "llama4-maverick-400b-a17b")]
# (e) the captured update against the same update eager, from one state:
# (a)'s model and schedule for 10 steps each (then one replay profiled);
# the microbatched and compressed update and (c)'s remat modes at (a)'s
# width, 2 layers, 3 steps; (f)'s families 3 steps (replays after the
# warm-up).
CAPTURE_STEPS = 10
CAPTURE_LAYERS, CAPTURE_SMALL_STEPS = 2, 3
FAMILY_TRAIN_STEPS = 3


def _named_cpu(tree):
    from repro_torch.optim.tree import named_tensors

    return {n: t.detach().float().cpu() for n, t in
            named_tensors(tree).items()}


def _leaves_close(name, got, want, rtol, atol, steps=None):
    """Every tensor of `got` within ``rtol * max|want| + atol`` of `want`
    (CPU tensors by name); where `steps` gives each tensor its int8
    quantization step (its `repro` leaf's max|want| / 127: a stacked leaf
    shares one scale), at most 0.1% of a tensor may sit one step apart.
    Returns the worst error relative to its tensor's max."""
    worst = 0.0
    for n, w in want.items():
        g = got[n]
        scale = float(w.abs().max())
        err = (g - w).abs()
        bad = err > rtol * scale + atol
        if bool(bad.any()):
            if steps is None or float(bad.float().mean()) > 1e-3 or float(
                    err[bad].max()) > 1.0001 * steps[n] + atol:
                raise AssertionError(
                    f"{name}: {n} beyond {rtol:g}*max|ref| + {atol:g} at "
                    f"{int(bad.sum())} elements (max err "
                    f"{float(err.max()):.3e}, max|ref| {scale:.3e})")
            err = err.masked_fill(bad, 0)
        worst = max(worst, float(err.max()) / max(scale, 1e-30))
    return worst


def _int8_steps(params, moments):
    """Each tensor's int8 quantization step in `moments` (CPU tensors by
    name): its `repro` leaf's largest magnitude / 127."""
    from repro_torch.optim.tree import leaves

    steps = {}
    for leaf in leaves(params):
        top = max(float(moments[n].abs().max()) for n in leaf.names)
        steps.update({n: top / 127 for n in leaf.names})
    return steps


def _one_update(model, params, batch, tcfg):
    """One `make_update_fn` update: (loss, first moments as CPU tensors)."""
    from repro_torch.models import Runtime
    from repro_torch.optim.compression import init_residual
    from repro_torch.optim.optimizer import OptConfig, init_opt_state
    from repro_torch.train.loop import make_update_fn

    update = make_update_fn(model, OptConfig(), Runtime(), tcfg)
    residual = init_residual(params) if tcfg.grad_compression else None
    _, opt, _, metrics = update(params, init_opt_state(params), residual,
                                batch)
    return float(metrics["loss"]), _named_cpu(opt.mu)


def _train_opt():
    """(a)'s schedule: `repro`'s `test_training_loss_decreases`."""
    from repro_torch.optim.optimizer import OptConfig

    return OptConfig(lr=1e-3, warmup_steps=5, total_steps=TRAIN_STEPS)


def train_full(device, smi):
    """(a): `train()` at full width and depth, then the launcher's main.
    Returns the trained parameters, the model and the data config."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch import train as launch_train
    from repro_torch.models import Runtime, build_model
    from repro_torch.train.loop import TrainConfig, train

    cfg = get_arch(TRAIN_ARCH)
    if (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
            cfg.vocab_size, cfg.dtype) != TRAIN_SHAPE:
        raise AssertionError(f"{TRAIN_ARCH} trained at {cfg}")
    model = build_model(cfg)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH)
    torch.cuda.reset_peak_memory_stats(device)
    out = train(model, rt=Runtime(), opt_cfg=_train_opt(),
                tcfg=TrainConfig(total_steps=TRAIN_STEPS, log_every=1),
                data_cfg=data_cfg, device=device)
    peak = torch.cuda.max_memory_allocated(device)
    if not out["captured"]:
        raise AssertionError("(a) train did not capture its update")
    hist = out["history"]
    for h in hist:
        print(f"(a) step {h['step']:2d}: loss {h['loss']:.4f}, grad_norm "
              f"{h['grad_norm']:.4f}, {h['sec'] * 1e3:.1f} ms")
    values = [v for h in hist for v in (h["loss"], h["grad_norm"])]
    if len(hist) != TRAIN_STEPS or not all(np.isfinite(values)):
        raise AssertionError(f"(a) history {hist}")
    drop = hist[0]["loss"] - hist[-1]["loss"]
    if not drop > TRAIN_DROP:
        raise AssertionError(f"(a) the loss fell by {drop:.4f}, not more "
                             f"than {TRAIN_DROP}")
    params = out["params"]
    n_params = sum(p.numel() for p in params.parameters())
    step_s = float(np.median([h["sec"] for h in hist[1:]]))
    opt = out["opt_state"]
    held = list(params.parameters()) + list(opt.mu.parameters()) + \
        list(opt.nu.parameters()) + [opt.step]
    PHASE12["argument_bytes"] = sum(t.numel() * t.element_size()
                                    for t in held) + TRAIN_BATCH * TRAIN_SEQ * 4
    del opt, held
    tok_s = TRAIN_BATCH * TRAIN_SEQ / step_s
    PHASE12.update(losses=[h["loss"] for h in hist],
                   grad_norms=[h["grad_norm"] for h in hist],
                   replay_ms=float(np.median([h["sec"] for h in
                                              hist[1:SHARD_STEPS]])) * 1e3,
                   peak=peak)
    print(f"(a) {n_params} parameters; loss {hist[0]['loss']:.4f} -> "
          f"{hist[-1]['loss']:.4f} (drop {drop:.4f} > {TRAIN_DROP}); first "
          f"step (eager, the capture's warm-up) {hist[0]['sec'] * 1e3:.1f} "
          f"ms, capture {out['capture_seconds'] * 1e3:.1f} ms, later steps "
          f"(replays) median "
          f"{step_s * 1e3:.1f} ms; {tok_s:.0f} tokens/s; model-FLOP share "
          f"6*N*tokens/s / {BF16_FLOP_PER_S:.3g} = "
          f"{6 * n_params * tok_s / BF16_FLOP_PER_S * 100:.2f}% ({smi}); "
          f"{out['wall_seconds']:.2f} s for {out['steps']} steps; peak "
          f"device memory {peak} B")
    del out
    _fresh_caches()
    argv = ["--arch", TRAIN_ARCH, "--steps", "2", "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ)]
    print("python -m repro_torch.launch.train " + " ".join(argv),
          flush=True)
    cli = launch_train.main(argv)
    if [h["step"] for h in cli["history"]] != [0, 1] or not all(
            np.isfinite([h["loss"] for h in cli["history"]])) or \
            not cli["captured"]:
        raise AssertionError(f"launch.train history {cli['history']}, "
                             f"captured {cli['captured']}")
    del cli
    _fresh_caches()
    return model, params, data_cfg


def remat_modes(device, model, params, data_cfg):
    """(c): one forward and backward of (a)'s model under each remat."""
    import torch

    from repro_torch.data.pipeline import TokenPipeline, device_put_batch
    from repro_torch.models import Runtime, lm_loss
    from repro_torch.train.loop import value_and_grad

    batch = device_put_batch(TokenPipeline(data_cfg).batch_at(TRAIN_STEPS),
                             device)
    seen = {}
    for remat in ("none", "full", "dots"):
        for _ in range(2):  # the second: checkpointing's first call pays
            _fresh_caches()  # seconds of one-time set-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            loss, grads = value_and_grad(
                lambda p: lm_loss(model, p, batch, Runtime(remat=remat)),
                params)
            torch.cuda.synchronize()
            seen[remat] = (float(loss),
                           torch.cuda.max_memory_allocated(device),
                           time.perf_counter() - t0)
            del grads
    PHASE12["remat_peaks"] = {r: v[1] for r, v in seen.items()}
    base = seen["none"][0]
    for remat, (loss, peak, secs) in seen.items():
        print(f"(c) remat {remat}: loss {loss:.6f}, peak device memory "
              f"{peak} B, forward + backward {secs * 1e3:.1f} ms (the "
              f"second of two)")
        if abs(loss - base) > REMAT_RTOL * abs(base):
            raise AssertionError(f"(c) remat {remat} loss {loss} against "
                                 f"{base}")
    if not seen["full"][1] < seen["none"][1]:
        raise AssertionError("(c) remat full does not peak below none")


def _train_recorded(model, device, capture, steps, data_cfg, rt=None,
                    tcfg_kw=None):
    """`train()` of `steps` steps of (a)'s schedule, eager or captured.
    Returns (train's output, record: each step's kind and (loss,
    grad_norm, lr) as its history read them from the step's outputs, the
    seconds of each step by kind and of the capture, the peak device
    memory over the run above its start)."""
    import torch

    from repro_torch.models import Runtime
    from repro_torch.train.loop import TrainConfig, train

    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = train(model, rt=rt or Runtime(), opt_cfg=_train_opt(),
                tcfg=TrainConfig(total_steps=steps, log_every=1,
                                 **(tcfg_kw or {})),
                data_cfg=data_cfg, device=device, capture=capture)
    hist = out["history"]
    rec = {"kinds": [h["kind"] for h in hist],
           "metrics": [(h["loss"], h["grad_norm"], h["lr"]) for h in hist],
           "secs": {}, "peak": torch.cuda.max_memory_allocated(device) - base}
    for h in hist:
        rec["secs"].setdefault(h["kind"], []).append(h["sec"])
    if capture:
        rec["secs"]["capture"] = [out["capture_seconds"]]
    want = ["step"] * steps if not capture else \
        ["step"] + ["replay"] * (steps - 1)
    if rec["kinds"] != want or out["captured"] != capture:
        raise AssertionError(f"train ran {rec['kinds']}, expected {want}")
    return out, rec


def _profile_one_replay(device, smi, model, data_cfg):
    """(a)'s update from the seed's state warmed up on a side stream and
    captured there, as `train` does it; its second step's replay under
    torch.profiler."""
    import torch

    from repro_torch.core.capture import CapturedStep, on_side_stream
    from repro_torch.data.pipeline import TokenPipeline, device_put_batch
    from repro_torch.models import Runtime
    from repro_torch.optim.optimizer import init_opt_state
    from repro_torch.train.loop import TrainConfig, copy_batch, \
        update_over_buffers

    data = TokenPipeline(data_cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device=device)
    batch = device_put_batch(data.batch_at(0), device)
    step = update_over_buffers(model, _train_opt(), Runtime(),
                               TrainConfig(), params, init_opt_state(params),
                               None, batch)
    side = torch.cuda.Stream(device)
    on_side_stream(side, step)
    graph = CapturedStep(step, side, "(e) the training update")
    copy_batch(batch, data.batch_at(1))
    _profile_busy(graph, f"one replay of the training update (step 1; "
                         f"{smi})")
    del graph, step, params, batch


def _state_against(name, got, want, hold=True):
    """Every parameter and moment of `got` against `want` (`train`'s
    outputs, or `{"params", "opt_state"}`): (bitwise, the worst error
    relative to its tensor's max|ref|); with `hold`, within (b)'s ``1e-4 *
    max|ref| + 1e-6`` or raise, an element of a bf16 tensor one rounding
    step of its own further (``eps * |ref|``: (b) held float32 ones)."""
    import torch

    from repro_torch.optim.tree import named_tensors

    bitwise, worst = True, 0.0
    for part in ("params", "mu", "nu"):
        a, b = (named_tensors(o["params"] if part == "params"
                              else getattr(o["opt_state"], part))
                for o in (got, want))
        for n, w in b.items():
            g = a[n]
            if torch.equal(g, w):
                continue
            bitwise = False
            eps = torch.finfo(w.dtype).eps if w.dtype != torch.float32 \
                else 0.0
            g, w = g.detach().float(), w.detach().float()
            scale = float(w.abs().max())
            diff = (g - w).abs()
            err = float(diff.max())
            if hold and bool((diff > GRAD_RTOL * scale + GRAD_ATOL
                              + eps * w.abs()).any()):
                raise AssertionError(f"{name}: {part} {n} off by {err:.3e} "
                                     f"(max|ref| {scale:.3e})")
            worst = max(worst, err / max(scale, 1e-30))
    return bitwise, worst


def _metrics_against(name, got, want):
    """Each step's (loss, grad_norm, lr) of `got` against `want`: bitwise,
    else the loss within ``1e-5 * |loss|``, the grad norm within 1e-4
    relative and the lr equal, or raise. Returns whether bitwise."""
    if got == want:
        return True
    for i, ((lg, ng, rg), (lw, nw, rw)) in enumerate(zip(got, want)):
        if abs(lg - lw) > LOSS_RTOL * abs(lw) or \
                abs(ng - nw) > GRAD_RTOL * abs(nw) or rg != rw:
            raise AssertionError(f"{name}: step {i} (loss, grad_norm, lr) "
                                 f"{(lg, ng, rg)} against {(lw, nw, rw)}")
    return False


def _why(bitwise, again):
    """The reason printed beside a comparison held to a tolerance:
    whether the eager run repeats itself bitwise (`again`)."""
    if bitwise:
        return "bitwise"
    return ("within tolerance: the eager update does not repeat itself "
            "bitwise either (atomic adds in another order)" if not again
            else "within tolerance, though the eager update repeats itself "
            "bitwise")


def captured_against_eager(device, smi, model, data_cfg):
    """(e): from one state (the seed's), 10 steps of (a)'s training eager
    and 10 captured, in turns in one call: every step's loss, grad norm and
    lr and, after the steps, every parameter and moment bitwise (else
    within (b)'s tolerances, the reason printed); step ms eager and a
    replay's (medians), the capture's and the first step's ms, the peak
    memory of each, then one replay under torch.profiler. The captured
    losses are (a)'s first 10 (the same seed and schedule)."""
    runs = {}
    for capture in (False, True):
        _fresh_caches()
        runs[capture] = _train_recorded(model, device, capture,
                                        CAPTURE_STEPS, data_cfg)
    eager, er = runs[False]
    cr = runs[True][1]
    for i, (a, b) in enumerate(zip(er["metrics"], cr["metrics"])):
        print(f"(e) step {i}: eager loss {a[0]!r}, grad_norm {a[1]!r}, lr "
              f"{a[2]!r}; captured {b[0]!r}, {b[1]!r}, {b[2]!r}")
    same = _metrics_against("(e)", cr["metrics"], er["metrics"])
    bitwise, worst = _state_against("(e)", runs[True][0], eager)
    del runs  # the captured run's state and graph
    _fresh_caches()
    again = None
    if not (same and bitwise):  # does eager repeat itself?
        twice, _ = _train_recorded(model, device, False, CAPTURE_STEPS,
                                   data_cfg)
        again = _state_against("(e) eager twice", twice, eager)[0]
        del twice
    want = PHASE12["losses"][:CAPTURE_STEPS]
    from_a = [m[0] for m in cr["metrics"]] == want
    e_ms = float(np.median(er["secs"]["step"][1:])) * 1e3
    r_ms = float(np.median(cr["secs"]["replay"])) * 1e3
    PHASE12["step_ms"] = e_ms
    print(f"(e) {TRAIN_ARCH} at full width and depth, {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, {CAPTURE_STEPS} steps each from the seed's state: "
          f"losses, grad norms and lr {_why(same, again)}; parameters and "
          f"moments {_why(bitwise, again)}"
          + ("" if bitwise else f" (worst {worst:.3e} of max|ref|)")
          + f"; captured losses equal (a)'s first {CAPTURE_STEPS}: {from_a}")
    print(f"(e) a step eager {e_ms:.3f} ms, a replay {r_ms:.3f} ms (medians "
          f"of steps 1-{CAPTURE_STEPS - 1}, the host's batch placement "
          f"included; {e_ms / r_ms:.3f}x); first step eager {er['secs']['step'][0] * 1e3:.1f}"
          f" ms, captured run's first (eager on the side stream, the "
          f"warm-up) {cr['secs']['step'][0] * 1e3:.1f} ms, capture "
          f"{cr['secs']['capture'][0] * 1e3:.1f} ms; peak device memory "
          f"above the run's start: eager {er['peak']} B, captured "
          f"{cr['peak']} B ({smi})")
    if not from_a:
        raise AssertionError(f"(e) captured losses {cr['metrics']} against "
                             f"(a)'s {want}")
    del eager
    _fresh_caches()
    _profile_one_replay(device, smi, model, data_cfg)
    _fresh_caches()


def captured_small(device, smi):
    """(e) at (a)'s width, 2 layers: the update with microbatches 2 and
    compression on, and under (c)'s remat modes, captured against the
    same update eager from one state."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import Runtime, build_model

    cfg = _cut(get_arch(TRAIN_ARCH), CAPTURE_LAYERS)
    model = build_model(cfg)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH)
    for what, kw in (
            ("microbatches 2, compression on",
             dict(tcfg_kw=dict(microbatches=2, grad_compression=True))),
            ("remat full", dict(rt=Runtime(remat="full"))),
            ("remat dots", dict(rt=Runtime(remat="dots")))):
        (eager, er), (capt, cr) = (
            _train_recorded(model, device, c, CAPTURE_SMALL_STEPS, data_cfg,
                            **kw) for c in (False, True))
        same = _metrics_against(f"(e) {what}", cr["metrics"], er["metrics"])
        bitwise, worst = _state_against(f"(e) {what}", capt, eager)
        e_ms = float(np.median(er["secs"]["step"][1:])) * 1e3
        r_ms = float(np.median(cr["secs"]["replay"])) * 1e3
        print(f"(e) {what}, {CAPTURE_LAYERS} layers, {CAPTURE_SMALL_STEPS} "
              f"steps: metrics {'bitwise' if same else 'within tolerance'}, "
              f"parameters and moments "
              + ("bitwise" if bitwise else f"within {worst:.3e} of max|ref|")
              + f"; a step {e_ms:.3f} ms eager, {r_ms:.3f} ms a replay; "
              f"peaks {er['peak']} / {cr['peak']} B ({smi})")
        del eager, capt
        _fresh_caches()


def card_against_cpu(device):
    """(b) and (g) on a float32 copy at full width, 2 layers."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.interop import model_params_from_numpy, \
        model_params_to_numpy
    from repro_torch.data.pipeline import DataConfig, TokenPipeline, \
        device_put_batch
    from repro_torch.models import Runtime, build_model, lm_loss
    from repro_torch.train.loop import TrainConfig, value_and_grad

    cfg = dataclasses.replace(_cut(get_arch(TRAIN_ARCH), PARITY_LAYERS),
                              dtype="float32")
    model = build_model(cfg)
    arrays = model_params_to_numpy(cfg, model.init(
        torch.Generator().manual_seed(5), device="cpu"))
    batch_np = TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=PARITY_SEQ,
        global_batch=PARITY_BATCH)).batch_at(1)

    def on(dev):
        return (model_params_from_numpy(cfg, arrays, device=dev),
                device_put_batch(batch_np, dev))

    cpu, card = on("cpu"), on(device)
    want_loss, want = value_and_grad(
        lambda p: lm_loss(model, p, cpu[1], Runtime()), cpu[0])
    got_loss, got = value_and_grad(
        lambda p: lm_loss(model, p, card[1], Runtime()), card[0])
    want_loss, got_loss = float(want_loss), float(got_loss)
    if abs(got_loss - want_loss) > LOSS_RTOL * abs(want_loss):
        raise AssertionError(f"(b) loss {got_loss} on the card, {want_loss} "
                             f"on the CPU")
    worst = _leaves_close("(b) gradients", _named_cpu(got),
                          _named_cpu(want), GRAD_RTOL, GRAD_ATOL)
    print(f"(b) float32, d_model {cfg.d_model}, {cfg.n_layers} layers, "
          f"{PARITY_BATCH} x {PARITY_SEQ} tokens: loss {got_loss:.7f} card, "
          f"{want_loss:.7f} CPU; gradients: worst leaf error "
          f"{worst:.3e} of its max|g| (tolerance {GRAD_RTOL:g}*max|g_cpu| + "
          f"{GRAD_ATOL:g})")
    del want, got
    for kw in (dict(microbatches=2), dict(grad_compression=True)):
        tcfg = TrainConfig(**kw)
        results = [_one_update(model, *on(dev), tcfg)
                   for dev in ("cpu", device)]
        (want_loss, want_mu), (got_loss, got_mu) = results
        if abs(got_loss - want_loss) > LOSS_RTOL * abs(want_loss):
            raise AssertionError(f"(b) {kw}: loss {got_loss} against "
                                 f"{want_loss}")
        worst = _leaves_close(
            f"(b) {kw} first moment", got_mu, want_mu, GRAD_RTOL,
            GRAD_ATOL * 0.1, steps=_int8_steps(cpu[0], want_mu)
            if tcfg.grad_compression else None)
        print(f"(b) one update with {kw}: loss {got_loss:.7f} card, "
              f"{want_loss:.7f} CPU; first moment worst leaf error "
              f"{worst:.3e} of its max")

    # (g) C19: the gather kernel has no backward
    params, batch = card
    for backend in ("cuda", "auto"):
        try:
            lm_loss(model, params, batch, Runtime(embed_backend=backend))
        except NotImplementedError as exc:
            print(f"(g) embed_backend={backend!r} under autograd on the "
                  f"card: NotImplementedError ({exc})")
        else:
            raise AssertionError(f"(g) embed_backend={backend!r} "
                                 f"differentiated on the card")
    grads = {}
    for backend in ("index", "coalesced"):
        loss, g = value_and_grad(lambda p: lm_loss(
            model, p, batch, Runtime(embed_backend=backend)), params)
        grads[backend] = (float(loss), g.tok.embed.detach().clone())
        del g
    (li, gi), (lc, gc) = grads["index"], grads["coalesced"]
    scale = float(gi.abs().max())
    err = float((gc - gi).abs().max())
    if li != lc or err > EMBED_GRAD_RTOL * scale:
        raise AssertionError(f"(g) coalesced loss {lc} / index {li}, "
                             f"embedding gradient error {err:.3e} of max "
                             f"{scale:.3e}")
    print(f"(g) embed_backend 'coalesced' and 'index' on the card: losses "
          f"equal ({li:.7f}); embedding gradients max error {err:.3e} "
          f"(bitwise: {bool(torch.equal(gc, gi))}; tolerance "
          f"{EMBED_GRAD_RTOL:g}*max|g| = {EMBED_GRAD_RTOL * scale:.3e})")


def recovery_drill(device, smi):
    """(d): run_with_recovery against an uninterrupted run, full width, one
    layer, bf16; a save and a restore timed; the bf16 checkpoint restored
    byte for byte."""
    import shutil

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, TokenPipeline, \
        device_put_batch
    from repro_torch.models import Runtime, build_model
    from repro_torch.optim.optimizer import OptConfig, init_opt_state
    from repro_torch.optim.tree import named_tensors
    from repro_torch.train.checkpoint import restore_latest, \
        save_checkpoint
    from repro_torch.train.fault_tolerance import run_with_recovery
    from repro_torch.core.capture import CapturedStep, on_side_stream
    from repro_torch.train.loop import TrainConfig, copy_batch, \
        make_update_fn, update_over_buffers

    cfg = _cut(get_arch(TRAIN_ARCH), 1)
    model = build_model(cfg)
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH))
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=2, total_steps=DRILL_STEPS)
    update = make_update_fn(model, opt_cfg, Runtime(), TrainConfig())

    def init_state():
        params = model.init(torch.Generator(device=device).manual_seed(7),
                            device=device)
        return {"params": params, "opt": init_opt_state(params)}

    def advance(state, step):
        batch = device_put_batch(data.batch_at(step), device)
        update(state["params"], state["opt"], None, batch)
        return state

    failed = []

    def one_step(state, step):
        advance(state, step)
        if step == DRILL_FAIL and not failed:
            failed.append(step)  # the node dies after its update
            raise RuntimeError(f"injected failure after step {step}")
        return state

    whole = init_state()
    for step in range(DRILL_STEPS):
        advance(whole, step)
    torch.cuda.synchronize()
    root = ROOT / "build" / f"train-ckpt-{os.getpid()}"
    try:
        t0 = time.perf_counter()
        final = run_with_recovery(
            init_state=init_state, train_one_step=one_step,
            total_steps=DRILL_STEPS, ckpt_dir=str(root / "drill"),
            ckpt_every=DRILL_EVERY)
        torch.cuda.synchronize()
        drill_s = time.perf_counter() - t0
        if failed != [DRILL_FAIL]:
            raise AssertionError(f"(d) failures {failed}")
        got, want = named_tensors(final["params"]), \
            named_tensors(whole["params"])
        got = {n: t.detach() for n, t in got.items()}
        want = {n: t.detach() for n, t in want.items()}
        exact = all(torch.equal(got[n], want[n]) for n in want)
        worst = max(float((got[n] - want[n]).float().abs().max())
                    / max(float(want[n].float().abs().max()), 1e-30)
                    for n in want) if not exact else 0.0
        if not exact and worst > DRILL_RTOL:
            raise AssertionError(f"(d) recovered parameters off by {worst:.3e}"
                                 f" relative")
        if int(final["opt"].step) != DRILL_STEPS:
            raise AssertionError(f"(d) optimizer step {final['opt'].step}")
        n_params = sum(p.numel() for p in final["params"].parameters())
        print(f"(d) run_with_recovery: {n_params} parameters ({cfg.dtype}, "
              f"layers 1 of {get_arch(TRAIN_ARCH).n_layers}), {DRILL_STEPS} "
              f"steps, "
              f"checkpoint every {DRILL_EVERY}, a failure after step "
              f"{DRILL_FAIL}'s update, {drill_s:.2f} s; final parameters "
              + ("bitwise equal to the uninterrupted run's (the step is "
                 "deterministic on the card)" if exact else
                 f"within {worst:.3e} relative of the uninterrupted run's "
                 f"(the step is not bitwise deterministic on the card)"))

        # the same drill with the update captured: the restore copies into
        # the buffers the graph was captured over, and the replays go on
        held = init_state()
        static = {"tokens": torch.empty((TRAIN_BATCH, TRAIN_SEQ),
                                        dtype=torch.int32, device=device)}
        buffers_step = update_over_buffers(
            model, opt_cfg, Runtime(), TrainConfig(), held["params"],
            held["opt"], None, static)
        side = torch.cuda.Stream(device)
        captured = []  # the graph, after the first step (the warm-up)
        failed.clear()

        def captured_step(state, step):
            if state is not held:
                raise AssertionError("(d) the state left the captured "
                                     "buffers")
            copy_batch(static, data.batch_at(step))
            if captured:
                captured[0]()
            else:
                on_side_stream(side, buffers_step)
                captured.append(CapturedStep(buffers_step, side,
                                             "(d) the training update"))
            if step == DRILL_FAIL and not failed:
                failed.append(step)
                raise RuntimeError(f"injected failure after step {step}")
            return state

        t0 = time.perf_counter()
        again = run_with_recovery(
            init_state=lambda: held, train_one_step=captured_step,
            total_steps=DRILL_STEPS, ckpt_dir=str(root / "captured"),
            ckpt_every=DRILL_EVERY)
        torch.cuda.synchronize()
        drill_s = time.perf_counter() - t0
        if failed != [DRILL_FAIL] or not captured:
            raise AssertionError(f"(d) captured drill: failures {failed}, "
                                 f"captured {bool(captured)}")
        same, worst = _state_against(
            "(d) captured drill", {"params": again["params"],
                                   "opt_state": again["opt"]},
            {"params": whole["params"], "opt_state": whole["opt"]})
        if exact and not same:
            raise AssertionError(f"(d) the captured drill's state is "
                                 f"{worst:.3e} off the uninterrupted run's")
        print(f"(d) the drill with the update captured (the warm-up, then "
              f"replays; the restore after step {DRILL_FAIL}'s failure "
              f"copied into the captured buffers): {drill_s:.2f} s; final "
              f"parameters and moments "
              + ("bitwise equal to the uninterrupted eager run's" if same
                 else f"within {worst:.3e} of the uninterrupted run's")
              + f" ({smi})")
        del held, static, captured, buffers_step, again
        t0 = time.perf_counter()
        path = save_checkpoint(root / "saved", DRILL_STEPS - 1, final)
        save_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in path.iterdir())
        fresh = init_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step, fresh = restore_latest(root / "saved", fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        for part in ("params", "mu", "nu"):
            a, b = (named_tensors(fresh["params"] if part == "params"
                                  else getattr(fresh["opt"], part)),
                    named_tensors(final["params"] if part == "params"
                                  else getattr(final["opt"], part)))
            for n in b:
                if not _bytes_equal_bool(a[n], b[n]):
                    raise AssertionError(f"(d) restored {part} {n} differs")
        if step != DRILL_STEPS - 1 or not torch.equal(fresh["opt"].step,
                                                      final["opt"].step):
            raise AssertionError(f"(d) restored step {step}")
        print(f"(d) save_checkpoint {nbytes} B in {save_s:.2f} s, "
              f"restore_latest in {restore_s:.2f} s; the bf16 parameters "
              f"and the moments restored byte for byte")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _bytes_equal_bool(a, b):
    import torch

    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def _family_run(model, cfg, device, capture, steps):
    """`steps` updates of a family's cut model from seed 12's state on one
    batch, eager (``update_over_buffers``) or captured: its warm-up on a
    side stream, the state put back to the seed's, the capture there
    (`core.capture`, as `train` does it), then `steps` replays, each from
    the state of the eager update of its index. Returns
    (state, each step's metrics, seconds a step, peak device memory above
    the start)."""
    import torch

    from repro_torch.core.capture import CapturedStep, on_side_stream
    from repro_torch.models import Runtime, make_input_batch
    from repro_torch.optim.optimizer import init_opt_state
    from repro_torch.train.loop import TrainConfig, update_over_buffers

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    gen = torch.Generator(device=device).manual_seed(12)
    params = model.init(gen, device=device)
    batch = make_input_batch(cfg, FAMILY_BATCH, FAMILY_SEQ, gen,
                             device=device)
    opt = init_opt_state(params)
    step = update_over_buffers(model, _train_opt(), Runtime(),
                               TrainConfig(), params, opt, None, batch)
    if capture:
        seed = [p.detach().clone() for p in params.parameters()]
        side = torch.cuda.Stream(device)
        on_side_stream(side, step)
        with torch.no_grad():
            for p, p0 in zip(params.parameters(), seed):
                p.copy_(p0)
            for m in list(opt.mu.parameters()) + list(opt.nu.parameters()):
                m.zero_()
            opt.step.zero_()
        del seed
        step = CapturedStep(step, side, f"(f) {cfg.name}: the training "
                            f"update")
    metrics, secs = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        metrics.append(tuple(float(out[k]) for k in
                             ("loss", "grad_norm", "lr")))
    peak = torch.cuda.max_memory_allocated(device) - base
    return {"params": params, "opt_state": opt}, metrics, secs, peak


def train_families(device, smi):
    """(f): every other family at full width with phase 11's cut, three
    updates eager and three replays of the captured update from the same
    state: losses finite, and every step's metrics and the final
    parameters and moments bitwise, or raise."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    print("(f) llama4-maverick-400b-a17b left out: its one MoE unit holds "
          "18.7e9 parameters, whose bf16 values and gradients and float32 "
          "moments need ~224 GB")
    for name in TRAIN_FAMILIES:
        full = get_arch(name)
        cfg = _cut(full, **FAMILY_CUTS[name])
        model = build_model(cfg)
        t0 = time.perf_counter()
        eager, em, es, ep = _family_run(model, cfg, device, False,
                                        FAMILY_TRAIN_STEPS)
        capt, cm, cs, cp = _family_run(model, cfg, device, True,
                                       FAMILY_TRAIN_STEPS)
        secs = time.perf_counter() - t0
        values = [v for m in em + cm for v in m]
        finite = all(bool(torch.isfinite(p).all())
                     for p in capt["params"].parameters())
        if not (np.isfinite(values).all() and finite):
            raise AssertionError(f"(f) {name}: metrics {em} / {cm}, "
                                 f"parameters finite {finite}")
        if cm != em:
            raise AssertionError(f"(f) {name}: captured metrics {cm} "
                                 f"against eager {em}")
        bitwise, worst = _state_against(f"(f) {name}", capt, eager,
                                        hold=False)
        if not bitwise:
            raise AssertionError(f"(f) {name}: the captured parameters and "
                                 f"moments are {worst:.3e} of max|ref| off "
                                 f"the eager ones")
        del capt
        n = sum(p.numel() for p in eager["params"].parameters())
        print(f"(f) {name}: layers {cfg.n_layers} of {full.n_layers}, {n} "
              f"parameters; {FAMILY_TRAIN_STEPS} steps eager and captured "
              f"in {secs:.2f} s, losses "
              + ", ".join(f"{m[0]:.4f}" for m in em)
              + "; captured against eager: every step's metrics, the "
              f"parameters and moments bitwise; a step {es[-1] * 1e3:.3f} "
              f"ms eager, {cs[-1] * 1e3:.3f} ms a replay; peak device "
              f"memory {ep} / {cp} B ({smi})")
        del model, eager
        _fresh_caches()


def training_path(device, smi):
    """Phase 12: (a) train tinyllama-1.1b at full width and depth, the
    update captured, and the launcher, (c) remat, (e) the captured update
    against the same update eager, (b) the card against the CPU and C19,
    (d) the recovery drill (eager and captured), (f) every other family
    (eager and captured). Driven with the launch counts set to 0: returns
    them (the path launches none)."""
    _phase(f"12. training: {TRAIN_ARCH} at full width and depth (the "
           f"update captured), remat, captured against eager, card against "
           f"CPU, recovery drill, every family ({smi})")
    _fresh_caches()
    _reset_launches()
    model, params, data_cfg = train_full(device, smi)
    remat_modes(device, model, params, data_cfg)
    del params
    _fresh_caches()
    captured_against_eager(device, smi, model, data_cfg)
    captured_small(device, smi)
    del model
    _fresh_caches()
    card_against_cpu(device)
    _fresh_caches()
    recovery_drill(device, smi)
    _fresh_caches()
    train_families(device, smi)
    launches = _read_launches()
    if any(launches.values()):
        raise AssertionError(f"the training path launched {launches}")
    print(f"launches on the training path: {launches} (the index "
          f"embedding; the cuda gather has no backward)")
    return launches


# Phase 13: the sharded step on a 1x1 NCCL mesh against phase 12 (a)
# phase 12 (a)'s losses, step ms, peak and the bytes of its parameters,
# optimizer state and batch, and (c)'s peaks by remat, filled there
PHASE12 = {}
SHARD_STEPS = 10
GRID_ARGV = ["--arch", TRAIN_ARCH, "--reduced", "--mesh", "2,2", "--device",
             "cpu", "--steps", "4"]


def sharded_full(device, smi):
    """(a): `train()` on a 1x1 NCCL process mesh at full width and depth,
    against phase 12 (a)."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models import Runtime, build_model
    from repro_torch.optim.optimizer import OptConfig
    from repro_torch.sharding.dtensor import is_dtensor
    from repro_torch.train.loop import TrainConfig, train

    if len(PHASE12.get("losses", ())) < SHARD_STEPS:
        raise AssertionError(f"(a) phase 12 (a) left {PHASE12}")
    cfg = get_arch(TRAIN_ARCH)
    model = build_model(cfg)
    try:
        mesh = make_process_mesh(1, 1)
        print(f"(a) process mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
              f" on {mesh.device_type}, backend "
              f"{dist.get_backend()}, world {dist.get_world_size()}")
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        out = train(model, mesh=mesh, rt=Runtime(),
                    opt_cfg=OptConfig(lr=1e-3, warmup_steps=5,
                                      total_steps=TRAIN_STEPS),
                    tcfg=TrainConfig(total_steps=SHARD_STEPS, log_every=1),
                    data_cfg=DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH),
                    device=device)
        peak = torch.cuda.max_memory_allocated(device)
        params, opt = out["params"], out["opt_state"]
        tensors = list(params.parameters()) + list(opt.mu.parameters()) \
            + list(opt.nu.parameters())
        if not all(is_dtensor(t) for t in tensors):
            raise AssertionError("(a) a parameter or moment is not a DTensor")
        placed = {repr(tuple(p.placements)) for p in params.parameters()}
        hist = out["history"]
        want = PHASE12["losses"][:SHARD_STEPS]
        got = [h["loss"] for h in hist]
        for h, w, wn in zip(hist, want, PHASE12["grad_norms"]):
            print(f"(a) step {h['step']:2d}: loss {h['loss']!r} (phase 12 "
                  f"{w!r}), grad_norm {h['grad_norm']!r} (phase 12 "
                  f"{wn!r}), {h['sec'] * 1e3:.1f} ms")
        worst = max(abs(g - w) / abs(w) for g, w in zip(got, want))
        if len(got) != SHARD_STEPS or not worst <= LOSS_RTOL:
            raise AssertionError(f"(a) losses {got} against phase 12's "
                                 f"{want}")
        step_ms = float(np.median([h["sec"] for h in hist[1:]])) * 1e3
        base = PHASE12["step_ms"]
        tokens = TRAIN_BATCH * TRAIN_SEQ
        print(f"(a) {len(tensors)} DTensors (parameters and moments) on "
              f"placements {sorted(placed)}; the {SHARD_STEPS} losses within "
              f"{worst:.3e} relative of phase 12 (a)'s (bitwise: "
              f"{got == want}); first step {hist[0]['sec'] * 1e3:.1f} ms "
              f"(DTensor's sharding propagation warms up)")
        print(f"(a) sharded step on 1x1 (eager, ROADMAP A4): median "
              f"{step_ms:.1f} ms, {tokens / step_ms * 1e3:.0f} tokens/s, "
              f"peak device memory {peak} B; phase 12 (e)'s eager step on "
              f"the same card: {base:.1f} ms, {tokens / base * 1e3:.0f} "
              f"tokens/s (a replay of (a)'s captured update "
              f"{PHASE12['replay_ms']:.1f} ms), (a)'s peak {PHASE12['peak']} "
              f"B; DTensor adds {step_ms - base:.1f} ms a step "
              f"({step_ms / base:.3f}x) ({smi})")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    del out, params, opt, tensors
    _fresh_caches()


def grid_on_host():
    """(b): the 2x2 grid as four gloo ranks on the host's CPU, through
    ``torch.distributed.run`` and the launcher."""
    from repro_torch.launch.mesh import free_port

    argv = [sys.executable, "-m", "torch.distributed.run",
            "--nproc-per-node", "4", "--master-port", str(free_port()),
            "-m", "repro_torch.launch.train"] + GRID_ARGV
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=300,
                          cwd=ROOT, env=env)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"(b) exit {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    if proc.stdout.count('"history"') != 1:
        raise AssertionError(f"(b) printed {proc.stdout!r}")
    out = json.loads(proc.stdout[proc.stdout.index("{"):])
    losses = [h["loss"] for h in out["history"]]
    if out.get("mesh") != {"data": 2, "model": 2} or \
            not np.isfinite(losses).all():
        raise AssertionError(f"(b) {out}")
    print(f"(b) CPU (the host, 4 gloo ranks): python -m torch.distributed.run"
          f" --nproc-per-node 4 -m repro_torch.launch.train "
          f"{' '.join(GRID_ARGV)}: exit 0 in {secs:.1f} s, the JSON printed "
          f"once, mesh {out['mesh']}, losses {losses}, "
          f"{out['tokens_per_s']:.0f} tokens/s on the CPU")


def sharded_training_path(device, smi):
    """Phase 13: (a) the sharded step on a 1x1 NCCL mesh at full width and
    depth against phase 12 (a), (b) the 2x2 grid on the host's CPU. Driven
    with the launch counts set to 0: returns them (the path launches
    none)."""
    import torch

    _phase(f"13. sharded training: {TRAIN_ARCH} on a 1x1 NCCL process mesh "
           f"against phase 12, the 2x2 grid on the host ({smi})")
    print(f"torch {torch.__version__}")
    _fresh_caches()
    _reset_launches()
    sharded_full(device, smi)
    grid_on_host()
    launches = _read_launches()
    if any(launches.values()):
        raise AssertionError(f"the sharded training path launched "
                             f"{launches}")
    print(f"launches on the sharded training path: {launches} (the index "
          f"embedding on DTensors)")
    return launches


# Phase 14: the dry-run on a fake world (nothing allocated on the card)
DRYRUN_WORKERS = 8  # the host's cores; each cell is CPU-bound
DRYRUN_POD_SHAPES = ("decode_32k", "long_500k")  # the 2x16x16 cells run
DRYRUN_COST = {"train": 0, "prefill": 1, "decode": 2}  # longest first


def _dryrun_cell(arch, shape, multi_pod):
    """Phase 14 (a)'s worker: one cell of `launch.dryrun` on the card's
    device (its JSON written under artifacts/dryrun_torch/), with the
    card's allocated bytes before and after and its peak."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    from repro_torch.configs import SHAPES_BY_NAME, get_arch
    from repro_torch.launch import dryrun

    return _card_bytes(dryrun.run_cell, get_arch(arch),
                       SHAPES_BY_NAME[shape], multi_pod=multi_pod,
                       device="cuda")


_WORLD_PEAK = []  # a worker's peak over its first fake world and mesh


def _gb(n):
    return f"{n / 1e9:.3f} GB"


_POOL = []  # phases 14 and 16's worker processes, shut down by `main`


def _dryrun_pool():
    """`DRYRUN_WORKERS` spawned processes, started once for phases 14 and
    16."""
    import concurrent.futures as futures
    import multiprocessing

    if not _POOL:
        _POOL.append(futures.ProcessPoolExecutor(
            DRYRUN_WORKERS, mp_context=multiprocessing.get_context("spawn")))
    return _POOL[0]


def _card_bytes(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` in a worker, with the card's allocated bytes before
    and after it and its peak over it, and the worker's peak over its
    first fake world and mesh; raises if it launched a kernel (the
    worker's own counts, set to 0 just before and read just after)."""
    import torch

    from repro_torch.launch import dryrun

    torch.cuda.set_device(0)
    if not _WORLD_PEAK:  # the process's first world and mesh, on their own
        torch.cuda.reset_peak_memory_stats()
        with dryrun.fake_world(256):
            dryrun.mesh_of((16, 16), "cuda")
        _WORLD_PEAK.append(torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    _reset_launches()
    res = fn(*args, **kwargs)
    launches = _read_launches()
    if torch.cuda.current_device() != 0:  # rank 0 of a fake world
        raise AssertionError(f"the fake world set cuda:"
                             f"{torch.cuda.current_device()}")
    if any(launches.values()):
        raise AssertionError(f"{fn.__name__} launched {launches}")
    return (dataclasses.asdict(res), before, torch.cuda.memory_allocated(),
            torch.cuda.max_memory_allocated(), _WORLD_PEAK[0])


def dryrun_cells(smi):
    """(a): every arch x applicable shape on 16x16 and the decode cells on
    2x16x16, in `DRYRUN_WORKERS` spawned processes (each cell its own fake
    world)."""
    from repro_torch.configs import ARCHS, SHAPES_BY_NAME, applicable_shapes

    cells = [(cfg.name, cell.name, multi) for multi in (False, True)
             for cfg in ARCHS.values() for cell in applicable_shapes(cfg)
             if not multi or cell.name in DRYRUN_POD_SHAPES]
    order = sorted(cells, key=lambda c: (
        c[2], DRYRUN_COST[SHAPES_BY_NAME[c[1]].kind]))
    t0 = time.perf_counter()
    results = list(_dryrun_pool().map(_dryrun_cell, *zip(*order)))
    secs = time.perf_counter() - t0
    rows, failed = [], []
    for (arch, shape, multi), (res, before, after, peak, world) in zip(
            order, results):
        mem, cost, coll = res["memory"], res["cost"], res["collectives"]
        print(f"[{'OK ' if res['ok'] else 'FAIL'}] {arch:28s} {shape:12s} "
              f"{res['mesh']:8s} {res['seconds']:7.1f}s "
              f"flops={cost.get('flops', 0):.3e} "
              f"coll={coll.get('total_bytes', 0):.3e} "
              f"args={_gb(mem.get('argument_size_in_bytes', 0))} "
              f"temp={_gb(mem.get('temp_size_in_bytes', 0))} card "
              f"{before} -> {after} B (peak {peak} B; the worker's first "
              f"world and mesh {world} B) {res['error'] or ''}")
        if not res["ok"] or after != before:
            failed.append((arch, shape, res["mesh"]))
        rows.append(res)
    print(f"(a) {len(cells)} cells ({sum(not c[2] for c in cells)} on "
          f"16x16, {sum(c[2] for c in cells)} on 2x16x16: "
          f"{', '.join(DRYRUN_POD_SHAPES)}) in {secs:.1f} s on "
          f"{DRYRUN_WORKERS} processes ({smi})")
    if failed:
        raise AssertionError(f"(a) dry-run cells failed or moved the card's "
                             f"memory: {failed}")
    return rows


def _fake_counts(cfg, cell, rt, device, fn=None, shape=(1, 1)):
    """`launch.dryrun`'s counts of `cell`'s step (or of ``fn(params,
    batch)``, a part of the train step) on a fake world of `shape`, and
    the counter."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import dryrun

    with dryrun.fake_world(int(np.prod(shape))):
        mesh = dryrun.mesh_of(shape, device)
        fake = FakeTensorMode(allow_non_fake_inputs=False)
        step, args = dryrun.step_inputs(cfg, cell, rt, mesh=mesh,
                                        device=device, fake_mode=fake)
        if fn is not None:
            step, args = fn, (args[0], args[2])
        counter = dryrun.StepCounter(fake)
        return dryrun.count_step(step, args, counter), counter


def dryrun_ground_truth(device, smi):
    """(b): tinyllama-1.1b's train step at phase 12 (a)'s 8 x 512 on a fake
    1x1 world against phase 12's real tensors and peaks, and its FLOPs
    against the same counter over the real unsharded step on the card."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.models import Runtime, build_model, lm_loss, \
        param_shapes
    from repro_torch.train.loop import value_and_grad

    cfg = get_arch(TRAIN_ARCH)
    n_params = sum(t.numel() for t in param_shapes(cfg).parameters())
    cell = ShapeCell("train_8x512", TRAIN_SEQ, TRAIN_BATCH, "train")
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    res = dryrun.run_cell(cfg, cell, rt=Runtime(), save=False,
                          device=device, mesh_shape=(1, 1))
    if not res.ok:
        raise AssertionError(f"(b) {res.error}")
    fake_peak = torch.cuda.max_memory_allocated(device) - before
    args = res.memory["argument_size_in_bytes"]
    want = PHASE12["argument_bytes"]
    print(f"(b) dry-run of {TRAIN_ARCH} {TRAIN_BATCH} x {TRAIN_SEQ} on a "
          f"fake 1x1 world in {res.seconds} s (the card's peak over it "
          f"{fake_peak} B): argument bytes {int(args)}, phase 12 (a)'s "
          f"parameters, optimizer state and batch {want} (equal: "
          f"{args == want})")
    if args != want:
        raise AssertionError(f"(b) argument bytes {args} against {want}")
    step, real_args = dryrun.step_inputs(cfg, cell, Runtime(), device=device)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    real = dryrun.count_step(step, real_args, dryrun.StepCounter())
    torch.cuda.synchronize(device)
    real_peak = torch.cuda.max_memory_allocated(device) - base
    del step, real_args
    _fresh_caches()
    print(f"(b) FLOPs: dry-run {res.cost['flops']:.6e}, the real unsharded "
          f"step on the card under the same counter "
          f"{real['cost']['flops']:.6e} (equal: "
          f"{res.cost['flops'] == real['cost']['flops']}); 6 * N * tokens "
          f"= {6 * n_params * TRAIN_BATCH * TRAIN_SEQ:.6e}")
    if res.cost["flops"] != real["cost"]["flops"]:
        raise AssertionError("(b) dry-run FLOPs differ from the real step's")
    predicted = args + res.memory["temp_size_in_bytes"]
    print(f"(b) predicted peak (arguments + temp) {int(predicted)} B; "
          f"phase 12 (a)'s max_memory_allocated {PHASE12['peak']} B (ratio "
          f"{predicted / PHASE12['peak']:.4f}); the real step above, from "
          f"zeros: its counter's own peak {int(real['memory']['temp_size_in_bytes'] + args)} B, "
          f"max_memory_allocated over it {real_peak + base} B (ratio "
          f"{predicted / (real_peak + base):.4f}) ({smi})")
    for shape in ((16, 16),):  # B = 8 < 16: the batch replicated
        grid, counter = _fake_counts(cfg, cell, Runtime(), device,
                                     shape=shape)
        print(f"(b) what the grid moves, {TRAIN_ARCH} {TRAIN_BATCH} x "
              f"{TRAIN_SEQ} on a fake {dryrun.mesh_name(shape)} world, per "
              f"device: collectives {grid['collectives']}; FLOPs "
              f"{grid['cost']['flops']:.4e}; argument bytes "
              f"{int(grid['memory']['argument_size_in_bytes'])}, temp "
              f"{int(grid['memory']['temp_size_in_bytes'])}; by site "
              f"(kind, result shape, dtype: count, MB), largest first:")
        sites = sorted(counter.collective_sites.items(),
                       key=lambda kv: -kv[1][1])
        for (kind, shapes, dtype), (count, total) in sites[:12]:
            print(f"    {kind} {shapes} {dtype}: {count} x, "
                  f"{total / 1e6:.3f} MB")
    model = build_model(cfg)
    for remat, measured in PHASE12["remat_peaks"].items():
        rt = Runtime(remat=remat)

        def fwd_bwd(params, batch):
            return value_and_grad(lambda p: lm_loss(model, p, batch, rt),
                                  params)

        fb, _ = _fake_counts(cfg, cell, rt, device, fwd_bwd)
        pred = fb["memory"]["argument_size_in_bytes"] + \
            fb["memory"]["temp_size_in_bytes"]
        print(f"(b) remat {remat}: forward + backward predicted peak "
              f"{int(pred)} B, phase 12 (c)'s max_memory_allocated "
              f"{measured} B (ratio {pred / measured:.4f}); FLOPs "
              f"{fb['cost']['flops']:.4e}")


def dryrun_path(device, smi):
    """Phase 14: (a) the dry-run's cells on a fake world, (b) its counts
    against phase 12's real tensors, peaks and FLOPs. Driven with the
    launch counts set to 0: returns them (a dry-run launches nothing)."""
    import torch

    _phase(f"14. the dry-run: every arch x shape on a fake 16x16 world, the "
           f"decode cells on 2x16x16, and tinyllama against phase 12 "
           f"({smi})")
    print(f"torch {torch.__version__}")
    _fresh_caches()
    _reset_launches()
    dryrun_cells(smi)
    start_hillclimb()  # phase 16's runs, in the workers from here on
    dryrun_ground_truth(device, smi)
    launches = _read_launches()
    if any(launches.values()):
        raise AssertionError(f"the dry-run launched {launches}")
    return launches


# Phase 16: the hill-climb on the fake 16x16 world
HILLCLIMB_PHASES = (1, 2, 3)
LEVERS = ("seq_shard_attention", "moe_ep_constraint")
HILLCLIMB_COST = {"llama4-maverick-400b-a17b": 0, "deepseek-v2-lite-16b": 1,
                  "smollm-360m": 2}  # longest first


def _hillclimb_run(phase, index):
    """Phase 16's worker: one run of the hill-climb's table on the card's
    device (its JSON written under artifacts/dryrun_torch/ by its tag)."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    from repro_torch.tools import hillclimb

    return _card_bytes(hillclimb.run, *hillclimb.PHASES[phase][index],
                       device="cuda")


def _lever_twin(run, runs):
    """The run of `runs` (or phase 14's baseline of the cell, tag
    ``baseline``) that is `run` with its layout levers off, or None."""
    arch, shape, _, rtkw, flags = run
    off = {k: v for k, v in rtkw.items() if k not in LEVERS}
    for other in runs:
        if other[:2] == (arch, shape) and other[3] == off and \
                other[4] == flags:
            return other[2]
    if off == {"remat": "dots"} and not flags:  # `default_runtime`'s
        return "baseline"
    return None


def _lever_counts(res):
    return (res["memory"].get("temp_size_in_bytes"),
            {k: v for k, v in res["collectives"].items() if k != "op_count"})


_HILLCLIMB = {}  # phase 16's runs: (phase, index) -> future; the start


def start_hillclimb():
    """Submit phase 16's runs to phase 14's worker processes, longest
    first, as soon as phase 14's cells have written the baselines: they
    run while the main process does phase 14 (b) and phase 15."""
    from repro_torch.tools import hillclimb

    pool = _dryrun_pool()
    runs = [(ph, i) for ph in HILLCLIMB_PHASES
            for i in range(len(hillclimb.PHASES[ph]))]
    _HILLCLIMB["start"] = time.perf_counter()
    for ph, i in sorted(runs, key=lambda r: HILLCLIMB_COST.get(
            hillclimb.PHASES[r[0]][r[1]][0], 3)):
        _HILLCLIMB[ph, i] = pool.submit(_hillclimb_run, ph, i)


def hillclimb_path(device, smi):
    """Phase 16: the hill-climb's runs of `HILLCLIMB_PHASES` in phase 14's
    worker processes (submitted by `start_hillclimb`), each `show` line
    against phase 14's baseline; every run ``ok`` with the card's memory
    unchanged and no launch in its worker, and each lever's counts unlike
    those of the same run without it. Returns the main process's launch
    counts over the phase (set to 0 just before, read just after: the
    hill-climb runs in the workers and launches nothing)."""
    from repro_torch.launch.dryrun import CellResult
    from repro_torch.tools import hillclimb

    _phase(f"16. the hill-climb: phases {HILLCLIMB_PHASES} of "
           f"`repro_torch.tools.hillclimb` on the fake 16x16 world ({smi})")
    _fresh_caches()
    _reset_launches()
    if "start" not in _HILLCLIMB:
        start_hillclimb()
    runs = [(ph, i) for ph in HILLCLIMB_PHASES
            for i in range(len(hillclimb.PHASES[ph]))]
    results = {r: _HILLCLIMB[r].result() for r in runs}
    secs = time.perf_counter() - _HILLCLIMB["start"]
    table = [hillclimb.PHASES[ph][i] for ph, i in runs]
    by_tag, failed = {}, []
    for (ph, i), run in zip(runs, table):
        res, before, after, peak, world = results[ph, i]
        arch, shape, tag = run[:3]
        print(f"{arch} {shape} -> {tag} (phase {ph}; card {before} -> "
              f"{after} B, peak {peak} B)")
        base = hillclimb._baseline(arch, shape)
        hillclimb.show(CellResult(**res), base, colls=True)
        by_tag[arch, tag] = res
        if base is not None:
            by_tag.setdefault((arch, "baseline"), base)
        if not res["ok"] or after != before:
            failed.append((arch, tag))
    if failed:
        raise AssertionError(f"hill-climb runs failed or moved the card's "
                             f"memory: {failed}")
    same, untwinned = [], []
    for run in table:
        if not any(run[3].get(k) for k in LEVERS):
            continue
        twin = _lever_twin(run, table)
        if twin is None or (run[0], twin) not in by_tag:
            untwinned.append((run[0], run[2]))
            continue
        got, off = (_lever_counts(by_tag[run[0], t]) for t in (run[2], twin))
        print(f"lever {run[0]} {run[2]} against {twin}: temp "
              f"{_gb(got[0])} / {_gb(off[0])}; collectives {got[1]} / "
              f"{off[1]}")
        if got == off:
            same.append((run[0], run[2], twin))
    print(f"lever runs with no lever-off twin in the table: {untwinned}")
    launches = _read_launches()
    print(f"{len(runs)} runs in {secs:.1f} s on {DRYRUN_WORKERS} processes "
          f"from their submission after phase 14 (a), beside phase 14 (b) "
          f"and phase 15 in the main process ({smi})")
    if same:
        raise AssertionError(f"a layout lever changed no count: {same}")
    if any(launches.values()):
        raise AssertionError(f"the hill-climb launched {launches}")
    return launches


# Phase 15: the four examples on the card
EXAMPLES = (("quickstart", []), ("spmv_pipeline", []),
            ("serve_decode", []),
            ("train_tinylm", ["--steps", "10"]))


def examples_path(device, smi):
    """Phase 15: each example's `main` as ``python -m
    repro_torch.examples.<name>`` calls it (in process, so that the
    launches count), with the launch counts set to 0 before and read after
    each; then what each computed through a kernel held to its plain
    version on the same inputs (`_check_example`)."""
    import importlib
    import shutil

    _phase(f"15. the examples on the card ({smi})")
    ckpt = ROOT / "build" / f"tinylm-ckpt-{os.getpid()}"
    launches = {}
    try:
        for name, argv in EXAMPLES:
            if name == "train_tinylm":
                argv = argv + ["--ckpt-dir", str(ckpt)]
            module = importlib.import_module(f"repro_torch.examples.{name}")
            _fresh_caches()
            _reset_launches()
            t0 = time.perf_counter()
            out = module.main(argv)
            counts = _read_launches()
            print(f"python -m repro_torch.examples.{name} {' '.join(argv)}"
                  f": returned in {time.perf_counter() - t0:.1f} s, "
                  f"launches {counts}", flush=True)
            _add(launches, counts)
            _check_example(name, module, out, device)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    if launches["sell_spmv"] < 1 or launches["coalesced_gather"] < 1:
        raise AssertionError(f"the examples launched {launches}")
    return launches


def _check_example(name, module, out, device):
    """Phase 15's check of one example's results (no launch counted: the
    plain versions launch no kernel). quickstart: both SpMV errors against
    dense below TOL, the gather exact; spmv_pipeline: each matrix's
    |A x|/|x| against the same power iteration on the reference backend;
    serve_decode: the paged attention against the same query and cache
    through the ``index`` gather; train_tinylm: finite losses, the update
    captured."""
    import torch

    from repro_torch.core.engine import get_engine
    from repro_torch.models.paged_kv import paged_attention

    if name == "quickstart":
        if not (out["kernel_err"] < TOL and out["coalesced_err"] < TOL
                and out["gather_exact"]):
            raise AssertionError(f"quickstart on the card: {out}")
        print(f"  quickstart: sell_spmv max err vs dense "
              f"{out['kernel_err']:.3e}, the coalesced path "
              f"{out['coalesced_err']:.3e} (< {TOL}); the gather exact")
    elif name == "spmv_pipeline":
        for matrix, r in out.items():
            ref = module.power_iteration(
                get_engine(r["sell"], block_rows=8, backend="reference",
                           device=device), n_iters=10)
            err = _max_err(torch.tensor(r["lam"]), torch.tensor(ref), TOL)
            print(f"  spmv_pipeline {matrix}: |A x|/|x| {r['lam']!r} "
                  f"against the reference backend's {ref!r}: abs err "
                  f"{err:.3e} (tolerance {TOL} + {TOL}*|ref|)")
    elif name == "serve_decode":
        ref = paged_attention(out["q"], out["cache"],
                              n_heads=out["n_heads"], backend="index")
        if not bool(torch.isfinite(out["out"]).all()):
            raise AssertionError("serve_decode's paged attention is not "
                                 "finite")
        err = _max_err(out["out"], ref, TOL)
        print(f"  serve_decode: paged attention {tuple(out['out'].shape)} "
              f"against the index gather's max abs err {err:.3e} "
              f"(tolerance {TOL} + {TOL}*|ref|)")
    elif name == "train_tinylm":
        losses = [h["loss"] for h in out["history"]]
        if not losses or not np.isfinite(losses).all() or \
                not out["captured"]:
            raise AssertionError(f"train_tinylm's losses {losses}, "
                                 f"captured {out['captured']}")
        print(f"  train_tinylm: {len(losses)} logged losses, all finite, "
              f"final {out['final_loss']!r}; the update captured (remat "
              f"dots)")


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch finds no CUDA device")
    if not (SRC / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke: {SRC / 'repro_torch'} is missing; run "
                         f"from the root of a checkout")
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    seconds = {}

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[phase] = round(time.perf_counter() - t0, 1)
        return out

    smi = timed(1, environment_and_build)
    worst = timed(2, kernels_against_plain, device)
    # Every served path runs with the counts set to 0 just before and read
    # just after; the kernels line adds up the served paths. The check and
    # timing runs of phases 6, 7, 9 and 10 are counted apart.
    served, checks = {}, {}
    out, served["3 serve --spmv + matvec"] = timed(3, main_path, device, smi)
    rows = timed(4, times, out, smi)
    del out
    served["5 serve --paged"] = timed(5, paged_path, device, smi)
    rows["sell_spmv"], err, served["6 serve --solve"], checks[
        "6 extra solves"] = timed(6, solver_path, device, smi)
    worst["sell_spmv"] = max(worst["sell_spmv"], err)
    served["7 serve --stream"], checks["7 checks and timing"] = timed(
        7, stream_path, device, smi)
    served["8 serve --schedule-cache/--chaos"] = timed(
        8, store_and_chaos, device, smi)
    served["9 serve --tune"], checks["9 measured searches and checks"], \
        errs = timed(9, tuner_path, device, smi)
    for name, err in errs.items():
        worst[name] = max(worst[name], err)
    served["10 serve --mesh (--chaos)"], checks["10 sharded engine and cg"] \
        = timed(10, sharded_path, device, smi)
    served["11 serve --arch llama3-8b"], served[
        "11 generate, embed_backend cuda, captured"] = timed(
            11, generation_path, device, smi)
    served["12 train (no kernel on this path)"] = timed(
        12, training_path, device, smi)
    served["13 train on a process mesh (no kernel on this path)"] = timed(
        13, sharded_training_path, device, smi)
    try:  # phases 14 and 16 share their worker processes
        served["14 the dry-run (no kernel on this path)"] = timed(
            14, dryrun_path, device, smi)
        served["15 the examples"] = timed(15, examples_path, device, smi)
        served["16 the hill-climb (no kernel on this path)"] = timed(
            16, hillclimb_path, device, smi)
    finally:
        for pool in _POOL:
            pool.shutdown(cancel_futures=True)
    launches = {}
    for path, counts in served.items():
        print(f"launches, {path}: {counts}")
        _add(launches, counts)
    for path, counts in checks.items():
        print(f"launches, {path} (not in the kernels line): {counts}")
    print(f"kernel launches over the served paths: {launches}")
    kernels = [
        dict(name=name, route="cuda", **KERNELS[name],
             launches=launches[name], max_abs_err=worst[name], **rows[name])
        for name in KERNELS
    ]
    print(f"\nsmoke finished in {time.perf_counter() - t_start:.1f}s; "
          f"seconds by phase {seconds}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
