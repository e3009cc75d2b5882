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
   metadata, float32 and bfloat16 values, k in {1, 7, 33, 64, 65, 128,
   200} (k not a multiple of 4 or 8; k = 200 takes two 128-column grid
   columns), each at buffer_depth 1, 2 and 4. Tolerance
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
   before and `coalesced_gather`'s read just after; serve itself gates the
   paged attention against dense SDPA at 1e-5 and the decode steps after
   the first at zero schedule builds. Then one decode step split on the
   host clock (draws, appends, gathers, attention, the dense parity
   reference), the gather kernel's own share in CUDA events, and the
   device's busy share and time by kernel from torch.profiler.

Phase 3 reads the SELL kernels' launch counts and phase 5 the gather's.
The line before the card line is a JSON object with one entry per kernel;
the last line is ``{"ok": true, "device": {...}}``. Needs one CUDA device.
"""
import dataclasses
import json
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
KS = (1, 7, 33, 64, 65, 128, 200)
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


def _max_err(got, want):
    """Max |got - want|; raises when any element breaks the tolerance."""
    err = (got.float() - want.float()).abs()
    bad = err > TOL + TOL * want.float().abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{int(bad.sum())} elements beyond 1e-5 + 1e-5*|ref| "
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


def main_path(device):
    import torch

    from repro_torch.core import matrices
    from repro_torch.core.engine import SpMVEngine, clear_engine_cache, \
        clear_schedule_cache, get_engine
    from repro_torch.core.formats import dense_to_csr
    from repro_torch.kernels.coalesced_gather import coalesced_gather_cuda
    from repro_torch.kernels.sell_spmm import sell_spmm_cuda
    from repro_torch.kernels.sell_spmv import sell_spmv_cuda
    from repro_torch.launch import serve

    _phase("3. main path: serve --spmv banded (in process) + matvec")
    clear_engine_cache()
    clear_schedule_cache()
    argv = ["--spmv", "banded", "--spmv-rows", str(MAIN_ROWS), "--batch",
            str(MAIN_BATCH), "--requests", "8"]
    print("serve " + " ".join(argv))
    sell_spmv_cuda.launches = 0
    sell_spmm_cuda.launches = 0
    coalesced_gather_cuda.launches = 0
    out = serve.run(serve.build_parser().parse_args(argv))
    engine = out["engine"]
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(
        engine.n_cols).astype(np.float32), device=device)
    y = engine.finalize(engine.matvec(x))
    launches = {"sell_spmv": sell_spmv_cuda.launches,
                "sell_spmm": sell_spmm_cuda.launches}
    print(f"kernel launches on the main path: {launches}")
    for name, n in launches.items():
        if n < 1:
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
    # card, then the fused kernel up to the finalize sync.
    stage_s, run_s = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        staged = engine.stage(out["batch"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        engine.finalize(engine.dispatch(staged))
        stage_s.append(t1 - t0)
        run_s.append(time.perf_counter() - t1)
    st, rn = np.median(stage_s) * 1e3, np.median(run_s) * 1e3
    print(f"one request (median of 5): stage {st:.3f} ms (host->device copy "
          f"of {out['batch'].nbytes} B), dispatch+finalize {rn:.3f} ms, "
          f"the kernel's part {rn / (st + rn) * 100:.1f}% of the request")
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


def paged_path(device):
    import torch

    from repro_torch.core.engine import clear_engine_cache, \
        clear_schedule_cache
    from repro_torch.core.gather_engine import clear_gather_engine_cache
    from repro_torch.kernels.coalesced_gather import coalesced_gather_cuda
    from repro_torch.kernels.sell_spmm import sell_spmm_cuda
    from repro_torch.kernels.sell_spmv import sell_spmv_cuda
    from repro_torch.launch import serve

    _phase("5. paged path: serve --arch llama3-8b --paged (in process)")
    clear_engine_cache()
    clear_schedule_cache()
    clear_gather_engine_cache()
    torch.cuda.empty_cache()
    print("serve " + " ".join(PAGED_ARGV))
    torch.cuda.reset_peak_memory_stats(device)
    sell_spmv_cuda.launches = 0
    sell_spmm_cuda.launches = 0
    coalesced_gather_cuda.launches = 0
    out = serve.run(serve.build_parser().parse_args(PAGED_ARGV))
    launches = coalesced_gather_cuda.launches
    print(f"kernel launches on the paged path: coalesced_gather {launches}")
    if launches < 1:
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
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
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
        return
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    top = sorted(by_name.items(), key=lambda kv_: -kv_[1])[:6]
    print(f"  torch.profiler over one step: device busy {busy / 1e3:.3f} ms "
          f"of {wall_us / 1e3:.3f} ms wall ({busy / wall_us * 100:.1f}%), "
          f"{len(spans)} device events; by name (ms): " + "; ".join(
              f"{name[:60]} {t / 1e3:.3f}" for name, t in top))


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
    smi = environment_and_build()
    worst = kernels_against_plain(device)
    out, launches = main_path(device)
    rows = times(out, smi)
    del out
    launches["coalesced_gather"] = paged_path(device)
    kernels = [
        dict(name=name, route="cuda", **KERNELS[name],
             launches=launches[name], max_abs_err=worst[name], **rows[name])
        for name in KERNELS
    ]
    print(f"\nsmoke finished in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
