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
   window: the large-shared-memory path), packed and unpacked metadata,
   float32 and bfloat16 values, k in {1, 7, 8, 64}, plus k_tile=32 on the
   random plan (windows staged in groups of warps). Tolerance
   ``|kernel - plain| <= 1e-5 + 1e-5 * |plain|`` elementwise: float32 sums
   of at most ~40 products per row, taken in another order.
3. The main path: `repro_torch.launch.serve` with ``--spmv banded
   --spmv-rows 1000000 --batch 64 --requests 8`` in process, then one
   full-size `engine.matvec`, with both kernels' launch counts set to 0
   just before and read just after; the served batch and the matvec are
   checked against the reference backend on the card, and a small matrix
   against a float64 dense product.
4. Times at the main path's shapes (CUDA events, warmed up): each kernel,
   its plain version, a PyTorch sparse-CSR product on the same matrix (a
   yardstick only), and the bound: the bytes the function must move over
   3.35 TB/s, or its float32 operations over 67 TFLOP/s, whichever is
   larger. The bytes are the matrix's (each nonzero's value and a 4-byte
   index, the tags), the right-hand side read once and the output written
   once; the operations are 2 per nonzero and column. The padding the plan
   adds is not counted there; the plan's own bytes are printed beside it.

The line before the card line is a JSON object with one entry per kernel;
the last line is ``{"ok": true, "device": {...}}``. Needs one CUDA device.
"""
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
KS = (1, 7, 8, 64)
KERNELS = {
    "sell_spmv": dict(
        source="src/repro_torch/kernels/csrc/sell_spmv.cu",
        replaces="src/repro/kernels/sell_spmv.py:472",
    ),
    "sell_spmm": dict(
        source="src/repro_torch/kernels/csrc/sell_spmm.cu",
        replaces="src/repro/kernels/sell_spmm.py:176",
    ),
}


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


def _time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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
        m = re.search(r"sell_kernelI(f|13__nv_bfloat16)Lb([01])", line)
        if line.startswith("== "):
            source = line[3:]
        elif "Compiling entry" in line and m:
            entry = (f"{source} sell_kernel<"
                     f"{'f32' if m.group(1) == 'f' else 'bf16'},"
                     f"{'packed' if m.group(2) == '1' else 'unpacked'}>")
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
                y = sell_spmv_cuda(None, values, x, plan=plan)
                torch.cuda.synchronize()
                err = _max_err(y, sell_spmv_plain(None, values, x, plan=plan))
                worst["sell_spmv"] = max(worst["sell_spmv"], err)
                errs = []
                cases = [(k, 8) for k in KS]
                if family == "random":
                    cases.append((64, 32))  # staged in groups of warps
                for k, kt in cases:
                    Xk = X[:, :k]
                    Y = sell_spmm_cuda(None, values, Xk, plan=plan, k_tile=kt)
                    torch.cuda.synchronize()
                    e = _max_err(Y, sell_spmm_plain(None, values, Xk,
                                                    plan=plan, k_tile=kt))
                    errs.append(f"k={k}/kt={kt}:{e:.1e}")
                    worst["sell_spmm"] = max(worst["sell_spmm"], e)
                print(f"  {tag}: sell_spmv {err:.1e}; sell_spmm "
                      f"{' '.join(errs)}")
            del values
        del va, plans, plan0, x, X
        clear_schedule_cache()
        torch.cuda.empty_cache()
    print(f'kernels: {json.dumps(list(KERNELS))}')
    return worst


def main_path(device):
    import torch

    from repro_torch.core import matrices
    from repro_torch.core.engine import SpMVEngine, clear_engine_cache, \
        clear_schedule_cache, get_engine
    from repro_torch.core.formats import dense_to_csr
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
    out = serve.serve_spmv(serve.build_parser().parse_args(argv))
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
    rows = {}
    for name, kernel, plain, library, rhs, kk in (
        ("sell_spmv", lambda: sell_spmv_cuda(None, values, x, plan=plan),
         lambda: sell_spmv_plain(None, values, x, plan=plan),
         lambda: torch.mv(A, x), x, 1),
        ("sell_spmm",
         lambda: sell_spmm_cuda(None, values, X, plan=plan, k_tile=kt),
         lambda: sell_spmm_plain(None, values, X, plan=plan, k_tile=kt),
         lambda: torch.sparse.mm(A, X), X, k),
    ):
        io_bytes = rhs.numel() * 4 + csr.n_rows * kk * 4
        nbytes = matrix_bytes + io_bytes
        flops = 2.0 * csr.nnz * kk
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOP_PER_S * 1e3
        rows[name] = dict(
            ms=_time_ms(kernel), plain_ms=_time_ms(plain, iters=5),
            library_ms=_time_ms(library),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
        )
        r = rows[name]
        plan_ms = (plan_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
        print(f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, torch sparse CSR {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}: {nbytes} B, "
              f"{flops:.3g} flop) -> {r['bound_ms'] / r['ms'] * 100:.1f}% "
              f"of the bound; the plan's own bytes once {plan_ms:.4f} ms")
    return rows


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
