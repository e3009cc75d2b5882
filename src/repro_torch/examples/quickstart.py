"""Quickstart: the paper's mechanism end to end in five minutes (port of
``examples/quickstart.py``).

1. Build a sparse matrix, convert to SELL (paper Fig. 1).
2. Run SpMV through the coalesced indirect-access data path and the
   `sell_spmv` kernel (its plain version on the CPU); verify against dense.
   Gather rows through the `coalesced_gather` kernel.
3. Model the adapter variants on the matrix's real index stream (Fig. 3
   row).

Run: PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.coalescer import coalesce_stats
from repro_torch.core.formats import csr_to_sell, dense_to_csr, \
    sell_index_stream
from repro_torch.core.indirect_stream import coalesced_gather
from repro_torch.core.perfmodel import indirect_stream_perf
from repro_torch.core.runtime import resolve_device
from repro_torch.core.spmv import _sell_padded, spmv_sell_coalesced
from repro_torch.kernels import ops as kops


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Runs the example; returns the two SpMV errors against dense and
    whether the gather was exact."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--device", type=str, default="cuda",
                    choices=["cuda", "cpu"])
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)

    # 1. a banded matrix (high index locality, like af-shell10)
    n = 512
    dense = np.zeros((n, n))
    for i in range(n):
        lo, hi = max(0, i - 12), min(n, i + 12)
        cols = rng.choice(np.arange(lo, hi), size=8, replace=False)
        dense[i, cols] = rng.standard_normal(8)
    sell = csr_to_sell(dense_to_csr(dense), width_multiple=8)
    x_host = rng.standard_normal(n).astype(np.float32)
    x = torch.as_tensor(x_host, device=dev)
    want = dense @ x_host

    # 2a. SpMV through the coalesced data path (the semantics oracle)
    y = spmv_sell_coalesced(sell, x, window=256, block_rows=8)
    err = np.abs(y.cpu().numpy() - want).max()
    print(f"coalesced SELL SpMV max err vs dense: {err:.2e}")

    # 2b. the sell_spmv kernel (its plain version on the CPU)
    ci, va, _ = _sell_padded(sell)
    y_k = kops.sell_spmv(torch.as_tensor(ci, device=dev),
                         torch.as_tensor(va.astype(np.float32), device=dev),
                         x, cols_per_chunk=8, block_rows=8)
    err_k = np.abs(y_k.cpu().numpy()[: sell.n_rows] - want).max()
    which = "CUDA" if dev.type == "cuda" else "plain"
    print(f"{which} sell_spmv kernel   max err vs dense: {err_k:.2e}")

    # 2c. the standalone coalesced gather (what embedding/MoE/paged-KV use);
    # backend auto: the coalesced_gather kernel on the card, the coalesced
    # schedule in torch on the CPU
    table_host = rng.standard_normal((4096, 64)).astype(np.float32)
    idx_host = rng.integers(0, 4096, 2048).astype(np.int32)
    g = coalesced_gather(torch.as_tensor(table_host, device=dev),
                         torch.as_tensor(idx_host, device=dev),
                         backend="auto")
    backend = "cuda" if dev.type == "cuda" else "coalesced"
    exact = bool((g.cpu().numpy() == table_host[idx_host]).all())
    print(f"coalesced_gather ({backend}) exact: {exact}")

    # 3. what the coalescer buys on this matrix's real index stream
    stream = sell_index_stream(sell)
    wide, rate = coalesce_stats(stream, window=256, block_rows=8)
    print(f"\nindex stream: {len(stream)} requests -> {wide} wide accesses "
          f"(coalesce rate {rate:.2f})")
    for variant in ("MLPnc", "SEQ256", "MLP256"):
        r = indirect_stream_perf(stream, variant)
        print(f"  {variant:7s}: {r.effective_bw_gbps:6.2f} GB/s effective "
              f"({r.bottleneck}-bound)")
    return dict(coalesced_err=float(err), kernel_err=float(err_k),
                gather_exact=exact)


if __name__ == "__main__":
    main()
