"""Serving example: batched decode with (a) the dense KV cache and (b) the
paged KV cache whose page gather runs through the paper's coalescer —
shared prefixes across requests coalesce into single page fetches (port of
``examples/serve_decode.py``). The page gather takes backend ``auto``: the
`coalesced_gather` kernel on the card, the coalesced schedule in torch on
the CPU.

Run: PYTHONPATH=src python -m repro_torch.examples.serve_decode
         [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.coalescer import coalesce_stats
from repro_torch.core.runtime import resolve_device
from repro_torch.launch.serve import generate
from repro_torch.models import Runtime, build_model, make_input_batch
from repro_torch.models.paged_kv import alloc_paged, append_token, \
    paged_attention


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Runs the example; returns the paged decode's query, cache, head
    count and output."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.serve_decode")
    ap.add_argument("--device", type=str, default="cuda",
                    choices=["cuda", "cpu"])
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = get_arch("tinyllama-1.1b").reduced()
    model = build_model(cfg)
    rt = Runtime()
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)

    # (a) dense-cache batched generation
    batch = make_input_batch(cfg, 4, 12, device=dev)
    t0 = time.time()
    out = generate(model, params, batch["tokens"], max_new_tokens=24, rt=rt,
                   extras_batch=batch)
    dt = time.time() - t0
    print(f"dense cache: generated {out.shape[0]}x{out.shape[1]} tokens "
          f"in {dt:.2f}s")

    # (b) paged KV with coalesced page gather + shared-prefix reuse
    B, n_kv, hd, H = 8, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_heads
    block = 4
    cache = alloc_paged(n_pages=256, block=block, n_kv=n_kv, hd=hd,
                        batch=B, max_len=32, dtype=torch.float32, device=dev)
    # simulate a shared system-prompt prefix: all requests point at the same
    # first two physical pages
    cache.page_table[:, :2] = torch.tensor([0, 1], dtype=torch.int32,
                                           device=dev)

    rng = np.random.default_rng(0)
    for _ in range(12):
        k = torch.as_tensor(
            rng.standard_normal((B, n_kv, hd)).astype(np.float32), device=dev)
        v = torch.as_tensor(
            rng.standard_normal((B, n_kv, hd)).astype(np.float32), device=dev)
        cache = append_token(cache, k, v)
    q = torch.as_tensor(
        rng.standard_normal((B, 1, H, hd)).astype(np.float32), device=dev)
    out = paged_attention(q, cache, n_heads=H, backend="auto")
    print(f"paged attention out: {tuple(out.shape)}")

    stream = cache.page_table.cpu().numpy().reshape(-1)
    wide, rate = coalesce_stats(stream, window=stream.size, block_rows=1)
    print(f"page gather: {stream.size} page refs -> {wide} physical fetches "
          f"(prefix sharing coalesced, rate {rate:.2f})")
    return dict(q=q, cache=cache, n_heads=H, out=out)


if __name__ == "__main__":
    main()
