"""Paged KV cache with block-coalesced page gather (port of
`repro.models.paged_kv`).

The paper's wide-block insight maps one-to-one onto paged attention: KV pages
(block_size tokens) are the wide DRAM blocks; a batch of requests' page
tables are the index stream; gathering the pages each decode step is the
indirect access. The per-request page reads are coalesced with the same
schedule machinery (`core.coalescer`), so shared-prefix requests hit the
same pages (CSHR hits = prefix cache reuse).

Gathers resolve through `core.gather_engine.get_gather_engine`, keyed on the
page-table digest: the static allocator keeps the table constant across
`append_token`, so every decode step after the first hits the cached engine
and builds no schedule.

Unlike the JAX package, `append_token` writes the pools **in place**: JAX's
functional update copies the whole pool for every token (136 MB a layer at
llama3-8b's widths with 1,040 pages of 16 tokens). The `PagedKV` it returns
shares its pools with the one it was given, and the old object sees the new
token in its pools (not in its `lengths`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.core.gather_engine import GatherEngine, get_gather_engine


@dataclasses.dataclass
class PagedKV:
    """One layer's paged cache, all tensors on one device.

    pages:      (n_pages, block, n_kv, hd) * 2 (k, v)
    page_table: (B, max_pages) int32 — physical page per request slot
    lengths:    (B,) int32 — tokens written per request
    """

    k_pages: torch.Tensor
    v_pages: torch.Tensor
    page_table: torch.Tensor
    lengths: torch.Tensor
    block: int

    @property
    def n_pages(self) -> int:
        return self.k_pages.shape[0]

    @property
    def device(self) -> torch.device:
        return self.k_pages.device


def alloc_paged(
    n_pages: int, block: int, n_kv: int, hd: int, batch: int,
    max_len: int, dtype=torch.bfloat16, device=None,
) -> PagedKV:
    """Zeroed pools and the static page table on `device` (default the
    card): request b owns pages ``[b * max_pages, (b + 1) * max_pages)``."""
    from repro_torch.core.runtime import resolve_device

    device = resolve_device(device)
    max_pages = -(-max_len // block)
    if batch * max_pages > n_pages:
        raise ValueError(
            f"page pool too small: batch={batch} x max_pages={max_pages} "
            f"(max_len={max_len}, block={block}) needs "
            f"{batch * max_pages} pages, pool has {n_pages}"
        )
    table = (
        torch.arange(batch, device=device)[:, None] * max_pages
        + torch.arange(max_pages, device=device)[None, :]
    ).to(torch.int32)
    return PagedKV(
        k_pages=torch.zeros((n_pages, block, n_kv, hd), dtype=dtype,
                            device=device),
        v_pages=torch.zeros((n_pages, block, n_kv, hd), dtype=dtype,
                            device=device),
        page_table=table,
        lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
        block=block,
    )


def append_token(cache: PagedKV, k: torch.Tensor, v: torch.Tensor) -> PagedKV:
    """Write one token's (B, n_kv, hd) k/v into each request's current page,
    in place (see the module docstring); returns the cache with the lengths
    advanced, sharing the pools."""
    B = k.shape[0]
    pos = cache.lengths.to(torch.int64)
    rows = torch.arange(B, device=cache.device)
    page_idx = cache.page_table[rows, pos // cache.block].to(torch.int64)
    slot = pos % cache.block
    cache.k_pages.index_put_(
        (page_idx, slot), k.to(device=cache.device, dtype=cache.k_pages.dtype)
    )
    cache.v_pages.index_put_(
        (page_idx, slot), v.to(device=cache.device, dtype=cache.v_pages.dtype)
    )
    return dataclasses.replace(cache, lengths=cache.lengths + 1)


def _kv_engine(
    cache: PagedKV, *, window: int = 256, backend: str = "coalesced"
) -> GatherEngine:
    """The page-gather engine for this cache, keyed on the page-table digest.

    The static allocator keeps the table constant across `append_token`, so
    steady-state decode hits the same engine (same schedule, same plan)
    every step. k and v pages share the geometry, hence one engine serves
    both gathers."""
    n_pages, block, n_kv, hd = cache.k_pages.shape
    return get_gather_engine(
        (n_pages, block * n_kv * hd),
        cache.page_table.reshape(-1),
        window=window,
        block_rows=1,
        backend=backend,
        device=cache.device,
    )


def gather_kv(
    cache: PagedKV, *, window: int = 256, backend: str = "coalesced"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialize (B, max_len, n_kv, hd) k/v via block-coalesced page gather.

    The index stream is the flattened page table; block_rows=1 over the page
    axis because a PAGE IS the wide block (block coalescing dedups repeated
    pages across requests — shared prefixes fetch once)."""
    n_pages, block, n_kv, hd = cache.k_pages.shape
    B, max_pages = cache.page_table.shape
    eng = _kv_engine(cache, window=window, backend=backend)
    gk = eng.gather(cache.k_pages.reshape(n_pages, block * n_kv * hd))
    gv = eng.gather(cache.v_pages.reshape(n_pages, block * n_kv * hd))
    k = gk.reshape(B, max_pages * block, n_kv, hd)
    v = gv.reshape(B, max_pages * block, n_kv, hd)
    return k, v


def kv_plan_report(
    cache: PagedKV, *, window: int = 256, backend: str = "coalesced"
) -> Dict[str, object]:
    """The page-gather plan, inspectable (`GatherEngine.plan_report`):
    coalesce stats (shared-prefix dedup shows up as wide_accesses <
    B * max_pages), metadata traffic, and the `gather_perf` model term. The
    modeled row width is one full KV page."""
    n_pages, block, n_kv, hd = cache.k_pages.shape
    eng = _kv_engine(cache, window=window, backend=backend)
    return eng.plan_report(
        row_bytes=block * n_kv * hd * cache.k_pages.element_size()
    )


def paged_attention(
    q: torch.Tensor,  # (B, 1, H, hd) — decode query
    cache: PagedKV,
    *,
    n_heads: int,
    backend: str = "coalesced",
) -> torch.Tensor:
    """Single-step decode attention over the paged cache."""
    B = q.shape[0]
    k, v = gather_kv(cache, backend=backend)
    S = k.shape[1]
    n_kv, hd = k.shape[2], k.shape[3]
    group = n_heads // n_kv
    qg = q.reshape(B, 1, n_kv, group, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).to(torch.float32)
    scores = scores * (hd**-0.5)
    valid = (
        torch.arange(S, device=cache.device)[None, :]
        < cache.lengths[:, None]
    )[:, None, None, None]
    scores = torch.where(valid, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, 1, n_heads, hd)
