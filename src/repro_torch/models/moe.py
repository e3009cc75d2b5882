"""Mixture-of-Experts layer with sort-based (coalesced) dispatch (port of
`repro.models.moe`).

Token->expert dispatch is an indirect stream: each token's expert assignment
is a narrow request into the expert's buffer. The paper's mechanism — sort
the window of requests by target block (= expert), process each block's
hits together — becomes: argsort assignments by expert, scatter tokens into
a contiguous (E, C, D) buffer (one "wide access" per expert slab), run
batched expert FFNs, and combine back in original order via the carried
(expert, slot) metadata.

`dispatch_report` runs the same expert-assignment stream through the shared
gather planner (`core.gather_engine`) on the activations' device, so
per-layer coalesce and capacity-drop stats come from the machinery the
paged-KV and embedding paths run on.

Where `repro` lets XLA's ``jnp`` do it implicitly, the port asks for:
``torch.argsort(stable=True)`` (``jnp.argsort`` is stable), a stable
descending sort for ``lax.top_k`` (ties go to the lower expert), and one
spare buffer slot for ``.at[slot].set(..., mode="drop")`` (cut after the
scatter). The combine adds each token's k rows in float32 in the sorted
order and rounds once (a sequential ``index_add_``; no atomics, so it
repeats itself bitwise on the card), an order that may differ from XLA's.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.gather_engine import get_gather_engine
from repro_torch.sharding.dtensor import batch_local, fit_merged, \
    fit_split, is_dtensor, replicated, shard_on

from .layers import _dense_init, einsum, ffn_apply, init_ffn, mm


def init_moe(generator, d_model: int, moe, dtype, *, device=None) -> dict:
    E, Fe = moe.n_experts, moe.d_expert

    def dense(shape, scale=None):
        return _dense_init(generator, shape, dtype, scale, device=device)

    p = {
        "router": dense((d_model, E), scale=0.02),
        "w_gate_e": dense((E, d_model, Fe)),
        "w_in_e": dense((E, d_model, Fe)),
        "w_out_e": dense((E, Fe, d_model)),
    }
    if moe.n_shared:
        p["shared"] = init_ffn(generator, d_model, moe.n_shared * Fe, dtype,
                               act="silu", device=device)
    return p


def _route(p, xf: torch.Tensor, k: int):
    """Router softmax and its top k (ties to the lower expert, as
    `jax.lax.top_k`). Returns (probs (T, E) f32, w (T, k), idx (T, k))."""
    logits = mm(xf, p["router"]).to(torch.float32)  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return probs, w[:, :k], idx[:, :k]


def _build_buf(xf, w, idx, *, E, k, C):
    """Coalescing front half for ONE token shard: sort by expert, scatter into
    capacity slabs. Returns (buf (E,C,D), slot, in_cap, st, sw, counts). On
    a process mesh it runs on the replicated tokens (the sort is global over
    the shard's tokens, as `repro`'s is; DTensor has no rule for some of its
    ops on every torch)."""
    return replicated(functools.partial(_build_buf_local, E=E, k=k, C=C),
                      xf, w, idx)


def _build_buf_local(xf, w, idx, *, E, k, C):
    T, D = xf.shape
    dev = xf.device
    # ---- coalesce: sort assignments by expert (block) id
    flat_e = idx.reshape(-1)  # (T*k,)
    token_of = torch.arange(T, device=dev).repeat_interleave(k)
    w_flat = w.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], token_of[order], w_flat[order]

    # tokens per expert: `repro`'s ``bincount(length=E)``, its shape fixed
    # (torch's bincount sizes its result by the data)
    counts = torch.zeros(E, dtype=torch.int64, device=dev).scatter_add_(
        0, se, torch.ones_like(se))
    starts = torch.cumsum(counts, 0) - counts  # first rank of each expert
    pos = torch.arange(T * k, device=dev) - starts[se]  # slot within expert
    in_cap = pos < C
    slot = torch.where(in_cap, se * C + pos,
                       torch.full_like(pos, E * C))  # E*C = drop bucket

    # ---- wide access: one contiguous slab per expert; the spare row E*C
    # takes the dropped assignments and is cut
    buf = torch.zeros((E * C + 1, D), dtype=xf.dtype, device=dev)
    buf[slot] = xf[st]
    return buf[:E * C].reshape(E, C, D), slot, in_cap, st, sw, counts


def _expert_ffn(buf, w_in_e, w_gate_e, w_out_e, lead=""):
    """Batched expert FFN (SwiGLU). buf: (*lead, E, C, D)."""
    h = einsum(f"{lead}ecd,edf->{lead}ecf", buf, w_in_e)
    g = einsum(f"{lead}ecd,edf->{lead}ecf", buf, w_gate_e)
    return einsum(f"{lead}ecf,efd->{lead}ecd", F.silu(g) * h, w_out_e)


def _combine_one_shard(out, slot, in_cap, st, sw, *, T, E, C):
    """Back half: response splitter — offsets -> original token order (on a
    process mesh on replicated values, as the front half)."""
    return replicated(functools.partial(_combine_local, T=T, E=E, C=C),
                      out, slot, in_cap, st, sw)


def _combine_local(out, slot, in_cap, st, sw, *, T, E, C):
    D = out.shape[-1]
    out_flat = out.reshape(E * C, D)
    gathered = torch.where(
        in_cap[:, None], out_flat[torch.clamp(slot, max=E * C - 1)],
        torch.zeros((), dtype=out.dtype, device=out.device),
    )
    contrib = (gathered.to(torch.float32) * sw[:, None]).to(out.dtype)
    # each token's k rows (`st` names every token k times) added in float32
    # in `st`'s order and rounded once, as `index_add_` adds them on the
    # CPU; the card's `index_add_` adds with atomics in an order that
    # changes from run to run, so its update would not repeat itself
    rows = torch.argsort(st, stable=True).reshape(T, -1)
    y = torch.zeros((T, D), dtype=torch.float32, device=out.device)
    for j in range(rows.shape[1]):
        y = y + contrib[rows[:, j]].to(torch.float32)
    return y.to(out.dtype)


def _dispatch_one_shard(xf, w, idx, *, E, k, C, w_in_e, w_gate_e, w_out_e):
    """Full dispatch + expert FFN + combine for ONE token shard."""
    T = xf.shape[0]
    buf, slot, in_cap, st, sw, counts = _build_buf(xf, w, idx, E=E, k=k, C=C)
    out = _expert_ffn(buf, w_in_e, w_gate_e, w_out_e)
    y = _combine_one_shard(out, slot, in_cap, st, sw, T=T, E=E, C=C)
    return y, counts


def _build_bufs(xs, ws, es, *, E, k, C):
    """`_build_buf_local` for each token shard of (n, Tl, ...) tensors
    (`repro`'s ``vmap``): (buf (n, E, C, D), slot, in_cap, st, sw,
    counts), each stacked on the shard dim."""
    parts = [_build_buf_local(x, w, e, E=E, k=k, C=C)
             for x, w, e in zip(xs, ws, es)]
    return tuple(torch.stack(f) for f in zip(*parts))


def _combine_shards(out, slot, in_cap, st, sw, *, T, E, C):
    """`_combine_local` for each token shard: y (n, Tl, D)."""
    return torch.stack([
        _combine_local(o, sl, ic, s, w_, T=T, E=E, C=C)
        for o, sl, ic, s, w_ in zip(out, slot, in_cap, st, sw)])


def _pin_ep(t: torch.Tensor) -> torch.Tensor:
    """The (shards, E, ...) buffer or expert output on `repro`'s pinned
    ``('data', 'model', None, None)``: the shard dim over 'data', the
    experts over 'model' (other mesh dims as they are)."""
    return shard_on(shard_on(t, 0, "data"), 1, "model")


def moe_apply(
    p,
    x: torch.Tensor,  # (B, S, D)
    *,
    moe,
    capacity_factor: float = 1.25,
    dp_shards: int = 1,
    ep_constraint: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y, aux_loss). Capacity-dropped tokens fall back to the shared
    expert path (or zero for pure-routed MoE).

    dp_shards > 1 is data-local dispatch: tokens are viewed as (dp_shards,
    T/dp_shards, ...) and the sort/scatter/combine runs per shard, with a
    per-shard capacity C (so it changes results, as in `repro`). On a
    process mesh each rank builds and combines the buffers of its own
    shards (`sharding.dtensor.batch_local`; all of them where the batch is
    not cut over 'data'); the expert FFN between runs on DTensors, laid
    out as DTensor's propagation picks, or, with `ep_constraint`, on the
    buffer and the experts' output pinned to ('data', 'model') (`repro`'s
    ``_constrain``). On one device `ep_constraint` changes nothing; on a
    mesh without the data-local dispatch to pin it raises."""
    B, S, D = x.shape
    E, k = moe.n_experts, moe.top_k
    T = B * S
    xf = fit_merged(x.reshape(T, D), 0, B)
    probs, w, idx = _route(p, xf, k)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    local = dp_shards > 1 and T % dp_shards == 0
    if ep_constraint and is_dtensor(xf) and not local:
        raise ValueError(
            f"moe_ep_constraint pins the data-local dispatch buffer, but "
            f"moe_dp_shards={dp_shards} does not cut {T} tokens into shards")

    if local:
        Tl = T // dp_shards
        C = max(1, int(capacity_factor * Tl * k / E))
        xs, ws, es = (fit_split(t, 0, dp_shards).reshape(dp_shards, Tl, -1)
                      for t in (xf, w, idx))
        buf, *meta, counts = batch_local(functools.partial(
            _build_bufs, E=E, k=k, C=C), xs, ws, es, batched=(0, 1, 2))
        if ep_constraint and is_dtensor(buf):
            buf = _pin_ep(buf)
        out = _expert_ffn(buf, p["w_in_e"], p["w_gate_e"], p["w_out_e"],
                          lead="s")
        if ep_constraint and is_dtensor(out):
            out = _pin_ep(out)
        y = batch_local(functools.partial(_combine_shards, T=Tl, E=E, C=C),
                        out, *meta, batched=(0, 1, 2, 3, 4))
        y = fit_merged(y.reshape(T, D), 0, dp_shards)
        counts = counts.sum(0)
    else:
        C = max(1, int(capacity_factor * T * k / E))
        y, counts = _dispatch_one_shard(
            xf, w, idx, E=E, k=k, C=C,
            w_in_e=p["w_in_e"], w_gate_e=p["w_gate_e"],
            w_out_e=p["w_out_e"],
        )

    if "shared" in p:
        y = y + ffn_apply(p["shared"], xf, act="silu")

    # load-balance aux loss (Switch-style)
    frac_tokens = counts.to(torch.float32) / (T * k)
    frac_probs = probs.mean(0)
    aux = E * torch.sum(frac_tokens * frac_probs)
    return fit_split(y, 0, B).reshape(B, S, D), aux


def dispatch_report(
    p,
    x: torch.Tensor,  # (B, S, D) — concrete activations
    *,
    moe,
    capacity_factor: float = 1.25,
    window: int = 256,
    backend: str = "coalesced",
) -> Dict[str, object]:
    """Per-layer dispatch diagnostics: the token->expert assignment stream
    (the same ``idx.reshape(-1)`` `_build_buf` sorts) run through the shared
    gather planner on `x`'s device, plus the capacity-drop accounting
    `moe_apply` applies. Routing math is identical to `moe_apply`'s front
    half, so the reported stream is exactly what dispatch executes."""
    B, S, D = x.shape
    E, k = moe.n_experts, moe.top_k
    T = B * S
    _, _, idx = _route(p, x.reshape(T, D), k)

    flat_e = idx.to(torch.int32).cpu().numpy().reshape(-1)  # (T*k,)
    C = max(1, int(capacity_factor * T * k / E))
    counts = np.bincount(flat_e, minlength=E)
    dropped = int(np.maximum(counts - C, 0).sum())

    eng = get_gather_engine(
        (E, int(moe.d_expert)), flat_e,
        window=window, block_rows=1, backend=backend, device=x.device,
    )
    return {
        "n_tokens": T,
        "top_k": k,
        "n_experts": E,
        "capacity": C,
        "capacity_factor": float(capacity_factor),
        "assignments": int(flat_e.size),
        "tokens_per_expert": counts.tolist(),
        "dropped": dropped,
        "drop_fraction": dropped / float(flat_e.size),
        "max_load": int(counts.max()),
        "load_imbalance": float(counts.max() / max(counts.mean(), 1e-9)),
        "gather": eng.plan_report(),
    }
