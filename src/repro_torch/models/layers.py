"""Shared model building blocks (port of `repro.models.layers`).

Conventions, as in the JAX package:
  * params are nested mappings of tensors (a plain dict, or a
    `transformer.ParamDict` module) keyed by `repro`'s leaf names; every
    ``*_apply`` is a plain function on tensors.
  * every ``init_*`` takes an explicit `torch.Generator` and a device and
    returns a dict; draws are float32 normals on the generator's device,
    cast to the parameter dtype.
  * matmul dtype follows the operands; mixed operands promote first, as
    `jnp` does (``torch.matmul`` and ``torch.einsum`` raise on them), so an
    f32 query against a bf16 cache, or an f32 residual against bf16
    weights, computes in f32. Softmax and norm statistics are f32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.indirect_stream import coalesced_gather
from repro_torch.sharding.dtensor import einsum as sharded_einsum
from repro_torch.sharding.dtensor import fit_merged, fit_split, \
    is_dtensor, keep_only, shards_inner_dims, vocab_lookup
from repro_torch.sharding.dtensor import index_copy_ as dtensor_index_copy_

# A tensor drawn at once holds at most this many elements; larger ones (the
# stacked experts of a full-width MoE layer) are drawn slice by slice along
# their first axis, so no float32 copy of the whole tensor exists.
_DRAW_CHUNK = 1 << 28


def _promoted(*ts):
    """The operands in their common dtype (`jnp`'s promotion for floats)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t if t.dtype == dt else t.to(dt) for t in ts]


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with mixed dtypes promoted first. On a DTensor whose rows
    are sharded past their leading dim (a cache sharded on its sequence, a
    sequence-sharded activation), which ``@`` would flatten into one and
    torch 2.11 refuses, it is the shard-by-shard `sharding.dtensor.einsum`.
    On any other DTensor of more than two dims the flatten into rows is
    written out: the rows (B * S tokens) and their gradient are fitted for
    the split back into (B, S) (`sharding.dtensor.fit_split`), which DTensor
    refuses where it chose to shard the rows over more ranks than B (a
    replicated batch smaller than the data axis)."""
    a, b = _promoted(a, b)
    if not is_dtensor(a) or a.ndim < 3:
        return a @ b
    if shards_inner_dims(a):
        return sharded_einsum("...k,kn->...n", a, b)
    lead = a.shape[:-1]
    rows = fit_merged(a.reshape(-1, a.shape[-1]), 0, lead[0]) @ b
    return fit_split(rows, 0, lead[0]).reshape(*lead, b.shape[-1])


def split_heads(t: torch.Tensor, n_heads: int, *head_shape) -> torch.Tensor:
    """(..., n_heads * prod(head_shape)) -> (..., n_heads, *head_shape). On
    a DTensor the last dim is first fitted for the split
    (`sharding.dtensor.fit_split`)."""
    return fit_split(t, -1, n_heads).reshape(*t.shape[:-1], n_heads,
                                             *head_shape)


def _merge_heads(out: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, H, hd) -> (B, S, H * hd), its gradient fitted for the split
    back into `n_heads` heads (`sharding.dtensor.fit_merged`)."""
    B, S = out.shape[:2]
    return fit_merged(out.reshape(B, S, -1), -1, n_heads)


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with mixed dtypes promoted first; on DTensor
    operands (a process mesh) contracted shard by shard
    (`sharding.dtensor.einsum`)."""
    ops = _promoted(*ops)
    if any(is_dtensor(o) for o in ops):
        return sharded_einsum(eq, *ops)
    return torch.einsum(eq, *ops)


def _normal(generator, shape, device, scale: float, dtype) -> torch.Tensor:
    """``(normal(shape) * scale).astype(dtype)``: float32 draws on `device`,
    chunked along the first axis past `_DRAW_CHUNK` elements."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    if n <= _DRAW_CHUNK or len(shape) < 2:
        return (torch.randn(shape, generator=generator, device=device)
                * scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    step = max(1, _DRAW_CHUNK // (n // shape[0]))
    for lo in range(0, shape[0], step):
        part = out[lo:lo + step]
        part.copy_(torch.randn(part.shape, generator=generator,
                               device=device) * scale)
    return out


def _dense_init(generator, shape, dtype, scale: float | None = None, *,
                device=None):
    fan_in = shape[0]
    scale = scale if scale is not None else fan_in**-0.5
    return _normal(generator, shape, device, scale, dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, dtype, *, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_apply(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].to(torch.float32)).to(x.dtype)


def init_layernorm(d: int, dtype, *, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm_apply(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    out = out * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding (coalesced-gather backed — the paper's technique at the LM's
# biggest indirect-access site)
# ---------------------------------------------------------------------------


def init_embedding(generator, vocab: int, d: int, dtype, *,
                   device=None) -> dict:
    return {"embed": _normal(generator, (vocab, d), device, 0.02, dtype)}


def embedding_apply(
    p,
    token_ids: torch.Tensor,
    *,
    backend: str = "index",
    window: int = 256,
    block_rows: int = 8,
) -> torch.Tensor:
    """(B, S) integer ids -> (B, S, D) on the table's device. backend: index
    (``table[ids]``, `repro`'s ``jnp``) | coalesced | cuda (`repro`'s
    ``pallas``: the hand-written gather kernel, its plain version on a CPU
    table) | auto. Every other backend plans the ids through
    `core.gather_engine.get_gather_engine` (an LRU of engines keyed on the
    stream's digest): the port runs eagerly, so each new batch of ids is
    planned on the host, where `repro`'s jitted decode step plans in the
    trace. On a DTensor table (a process mesh; the vocab sharded over
    'model') the index backend is `sharding.dtensor.vocab_lookup`: each
    rank looks up the ids in its vocab shard and the rows are summed over
    the shards, the same rows as ``table[ids]``."""
    table = p["embed"]
    if backend == "index":
        ids = token_ids.to(device=table.device, dtype=torch.int64)
        if is_dtensor(table):
            return vocab_lookup(table, ids)
        return table[ids]
    return coalesced_gather(table, token_ids, window=window,
                            block_rows=block_rows, backend=backend)


def logits_apply(p, x: torch.Tensor) -> torch.Tensor:
    """Tied or untied output head: x (..., D) @ embed.T -> (..., vocab)."""
    w = p["embed"] if "embed" in p else p["unembed"]
    return einsum("...d,vd->...v", x, w).to(torch.float32)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                               device=device) / head_dim)
    )


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (S,). Split halves (not
    interleaved), in float32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)  # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (B, S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (B, S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


def init_attention(
    generator, d_model: int, n_heads: int, n_kv_heads: int, head_dim: int,
    dtype, *, qkv_bias: bool = False, device=None,
) -> dict:
    def dense(shape):
        return _dense_init(generator, shape, dtype, device=device)

    p = {
        "wq": dense((d_model, n_heads * head_dim)),
        "wk": dense((d_model, n_kv_heads * head_dim)),
        "wv": dense((d_model, n_kv_heads * head_dim)),
        "wo": dense((n_heads * head_dim, d_model)),
    }
    if qkv_bias:
        for name, width in (("bq", n_heads), ("bk", n_kv_heads),
                            ("bv", n_kv_heads)):
            p[name] = torch.zeros((width * head_dim,), dtype=dtype,
                                  device=device)
    return p


def _sdpa(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, Hkv, hd)
    v: torch.Tensor,  # (B, Sk, Hkv, hd)
    mask: Optional[torch.Tensor],  # broadcastable to (B, H, Sq, Sk) or None
) -> torch.Tensor:
    """Grouped attention in `repro`'s layout. q and k promote to their
    common dtype for the scores (an f32 query against a bf16 cache scores in
    f32, as `jnp.einsum` does); the float32 probabilities round to v's
    dtype before the second product, as in `repro`."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    group = H // Hkv
    qg = fit_split(q, 2, Hkv).reshape(B, Sq, Hkv, group, hd)
    # on a process mesh: batch and kv heads only stay sharded, so the
    # result merges (heads, head_dim) with the heads leading; the queries
    # keep a sequence sharding (`Runtime.seq_shard_attention`: the scores
    # stay cut on their query dim), the keys and values cover the whole
    # sequence
    qg = keep_only(qg, (0, 1, 2))
    k, v = (keep_only(t, (0, 2)) for t in (k, v))
    scores = einsum("bqhgd,bkhd->bhgqk", qg, k).to(torch.float32)
    scores = scores * (hd**-0.5)
    if mask is not None:
        # mask: (B, 1, Sq, Sk) -> (B, Hkv, group, Sq, Sk) broadcast
        scores = torch.where(mask[:, :, None, :, :], scores,
                             torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, H, v.shape[-1])  # v head dim may differ (MLA)


def causal_mask(sq: int, sk: int, offset: int = 0, device=None) -> torch.Tensor:
    """(1, 1, sq, sk) — True where attendable. `offset` = kv positions already
    in cache before the current query block."""
    qpos = torch.arange(sq, device=device)[:, None] + offset
    kpos = torch.arange(sk, device=device)[None, :]
    return (kpos <= qpos)[None, None]


def _write_cache(cache: torch.Tensor, new: torch.Tensor, index):
    """Write `new` (B, Sq, ...) into `cache` at sequence offset `index`, in
    place. A Python int: `jax.lax.dynamic_update_slice_in_dim` would clamp
    an offset that runs past the cache; the callers size the cache so that
    never happens, so here it raises. A tensor (a decode cache's 0-d int32
    ``index`` on its device, `repro`'s leaf): rows ``index + arange(Sq)``
    through ``index_copy_``, with no read of the index on the host, so the
    caller that counts the steps keeps them inside the cache
    (`launch.serve.generate` sizes it for its steps). On a DTensor cache
    each rank writes its own shard (`sharding.dtensor.index_copy_`)."""
    sq, s_max = new.shape[1], cache.shape[1]
    if torch.is_tensor(index):
        rows = index.to(torch.int64) + torch.arange(sq, device=index.device)
        if is_dtensor(cache):
            dtensor_index_copy_(cache, 1, rows, new)
        else:
            cache.index_copy_(1, rows, new.to(cache.dtype))
        return cache
    if not 0 <= index <= s_max - sq:
        raise ValueError(f"cache write of {sq} positions at {index} runs "
                         f"past the cache's {s_max}")
    cache[:, index:index + sq] = new.to(cache.dtype)
    return cache


def _decode_mask(index, sq: int, s_max: int, device) -> torch.Tensor:
    """(1, 1, sq, s_max): causal within the chunk and the full history;
    `index` a Python int or a 0-d tensor."""
    kpos = torch.arange(s_max, device=device)[None, None, None, :]
    qpos = (index + torch.arange(sq, device=device))[None, None, :, None]
    return kpos <= qpos


def attention_apply(
    p,
    x: torch.Tensor,  # (B, Sq, D)
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    positions: torch.Tensor,  # (B, Sq) or (Sq,)
    rope_theta: float = 10000.0,
    use_rope: bool = True,
    mask: Optional[torch.Tensor] = None,
    kv_cache: Optional[tuple] = None,  # (k, v): (B, S_max, Hkv, hd)
    cache_index=None,  # write offset: an int or a 0-d tensor
    kv_override: Optional[tuple] = None,  # cross-attn: precomputed (k, v)
):
    """Returns (out, new_kv_cache). Modes:
      * training/prefill: kv_cache None -> causal over x itself
      * decode: kv_cache given -> write new kv at cache_index (in place: the
        returned cache is the one given), attend to the cache
      * cross-attn: kv_override given -> attend to it (no cache update)
    """
    B, Sq, D = x.shape
    q = mm(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    q = split_heads(q, n_heads, head_dim)
    if use_rope:
        q = apply_rope(q, positions.expand(B, Sq), rope_theta)

    if kv_override is not None:
        k, v = kv_override
        out = _sdpa(q, k, v, mask)
        return mm(_merge_heads(out, n_heads), p["wo"]), None

    k = mm(x, p["wk"])
    v = mm(x, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    k = split_heads(k, n_kv_heads, head_dim)
    v = split_heads(v, n_kv_heads, head_dim)
    if use_rope:
        k = apply_rope(k, positions.expand(B, Sq), rope_theta)

    if kv_cache is None:
        if mask is None:
            mask = causal_mask(Sq, Sq, device=x.device)
        out = _sdpa(q, k, v, mask)
        return mm(_merge_heads(out, n_heads), p["wo"]), (k, v)

    ck, cv = kv_cache
    _write_cache(ck, k, cache_index)
    _write_cache(cv, v, cache_index)
    dec_mask = _decode_mask(cache_index, Sq, ck.shape[1], x.device)
    out = _sdpa(q, ck, cv, dec_mask)
    return mm(_merge_heads(out, n_heads), p["wo"]), (ck, cv)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------


def init_mla(generator, d_model: int, n_heads: int, mla, dtype, *,
             device=None) -> dict:
    def dense(shape):
        return _dense_init(generator, shape, dtype, device=device)

    dq = mla.qk_nope_head_dim + mla.qk_rope_head_dim
    return {
        "wq": dense((d_model, n_heads * dq)),
        # compressed KV: d -> kv_lora_rank (the cached latent) + shared k_rope
        "w_dkv": dense((d_model, mla.kv_lora_rank)),
        "w_krope": dense((d_model, mla.qk_rope_head_dim)),
        "kv_norm": init_rmsnorm(mla.kv_lora_rank, dtype, device=device),
        # up-projections from the latent
        "w_uk": dense((mla.kv_lora_rank, n_heads * mla.qk_nope_head_dim)),
        "w_uv": dense((mla.kv_lora_rank, n_heads * mla.v_head_dim)),
        "wo": dense((n_heads * mla.v_head_dim, d_model)),
    }


def mla_apply(
    p,
    x: torch.Tensor,
    *,
    n_heads: int,
    mla,
    positions: torch.Tensor,
    rope_theta: float,
    mask: Optional[torch.Tensor] = None,
    latent_cache: Optional[tuple] = None,  # (c_kv (B,S,r), k_rope (B,S,dr))
    cache_index=None,  # write offset: an int or a 0-d tensor
):
    """DeepSeek-V2 MLA. The decode cache holds only the compressed latent
    (kv_lora_rank) + shared rope key, written in place."""
    B, Sq, D = x.shape
    dn, dr, dv = mla.qk_nope_head_dim, mla.qk_rope_head_dim, mla.v_head_dim
    q = split_heads(mm(x, p["wq"]), n_heads, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    pos = positions.expand(B, Sq)
    q_rope = apply_rope(q_rope, pos, rope_theta)

    c_kv = rmsnorm_apply(p["kv_norm"], mm(x, p["w_dkv"]))  # (B, Sq, r)
    k_rope = apply_rope(mm(x, p["w_krope"])[:, :, None, :], pos,
                        rope_theta)[:, :, 0]  # (B, Sq, dr) one shared head

    if latent_cache is not None:
        cc, cr = latent_cache
        _write_cache(cc, c_kv, cache_index)
        _write_cache(cr, k_rope, cache_index)
        c_all, r_all = cc, cr
        sk = cc.shape[1]
        mask = _decode_mask(cache_index, Sq, sk, x.device)
        new_cache = (cc, cr)
    else:
        c_all, r_all = c_kv, k_rope
        sk = Sq
        if mask is None:
            mask = causal_mask(Sq, sk, device=x.device)
        new_cache = (c_kv, k_rope)

    k_nope = split_heads(mm(c_all, p["w_uk"]), n_heads, dn)
    v = split_heads(mm(c_all, p["w_uv"]), n_heads, dv)
    k_rope_b = r_all[:, :, None, :].expand(B, sk, n_heads, dr)
    k = torch.cat(_promoted(k_nope, k_rope_b), dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    out = _sdpa(q_full, k, v, mask)
    return mm(_merge_heads(out, n_heads), p["wo"]), new_cache


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------


def init_ffn(generator, d_model: int, d_ff: int, dtype, act: str = "silu",
             *, device=None) -> dict:
    def dense(shape):
        return _dense_init(generator, shape, dtype, device=device)

    p = {"w_in": dense((d_model, d_ff)), "w_out": dense((d_ff, d_model))}
    if act == "silu":  # SwiGLU
        p["w_gate"] = dense((d_model, d_ff))
    else:
        p["b_in"] = torch.zeros((d_ff,), dtype=dtype, device=device)
        p["b_out"] = torch.zeros((d_model,), dtype=dtype, device=device)
    return p


def ffn_apply(p, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """SwiGLU, or a GELU MLP. `jax.nn.gelu` defaults to the tanh
    approximation, so the port asks for it (torch's default is exact)."""
    if act == "silu":
        return mm(F.silu(mm(x, p["w_gate"])) * mm(x, p["w_in"]), p["w_out"])
    h = F.gelu(mm(x, p["w_in"]) + p["b_in"], approximate="tanh")
    return mm(h, p["w_out"]) + p["b_out"]
