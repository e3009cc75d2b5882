"""The port's layer functions (`repro_torch.models.layers`) against
`repro.models.layers` on the same numpy inputs and `repro`'s own initialised
parameters: norms, rotary, GQA attention (bias, cache, cross attention),
MLA, both FFNs, the embedding on every gather backend and the output head,
within ``1e-5 + 1e-5 * |ref|`` in float32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MLAConfig
from repro.models import layers as JL
from repro_torch.core.engine import clear_engine_cache, clear_schedule_cache
from repro_torch.core.gather_engine import clear_gather_engine_cache
from repro_torch.models import layers as TL

TOL = dict(rtol=1e-5, atol=1e-5)
B, S, D, H, HKV, HD = 2, 7, 32, 4, 2, 8


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    clear_engine_cache()
    clear_schedule_cache()
    clear_gather_engine_cache()
    yield


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(tree):
    """A `repro` parameter tree (or array) as torch tensors on the CPU."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_t(v) for v in tree)
    return torch.as_tensor(np.array(tree))


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else \
        np.asarray(x, dtype=np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _x(shape, seed=0):
    return _rng(seed).standard_normal(shape).astype(np.float32)


def _with_biases(p, seed=7):
    """`init_attention` zeroes the biases; give them values."""
    rng = _rng(seed)
    return {k: (rng.standard_normal(v.shape).astype(np.float32) * 0.1
                if k.startswith("b") else np.asarray(v)) for k, v in p.items()}


# ---------------------------------------------------------------------------
# Norms, rotary, FFN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_repro(dtype):
    x = _x((B, S, D))
    scale = _x((D,), 1) + 1.0
    bias = _x((D,), 2)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    tol = TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    want = JL.rmsnorm_apply({"scale": jnp.asarray(scale)}, jx, 1e-6)
    got = TL.rmsnorm_apply({"scale": torch.as_tensor(scale)}, tx, 1e-6)
    assert got.dtype == tx.dtype
    _close(got, want, **tol)
    want = JL.layernorm_apply({"scale": jnp.asarray(scale),
                               "bias": jnp.asarray(bias)}, jx)
    got = TL.layernorm_apply({"scale": torch.as_tensor(scale),
                              "bias": torch.as_tensor(bias)}, tx)
    assert got.dtype == tx.dtype
    _close(got, want, **tol)


@pytest.mark.parametrize("pos_shape", ["batch", "seq"])
def test_rope_matches_repro(pos_shape):
    x = _x((B, S, H, HD))
    pos = np.arange(3, 3 + S)
    pos = np.broadcast_to(pos, (B, S)).copy() if pos_shape == "batch" else pos
    np.testing.assert_array_equal(TL.rope_freqs(HD, 5e5).numpy(),
                                  np.asarray(JL.rope_freqs(HD, 5e5)))
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e5)
    got = TL.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 5e5)
    _close(got, want)
    # split halves, not interleaved: position 0 is the identity
    zero = TL.apply_rope(torch.as_tensor(x), torch.zeros(S, dtype=torch.int64),
                         1e4)
    _close(zero, x)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_ffn_matches_repro(act):
    p = JL.init_ffn(jax.random.PRNGKey(1), D, 48, jnp.float32, act=act)
    if act == "gelu":
        p = _with_biases(p)
    x = _x((B, S, D), 3)
    want = JL.ffn_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), act)
    got = TL.ffn_apply(_t(p), torch.as_tensor(x), act)
    _close(got, want)
    if act == "gelu":
        # jax.nn.gelu is the tanh approximation; torch's default is exact,
        # and the difference shows at these widths
        tp = _t(p)
        exact = torch.nn.functional.gelu(torch.as_tensor(x) @ tp["w_in"]
                                         + tp["b_in"]) @ tp["w_out"] \
            + tp["b_out"]
        assert not np.allclose(exact.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _attn_params(bias):
    p = JL.init_attention(jax.random.PRNGKey(2), D, H, HKV, HD, jnp.float32,
                          qkv_bias=bias)
    return _with_biases(p) if bias else jax.tree.map(np.asarray, p)


def _attn_kw(**kw):
    return dict(n_heads=H, n_kv_heads=HKV, head_dim=HD, rope_theta=1e4, **kw)


@pytest.mark.parametrize("bias", [False, True])
def test_attention_prefill_matches_repro(bias):
    p = _attn_params(bias)
    x = _x((B, S, D), 4)
    pos = np.arange(S)[None, :]
    want, (wk, wv) = JL.attention_apply(p, jnp.asarray(x),
                                        positions=jnp.asarray(pos),
                                        **_attn_kw())
    got, (gk, gv) = TL.attention_apply(_t(p), torch.as_tensor(x),
                                       positions=torch.as_tensor(pos),
                                       **_attn_kw())
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_attention_decode_into_a_cache_matches_repro(bias, cache_dtype):
    """Prefill 5 positions into a cache of 9, then one step at index 5; the
    bf16 cache holds K/V rounded to bf16 while the f32 query promotes."""
    p = _attn_params(bias)
    x = _x((B, 6, D), 5)
    s_max = 9
    jc = (jnp.zeros((B, s_max, HKV, HD), cache_dtype),) * 2
    tc = tuple(torch.zeros((B, s_max, HKV, HD),
                           dtype=getattr(torch, cache_dtype))
               for _ in range(2))
    tol = TOL if cache_dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    for lo, hi in ((0, 5), (5, 6)):
        pos = np.arange(lo, hi)[None, :]
        want, jc = JL.attention_apply(
            p, jnp.asarray(x[:, lo:hi]), positions=jnp.asarray(pos),
            kv_cache=jc, cache_index=jnp.asarray(lo), **_attn_kw())
        got, tc = TL.attention_apply(
            _t(p), torch.as_tensor(x[:, lo:hi]),
            positions=torch.as_tensor(pos), kv_cache=tc, cache_index=lo,
            **_attn_kw())
        assert got.dtype == torch.float32
        _close(got, want, **tol)
        _close(tc[0], jc[0], **tol)
        _close(tc[1], jc[1], **tol)


def test_attention_cross_attention_override_matches_repro():
    p = _attn_params(True)
    x = _x((B, S, D), 6)
    k = _x((B, 5, HKV, HD), 7)
    v = _x((B, 5, HKV, HD), 8)
    mask = np.ones((1, 1, 1, 5), bool)
    kw = _attn_kw(use_rope=False)
    want, none = JL.attention_apply(
        p, jnp.asarray(x), positions=jnp.zeros((1, S), jnp.int32),
        kv_override=(jnp.asarray(k), jnp.asarray(v)), mask=jnp.asarray(mask),
        **kw)
    got, nothing = TL.attention_apply(
        _t(p), torch.as_tensor(x), positions=torch.zeros((1, S)),
        kv_override=(torch.as_tensor(k), torch.as_tensor(v)),
        mask=torch.as_tensor(mask), **kw)
    assert none is None and nothing is None
    _close(got, want)


def test_sdpa_promotes_an_f32_query_against_a_bf16_cache():
    """`jnp.einsum` promotes f32 x bf16 to f32; `torch.einsum` raises on
    mixed dtypes, so `_sdpa` promotes first. The probabilities then round
    to the cache's bf16 as in `repro`, and so does the output."""
    q = _x((B, 3, H, HD), 9)
    k = _x((B, 6, HKV, HD), 10)
    v = _x((B, 6, HKV, HD), 11)
    mask = np.tril(np.ones((3, 6), bool), 3)[None, None]
    jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (k, v))
    tk, tv = (torch.as_tensor(a).to(torch.bfloat16) for a in (k, v))
    want = JL._sdpa(jnp.asarray(q), jk, jv, jnp.asarray(mask))
    got = TL._sdpa(torch.as_tensor(q), tk, tv, torch.as_tensor(mask))
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    _close(got, want, rtol=1e-2, atol=1e-2)
    # the scores are f32: the same as scoring against the cache widened
    widened = TL._sdpa(torch.as_tensor(q), tk.float(), tv.float(),
                       torch.as_tensor(mask))
    _close(got, widened, rtol=1e-2, atol=1e-2)


def test_cache_write_past_the_end_raises():
    """`dynamic_update_slice` would clamp the offset; the port refuses."""
    cache = torch.zeros((B, 4, HKV, HD))
    TL._write_cache(cache, torch.ones((B, 2, HKV, HD)), 2)
    assert float(cache[:, 2:].min()) == 1.0
    with pytest.raises(ValueError, match="past the cache"):
        TL._write_cache(cache, torch.ones((B, 2, HKV, HD)), 3)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

MLA = MLAConfig(kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=4,
                v_head_dim=8)


def test_mla_prefill_and_decode_match_repro():
    p = jax.tree.map(np.asarray, JL.init_mla(jax.random.PRNGKey(3), D, H,
                                             MLA, jnp.float32))
    x = _x((B, 6, D), 12)
    kw = dict(n_heads=H, mla=MLA, rope_theta=1e4)
    pos = np.arange(6)[None, :]
    want, _ = JL.mla_apply(p, jnp.asarray(x), positions=jnp.asarray(pos),
                           **kw)
    got, _ = TL.mla_apply(_t(p), torch.as_tensor(x),
                          positions=torch.as_tensor(pos), **kw)
    _close(got, want)
    jc = (jnp.zeros((B, 8, 16)), jnp.zeros((B, 8, 4)))
    tc = (torch.zeros((B, 8, 16)), torch.zeros((B, 8, 4)))
    for lo, hi in ((0, 5), (5, 6)):
        pos = np.arange(lo, hi)[None, :]
        want, jc = JL.mla_apply(p, jnp.asarray(x[:, lo:hi]),
                                positions=jnp.asarray(pos), latent_cache=jc,
                                cache_index=jnp.asarray(lo), **kw)
        got, tc = TL.mla_apply(_t(p), torch.as_tensor(x[:, lo:hi]),
                               positions=torch.as_tensor(pos),
                               latent_cache=tc, cache_index=lo, **kw)
        _close(got, want)
        _close(tc[0], jc[0])
        _close(tc[1], jc[1])


# ---------------------------------------------------------------------------
# Embedding and the output head
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["index", "coalesced", "cuda", "auto"])
def test_embedding_every_backend_is_table_indexing(backend):
    """`repro`'s ``jnp`` gather is the port's ``index``; every coalesced
    backend copies rows, so all equal it bitwise (``cuda`` runs the kernel's
    plain version on a CPU table)."""
    table = _x((50, 12), 13)
    ids = _rng(14).integers(0, 50, size=(3, 40)).astype(np.int32)
    want = np.asarray(JL.embedding_apply({"embed": jnp.asarray(table)},
                                         jnp.asarray(ids)))
    got = TL.embedding_apply({"embed": torch.as_tensor(table)},
                             torch.as_tensor(ids), backend=backend,
                             window=32, block_rows=4)
    assert got.shape == (3, 40, 12)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("head", ["embed", "unembed"])
def test_logits_match_repro(head):
    w = _x((30, D), 15) * 0.1
    x = _x((B, S, D), 16)
    want = JL.logits_apply({head: jnp.asarray(w)}, jnp.asarray(x))
    got = TL.logits_apply({head: torch.as_tensor(w)}, torch.as_tensor(x))
    assert got.dtype == torch.float32
    _close(got, want)


def test_init_draws_are_seeded_and_chunked(monkeypatch):
    """Draws are float32 normals times the scale, cast; a tensor past the
    chunk size is drawn slice by slice, the same for one seed."""
    gen = torch.Generator().manual_seed(3)
    w = TL._dense_init(gen, (64, 16), torch.bfloat16)
    assert w.dtype == torch.bfloat16 and w.shape == (64, 16)
    assert 0.05 < float(w.float().std()) < 0.2  # fan_in**-0.5 = 0.125
    monkeypatch.setattr(TL, "_DRAW_CHUNK", 100)
    a = TL._normal(torch.Generator().manual_seed(4), (8, 5, 6), "cpu", 0.5,
                   torch.float32)
    b = TL._normal(torch.Generator().manual_seed(4), (8, 5, 6), "cpu", 0.5,
                   torch.float32)
    assert torch.equal(a, b) and a.shape == (8, 5, 6)
    assert 0.3 < float(a.std()) < 0.7
