"""The port's paged KV cache against `repro`'s: the same numpy K/V and
queries through both packages' `alloc_paged`/`append_token`/`gather_kv`/
`paged_attention`. The gather is exact, attention within 1e-5 (float32
softmax and contractions in another order), the plan reports equal; the
steady state builds no schedule, a `repro` cache carries over with
`interop.paged_kv_from_arrays`, and `append_token` writes in place."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro.models import paged_kv as jp
from repro_torch.core.engine import clear_engine_cache, \
    clear_schedule_cache, schedule_cache_stats
from repro_torch.core.gather_engine import clear_gather_engine_cache
from repro_torch.core.interop import paged_kv_from_arrays
from repro_torch.models import layers as tl
from repro_torch.models import paged_kv as tp

TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    clear_engine_cache()
    clear_schedule_cache()
    clear_gather_engine_cache()
    yield


def _kv(steps, B, n_kv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, n_kv, hd)).astype(np.float32),
             rng.standard_normal((B, n_kv, hd)).astype(np.float32))
            for _ in range(steps)]


def _both(kv, *, n_pages, block, n_kv, hd, B, max_len):
    jc = jp.alloc_paged(n_pages=n_pages, block=block, n_kv=n_kv, hd=hd,
                        batch=B, max_len=max_len, dtype=jnp.float32)
    tc = tp.alloc_paged(n_pages=n_pages, block=block, n_kv=n_kv, hd=hd,
                        batch=B, max_len=max_len, dtype=torch.float32,
                        device="cpu")
    for k, v in kv:
        jc = jp.append_token(jc, jnp.asarray(k), jnp.asarray(v))
        tc = tp.append_token(tc, torch.as_tensor(k), torch.as_tensor(v))
    return jc, tc


GEOMETRY = dict(n_pages=32, block=4, n_kv=2, hd=8, B=3, max_len=16)


def test_caches_and_gather_kv_equal_repro():
    kv = _kv(11, 3, 2, 8)
    jc, tc = _both(kv, **GEOMETRY)
    for name in ("k_pages", "v_pages", "page_table", "lengths"):
        np.testing.assert_array_equal(np.asarray(getattr(jc, name)),
                                      getattr(tc, name).numpy())
    for backend in ("coalesced", "cuda", "index"):
        jk, jv = jp.gather_kv(jc)
        tk, tv = tp.gather_kv(tc, backend=backend)
        np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


@pytest.mark.parametrize("backend", ["coalesced", "cuda"])
def test_paged_attention_matches_repro_and_dense(backend):
    B, H, hd, steps = 3, 4, 8, 11
    kv = _kv(steps, B, 2, hd)
    jc, tc = _both(kv, **GEOMETRY)
    q = np.random.default_rng(1).standard_normal((B, 1, H, hd)).astype(
        np.float32)
    want = np.asarray(jp.paged_attention(jnp.asarray(q), jc, n_heads=H))
    got = tp.paged_attention(torch.as_tensor(q), tc, n_heads=H,
                             backend=backend)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    K = np.stack([k for k, _ in kv], 1)
    V = np.stack([v for _, v in kv], 1)
    mask = np.ones((B, 1, 1, steps), bool)
    dense = tl._sdpa(torch.as_tensor(q), torch.as_tensor(K),
                     torch.as_tensor(V), torch.as_tensor(mask))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=0, atol=TOL)
    j_dense = jl._sdpa(jnp.asarray(q), jnp.asarray(K), jnp.asarray(V),
                       jnp.asarray(mask))
    np.testing.assert_allclose(dense.numpy(), np.asarray(j_dense), rtol=0,
                               atol=TOL)


def test_causal_mask_equals_repro():
    for sq, sk, off in ((3, 5, 2), (4, 4, 0), (1, 9, 8)):
        np.testing.assert_array_equal(
            tl.causal_mask(sq, sk, off).numpy(),
            np.asarray(jl.causal_mask(sq, sk, off)))


def test_kv_plan_report_equals_repro():
    B, max_pages = 8, 4
    jc, tc = _both([], n_pages=64, block=4, n_kv=2, hd=4, B=B, max_len=16)
    table = np.asarray(jc.page_table).copy()
    table[:, :2] = [[0, 1]] * B  # shared prefix: the first two pages
    jc.page_table = jnp.asarray(table)
    tc.page_table = torch.as_tensor(table)
    for window in (256, B * max_pages, 8):
        want = jp.kv_plan_report(jc, window=window)
        assert tp.kv_plan_report(tc, window=window) == want


def test_shared_prefix_fewer_wide_fetches_than_disjoint():
    B, block, max_len = 8, 4, 16
    shared = tp.alloc_paged(64, block, 2, 4, B, max_len, torch.float32,
                            device="cpu")
    disjoint = tp.alloc_paged(64, block, 2, 4, B, max_len, torch.float32,
                              device="cpu")
    shared.page_table[:, :2] = torch.tensor([0, 1], dtype=torch.int32)
    n_refs = disjoint.page_table.numel()
    rep_shared = tp.kv_plan_report(shared, window=n_refs)
    rep_disjoint = tp.kv_plan_report(disjoint, window=n_refs)
    assert rep_disjoint["wide_accesses"] == n_refs
    assert rep_shared["wide_accesses"] == n_refs - (B - 1) * 2
    assert rep_shared["coalesce_rate"] > rep_disjoint["coalesce_rate"]


@pytest.mark.parametrize("backend", ["coalesced", "cuda"])
def test_steady_state_decode_builds_no_schedule(backend):
    cache = tp.alloc_paged(8, 4, 2, 4, 2, 8, torch.float32, device="cpu")
    for k, v in _kv(3, 2, 2, 4):
        cache = tp.append_token(cache, torch.as_tensor(k),
                                torch.as_tensor(v))
    tp.gather_kv(cache, backend=backend)
    assert schedule_cache_stats()["built"] == 1
    for k, v in _kv(3, 2, 2, 4, seed=7):  # steady state: append, gather
        cache = tp.append_token(cache, torch.as_tensor(k),
                                torch.as_tensor(v))
        tp.gather_kv(cache, backend=backend)
    assert schedule_cache_stats()["built"] == 1


def test_append_token_writes_in_place():
    """The returned cache shares the pools; the old one sees the new token in
    them but keeps its own lengths."""
    cache = tp.alloc_paged(8, 4, 2, 4, 2, 8, torch.float32, device="cpu")
    (k, v), = _kv(1, 2, 2, 4)
    new = tp.append_token(cache, torch.as_tensor(k), torch.as_tensor(v))
    assert new.k_pages is cache.k_pages and new.v_pages is cache.v_pages
    assert cache.lengths.tolist() == [0, 0] and new.lengths.tolist() == [1, 1]
    assert torch.equal(cache.k_pages[[0, 2], 0], torch.as_tensor(k))


def test_paged_kv_from_arrays_round_trips_a_repro_cache():
    kv = _kv(6, 3, 2, 8, seed=4)
    jc, _ = _both(kv, **GEOMETRY)
    tc = paged_kv_from_arrays(np.asarray(jc.k_pages), np.asarray(jc.v_pages),
                              np.asarray(jc.page_table),
                              np.asarray(jc.lengths), jc.block, device="cpu")
    for name in ("k_pages", "v_pages", "page_table", "lengths"):
        np.testing.assert_array_equal(np.asarray(getattr(jc, name)),
                                      getattr(tc, name).numpy())
    jk, _ = jp.gather_kv(jc)
    tk, _ = tp.gather_kv(tc)
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    with pytest.raises(ValueError, match="pools must share"):
        paged_kv_from_arrays(np.zeros((4, 3, 1, 2)), np.zeros((4, 3, 1, 2)),
                             np.zeros((1, 4)), np.zeros(1), block=4,
                             device="cpu")


def test_alloc_paged_rejects_small_pool_like_repro():
    with pytest.raises(ValueError) as ours:
        tp.alloc_paged(n_pages=4, block=4, n_kv=2, hd=8, batch=4, max_len=16,
                       device="cpu")
    with pytest.raises(ValueError) as theirs:
        jp.alloc_paged(n_pages=4, block=4, n_kv=2, hd=8, batch=4, max_len=16)
    assert str(ours.value) == str(theirs.value)
