"""The port's optimizer, gradient compression and token pipeline
(`repro_torch.optim`, `repro_torch.data.pipeline`) against `repro`'s on the
same numpy inputs: `lr_at` at every step of a schedule, `adamw_update` over
several steps on a mixed float32/bf16 tree and on a quadratic,
`global_norm`, `quantize_int8` at .5 ties (both round half to even),
error-feedback compression, `topk_sparsify` ties, and `TokenPipeline`
batches array-equal for every (seed, step, shard)."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import PrefetchIterator as JPrefetchIterator
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.optim import compression as jc
from repro.optim import optimizer as jo
from repro_torch.core.engine import clear_engine_cache, clear_schedule_cache
from repro_torch.core.gather_engine import clear_gather_engine_cache
from repro_torch.data.pipeline import DataConfig, PrefetchIterator, \
    TokenPipeline, device_put_batch
from repro_torch.optim import compression as tc
from repro_torch.optim import optimizer as to
from repro_torch.optim.tree import keystr, leaves, map_tree, named_tensors

TOL = dict(rtol=1e-5, atol=1e-6)
SCHEDULES = [
    dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1),
    dict(lr=3e-4, warmup_steps=0, total_steps=37, min_lr_frac=0.0),
    dict(lr=1e-3, warmup_steps=5, total_steps=20),
]
CFG = dict(vocab_size=1000, seq_len=32, global_batch=8)


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    clear_engine_cache()
    clear_schedule_cache()
    clear_gather_engine_cache()
    yield


def _np(x):
    if torch.is_tensor(x):
        x = x.detach()
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x, dtype=np.float32) if np.asarray(x).dtype == \
        ml_dtypes.bfloat16 else np.asarray(x)


def _tree(seed):
    """A mixed tree as numpy (float32 and bf16 leaves, a list, nesting), and
    the same as torch tensors."""
    rng = np.random.default_rng(seed)
    arrays = {
        "w": rng.standard_normal((5, 3)).astype(np.float32),
        "blocks": [rng.standard_normal(4).astype(np.float32),
                   rng.standard_normal((2, 2)).astype(ml_dtypes.bfloat16)],
        "a": {"z": rng.standard_normal(7).astype(np.float32)},
    }

    def to_torch(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())

    return arrays, jax.tree.map(to_torch, arrays)


def test_tree_order_and_names_follow_jax():
    arrays, tensors = _tree(0)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(arrays)[0]]
    got = leaves(tensors)
    assert [leaf.key for leaf in got] == paths
    assert all(leaf.lead == () and len(leaf.names) == 1 for leaf in got)
    assert keystr(("units", "pos0", 3)) == "['units']['pos0'][3]"
    named = named_tensors(tensors)
    for leaf, want in zip(got, jax.tree.leaves(arrays)):
        np.testing.assert_array_equal(_np(named[leaf.names[0]]), _np(want))
    doubled = map_tree(lambda t: t * 2, tensors)
    np.testing.assert_array_equal(doubled["a"]["z"].numpy(),
                                  arrays["a"]["z"] * 2)


@pytest.mark.parametrize("sched", range(len(SCHEDULES)))
def test_lr_at_matches_repro_at_every_step(sched):
    kw = SCHEDULES[sched]
    jcfg, cfg = jo.OptConfig(**kw), to.OptConfig(**kw)
    steps = np.arange(kw["total_steps"] + 3, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: jo.lr_at(jcfg, s))(steps))
    got = np.array([float(to.lr_at(cfg, torch.tensor(int(s))))
                    for s in steps], dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


def test_global_norm_matches_repro():
    arrays, tensors = _tree(1)
    np.testing.assert_allclose(float(to.global_norm(tensors)),
                               float(jo.global_norm(arrays)), rtol=1e-6)


def test_global_norm_of_a_transposed_gradient_is_its_copys_bitwise():
    """A gradient autograd laid out transposed (a column-major view) has
    the norm of its row-major copy, bit for bit: the sum runs in row-major
    order whatever the layout, so a sharded step and the single-card step
    agree on it."""
    # a draw whose norm, summed in column-major order, is one ulp off
    cols = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (64, 48)).astype(np.float32))
    view, copy = {"w": cols.t()}, {"w": cols.t().contiguous()}
    assert not view["w"].is_contiguous()
    got, want = to.global_norm(view), to.global_norm(copy)
    assert got.dtype == want.dtype == torch.float32
    assert got.view(torch.int32).item() == want.view(torch.int32).item()


@pytest.mark.parametrize("grad_scale", [None, 0.5])
def test_adamw_update_matches_repro_over_steps(grad_scale):
    """Five steps on a mixed tree: parameters (bf16 leaves bitwise equal
    after the cast, float32 within 1e-5), moments and step; the update is
    in place and returns the same objects."""
    arrays, params = _tree(2)
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=0.5)
    jcfg, cfg = jo.OptConfig(**cfg_kw), to.OptConfig(**cfg_kw)
    jparams = jax.tree.map(jnp.asarray, arrays)
    jstate, state = jo.init_opt_state(jparams), to.init_opt_state(params)
    first = params["w"]
    for k in range(5):
        g_arrays, g = _tree(10 + k)
        kw = {} if grad_scale is None else {"grad_scale": grad_scale}
        jparams, jstate, jm = jo.adamw_update(
            jcfg, jparams, jax.tree.map(jnp.asarray, g_arrays), jstate,
            **{k2: jnp.float32(v) for k2, v in kw.items()})
        params, state, m = to.adamw_update(
            cfg, params, g, state,
            **{k2: torch.tensor(v) for k2, v in kw.items()})
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    assert params["w"] is first
    for got, want in zip(jax.tree.leaves(params), jax.tree.leaves(jparams)):
        assert (got.dtype == torch.bfloat16) == (want.dtype == jnp.bfloat16)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for part in ("mu", "nu"):
        for got, want in zip(jax.tree.leaves(getattr(state, part)),
                             jax.tree.leaves(getattr(jstate, part))):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert int(state.step) == int(jstate.step) == 5
    assert state.step.dtype == torch.int32


def test_adamw_converges_on_quadratic_as_repro():
    cfg_kw = dict(lr=0.2, weight_decay=0.0, warmup_steps=0, total_steps=200)
    params = {"w": torch.tensor([5.0, -3.0])}
    jparams = {"w": jnp.array([5.0, -3.0])}
    state, jstate = to.init_opt_state(params), jo.init_opt_state(jparams)
    for _ in range(150):
        params, state, _ = to.adamw_update(
            to.OptConfig(**cfg_kw), params, {"w": 2 * params["w"]}, state)
        jparams, jstate, _ = jo.adamw_update(
            jo.OptConfig(**cfg_kw), jparams, {"w": 2 * jparams["w"]}, jstate)
    assert float(params["w"].abs().max()) < 1e-2
    np.testing.assert_allclose(params["w"].numpy(), np.asarray(jparams["w"]),
                               rtol=1e-5, atol=1e-6)


def test_grad_clip_applied_and_norm_reported_pre_clip():
    params = {"w": torch.zeros(3)}
    state = to.init_opt_state(params)
    cfg = to.OptConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0,
                       warmup_steps=0)
    _, _, metrics = to.adamw_update(cfg, params, {"w": torch.full((3,), 1e6)},
                                    state)
    assert float(metrics["grad_norm"]) > 1e5


def test_quantize_int8_rounds_half_to_even_as_repro():
    """Scale 1 (max |x| = 127): x / scale lands exactly on .5 ties; both
    frameworks round them to the even neighbour."""
    x = np.array([127.0, 0.5, 1.5, 2.5, 3.5, -0.5, -1.5, -2.5, 126.5,
                  -126.5, 0.49, 0.51], dtype=np.float32)
    q, s = tc.quantize_int8(torch.from_numpy(x))
    jq, js = jc.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and float(s) == float(js) == 1.0
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(
        q.numpy(), [127, 0, 2, 2, 4, 0, -2, -2, 126, -126, 0, 1])


def test_int8_quantization_bounds():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(1000) * 7
                         ).float()
    q, s = tc.quantize_int8(x)
    err = (tc.dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) / 2 + 1e-6


def test_compress_with_feedback_matches_repro():
    arrays, grads = _tree(3)
    residual, jres = tc.init_residual(grads), jc.init_residual(arrays)
    for k in range(3):
        g_arrays, grads = _tree(20 + k)
        sent, residual = tc.compress_with_feedback(grads, residual)
        jsent, jres = jc.compress_with_feedback(
            jax.tree.map(jnp.asarray, g_arrays), jres)
        for got, want in zip(jax.tree.leaves(sent), jax.tree.leaves(jsent)):
            assert (got.dtype == torch.bfloat16) == \
                (want.dtype == jnp.bfloat16)
            np.testing.assert_allclose(_np(got), _np(want), **TOL)
        for got, want in zip(jax.tree.leaves(residual),
                             jax.tree.leaves(jres)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)


def test_error_feedback_preserves_signal():
    """With error feedback, the accumulated transmitted gradient tracks the
    accumulated true gradient (bias-free in the limit)."""
    rng = np.random.default_rng(0)
    g_true = {"w": torch.from_numpy(rng.standard_normal(64).astype(
        np.float32))}
    residual = tc.init_residual(g_true)
    sent_total = np.zeros(64)
    for _ in range(50):
        sent, residual = tc.compress_with_feedback(g_true, residual)
        sent_total += sent["w"].numpy()
    np.testing.assert_allclose(sent_total / 50, g_true["w"].numpy(),
                               atol=0.05)


@pytest.mark.parametrize("frac", [0.1, 0.25, 0.5])
def test_topk_sparsify_keeps_ties_as_repro(frac):
    """Magnitudes tied at the k-th keep every tied element in both."""
    x = np.array([3.0, -3.0, 1.0, 3.0, 2.0, 0.0, -2.0, 2.0, 1.0, 0.5,
                  -3.0, 0.25], dtype=np.float32)
    got = tc.topk_sparsify(torch.from_numpy(x), frac)
    want = jc.topk_sparsify(jnp.asarray(x), frac)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_pipeline_batches_equal_repro(seed, num_shards):
    for shard in range(num_shards):
        kw = dict(CFG, seed=seed)
        port = TokenPipeline(DataConfig(**kw), shard, num_shards)
        ref = JTokenPipeline(JDataConfig(**kw), shard, num_shards)
        for step in (0, 1, 7, 100):
            got, want = port.batch_at(step), ref.batch_at(step)
            assert got["tokens"].dtype == want["tokens"].dtype == np.int32
            np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_pipeline_skip_to_and_prefetch_order_match_repro():
    cfg, jcfg = DataConfig(**CFG, seed=3), JDataConfig(**CFG, seed=3)
    p, jp = TokenPipeline(cfg), JTokenPipeline(jcfg)
    p.skip_to(100)
    jp.skip_to(100)
    np.testing.assert_array_equal(next(p)["tokens"], next(jp)["tokens"])
    it = PrefetchIterator(iter(TokenPipeline(cfg)), depth=2)
    jit_ = JPrefetchIterator(iter(JTokenPipeline(jcfg)), depth=2)
    direct = TokenPipeline(cfg)
    for _ in range(4):
        got = next(it)["tokens"]
        np.testing.assert_array_equal(got, next(jit_)["tokens"])
        np.testing.assert_array_equal(got, next(direct)["tokens"])
    it.close()
    jit_.close()


def test_device_put_batch_on_the_cpu():
    batch = TokenPipeline(DataConfig(**CFG)).batch_at(2)
    out = device_put_batch(batch, "cpu")
    assert out["tokens"].dtype == torch.int32
    assert out["tokens"].device.type == "cpu"
    np.testing.assert_array_equal(out["tokens"].numpy(), batch["tokens"])
