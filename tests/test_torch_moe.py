"""The port's MoE layer (`repro_torch.models.moe`) against `repro.models.moe`
with `repro`'s parameters carried across: routing (ties to the lower
expert), the stable sort, capacity slots and expert counts exactly,
`moe_apply` single-shard and data-local (``dp_shards=2``) within
``1e-5 + 1e-5 * |ref|``, `dispatch_report` equal; and llama4's unit order
(every MoE layer before any dense one), pinned by a reduced llama4 whose
two unit positions differ."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import build_model as j_build_model
from repro.models import make_input_batch as j_make_input_batch
from repro.models import moe as JM
from repro.models.transformer import Runtime as JRuntime
from repro_torch.configs import ARCHS
from repro_torch.core.engine import clear_engine_cache, clear_schedule_cache
from repro_torch.core.gather_engine import clear_gather_engine_cache
from repro_torch.core.interop import model_params_from_numpy
from repro_torch.models import Runtime, build_model
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT

TOL = dict(rtol=1e-5, atol=1e-5)
MOE_ARCHS = ["deepseek-v2-lite-16b", "llama4-maverick-400b-a17b"]


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    clear_engine_cache()
    clear_schedule_cache()
    clear_gather_engine_cache()
    yield


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree))


def _layer(name, seed=0):
    """A reduced arch's MoE config, `repro`'s initialised layer (numpy) and
    seeded activations (2, 24, d_model)."""
    jcfg = J_ARCHS[name].reduced()
    p = jax.tree.map(np.asarray, JM.init_moe(jax.random.PRNGKey(seed),
                                             jcfg.d_model, jcfg.moe,
                                             jnp.float32))
    x = np.random.default_rng(seed).standard_normal(
        (2, 24, jcfg.d_model)).astype(np.float32)
    return jcfg, ARCHS[name].reduced(), p, x


def test_routing_ties_go_to_the_lower_expert():
    """Two router columns equal: `lax.top_k` picks the lower index, and so
    does the port's stable descending sort."""
    rng = np.random.default_rng(1)
    router = rng.standard_normal((16, 8)).astype(np.float32)
    router[:, 5] = router[:, 2]
    router[:, 7] = router[:, 2]
    x = rng.standard_normal((40, 16)).astype(np.float32)
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    for k in (1, 2, 3):
        jw, jidx = jax.lax.top_k(probs, k)
        _, tw, tidx = TM._route({"router": torch.as_tensor(router)},
                                torch.as_tensor(x), k)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)


@pytest.mark.parametrize("k", [1, 2])
def test_build_buf_slots_and_counts_equal_repro(k):
    """A stream of many repeats: the stable argsort, the capacity slots
    (with drops), the sorted tokens and the counts are `repro`'s exactly."""
    rng = np.random.default_rng(2)
    T, D, E, C = 30, 6, 4, 5
    xf = rng.standard_normal((T, D)).astype(np.float32)
    idx = rng.integers(0, E, size=(T, k)).astype(np.int32)
    w = rng.random((T, k)).astype(np.float32)
    want = JM._build_buf(jnp.asarray(xf), jnp.asarray(w), jnp.asarray(idx),
                         E=E, k=k, C=C)
    got = TM._build_buf(torch.as_tensor(xf), torch.as_tensor(w),
                        torch.as_tensor(idx).long(), E=E, k=k, C=C)
    for g, j in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    assert int((~got[2]).sum()) > 0  # some assignments were dropped


@pytest.mark.parametrize("name", MOE_ARCHS)
@pytest.mark.parametrize("dp_shards", [1, 2])
def test_moe_apply_matches_repro(name, dp_shards):
    jcfg, cfg, p, x = _layer(name)
    jy, jaux = JM.moe_apply(p, jnp.asarray(x), moe=jcfg.moe,
                            dp_shards=dp_shards)
    ty, taux = TM.moe_apply(_t(p), torch.as_tensor(x), moe=cfg.moe,
                            dp_shards=dp_shards, ep_constraint=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)


def test_dp_shards_changes_capacity_and_results():
    """Per-shard dispatch has its own capacity C, so it drops other tokens:
    the two modes differ, in `repro` and in the port alike."""
    jcfg, cfg, p, x = _layer("llama4-maverick-400b-a17b", seed=3)
    one, _ = TM.moe_apply(_t(p), torch.as_tensor(x), moe=cfg.moe,
                          capacity_factor=0.5)
    two, _ = TM.moe_apply(_t(p), torch.as_tensor(x), moe=cfg.moe,
                          capacity_factor=0.5, dp_shards=2)
    jone, _ = JM.moe_apply(p, jnp.asarray(x), moe=jcfg.moe,
                           capacity_factor=0.5)
    jtwo, _ = JM.moe_apply(p, jnp.asarray(x), moe=jcfg.moe,
                           capacity_factor=0.5, dp_shards=2)
    assert not np.allclose(np.asarray(jone), np.asarray(jtwo))
    np.testing.assert_allclose(one.numpy(), np.asarray(jone), **TOL)
    np.testing.assert_allclose(two.numpy(), np.asarray(jtwo), **TOL)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_expert_counts_equal_repro(name):
    jcfg, cfg, p, x = _layer(name, seed=4)
    E, k, T = cfg.moe.n_experts, cfg.moe.top_k, 48
    C = max(1, int(1.25 * T * k / E))
    xf = x.reshape(T, -1)
    logits = jnp.asarray(xf) @ jnp.asarray(p["router"])
    jw, jidx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    _, jcounts = JM._dispatch_one_shard(
        jnp.asarray(xf), jw, jidx, E=E, k=k, C=C, w_in_e=p["w_in_e"],
        w_gate_e=p["w_gate_e"], w_out_e=p["w_out_e"])
    _, tw, tidx = TM._route(_t(p), torch.as_tensor(xf), k)
    tp = _t(p)
    _, tcounts = TM._dispatch_one_shard(
        torch.as_tensor(xf), tw, tidx, E=E, k=k, C=C, w_in_e=tp["w_in_e"],
        w_gate_e=tp["w_gate_e"], w_out_e=tp["w_out_e"])
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))


@pytest.mark.parametrize("name", MOE_ARCHS)
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_dispatch_report_equals_repro(name, capacity_factor):
    jcfg, cfg, p, x = _layer(name, seed=5)
    want = JM.dispatch_report(p, jnp.asarray(x), moe=jcfg.moe,
                              capacity_factor=capacity_factor, window=32)
    got = TM.dispatch_report(_t(p), torch.as_tensor(x), moe=cfg.moe,
                             capacity_factor=capacity_factor, window=32)
    assert got == want
    if capacity_factor < 1:
        assert got["dropped"] > 0


def test_llama4_runs_every_moe_layer_before_the_dense_ones(monkeypatch):
    """`repro` scans unit position 0 over every unit, then position 1: the
    reduced llama4 (4 layers, moe_layer_step 2) runs MoE, MoE, dense, dense.
    The port follows that order, and the logits tell the orders apart: run
    alternating (MoE, dense, MoE, dense), they leave the 1e-5 gate."""
    name = "llama4-maverick-400b-a17b"
    jcfg, cfg = J_ARCHS[name].reduced(), ARCHS[name].reduced()
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jbatch = j_make_input_batch(jcfg, 2, 12, key=jax.random.PRNGKey(1))
    want, _ = jmodel.forward(jparams, jbatch, JRuntime())
    params = model_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    batch = {"tokens": torch.as_tensor(np.array(jbatch["tokens"]))}
    model, rt = build_model(cfg), Runtime()

    order = []
    apply = TT._apply_dense_layer

    def recording(cfg_, rt_, p, *a, **kw):
        order.append("moe" if "moe" in p else "dense")
        return apply(cfg_, rt_, p, *a, **kw)

    monkeypatch.setattr(TT, "_apply_dense_layer", recording)
    with torch.no_grad():
        got, _ = model.forward(params, batch, rt)
    assert order == ["moe", "moe", "dense", "dense"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    units = params.units
    alternating = [units.pos0[0], units.pos1[0], units.pos0[1],
                   units.pos1[1]]
    with torch.no_grad():
        x = params._embed(batch["tokens"], rt)
        pos = torch.arange(12)[None, :]
        for lp in alternating:
            x, _, _ = apply(cfg, rt, lp, x, pos)
        x = TL.rmsnorm_apply(params.final_norm, x, cfg.norm_eps)
        other = TL.logits_apply(params.unembed, x)
    assert not np.allclose(other.numpy(), np.asarray(want), **TOL)
