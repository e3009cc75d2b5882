"""The decode step `launch.serve.generate` runs after the prefill, against
`repro`'s jitted one, on the CPU: the cache ``index`` as `repro`'s 0-d
int32 leaf on the cache's device (every reduced family), the step that
`generate` captures on the card (`one_token_step`) run eagerly, step by
step at `repro`'s float32-cache tolerance ``1e-5 + 1e-5 * |ref|`` with the
same greedy tokens, the gathers planned in the step (`gather_in_step`)
bitwise equal to `repro`'s ``_gather_in_trace`` (its Pallas kernel in
interpret mode for two cases), with no digest, engine or host copy, and
the ZeRO-1 fold of whisper's model-sharded biases (ROADMAP C27). The
capture itself needs the card (tests/test_torch_gpu.py, chip_smoke.py
phase 11)."""
import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.core.indirect_stream import _gather_in_trace
from repro.models import build_model as j_build_model
from repro.models import make_input_batch as j_make_input_batch
from repro.models.transformer import Runtime as JRuntime
from repro_torch.configs import ARCHS
from repro_torch.core import gather_engine, indirect_stream
from repro_torch.core.engine import clear_engine_cache, clear_schedule_cache
from repro_torch.core.gather_engine import clear_gather_engine_cache, \
    gather_engine_cache_stats
from repro_torch.core.interop import model_params_to_numpy
from repro_torch.launch import serve
from repro_torch.models import Runtime, build_model
from repro_torch.models import layers as TL
from repro_torch.sharding import rules

NAMES = sorted(ARCHS)
TOL = dict(rtol=1e-5, atol=1e-5)
B, S, STEPS = 2, 8, 3


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    clear_engine_cache()
    clear_schedule_cache()
    clear_gather_engine_cache()
    yield


@functools.lru_cache(maxsize=None)
def _repro(name):
    """`repro`'s reduced model with its decode step jitted (as its
    `generate` jits it), the port's model, the same parameters in both
    (drawn by the port, carried across by `core.interop`: a jitted `repro`
    init costs seconds an arch) and the same batch."""
    jcfg = J_ARCHS[name].reduced()
    jmodel = j_build_model(jcfg)
    jmodel = dataclasses.replace(
        jmodel, decode_step=jax.jit(jmodel.decode_step, static_argnums=3),
        extras={k: jax.jit(f, static_argnums=2)
                for k, f in jmodel.extras.items()})
    cfg = ARCHS[name].reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    jparams = jax.tree.map(jnp.asarray, model_params_to_numpy(cfg, params))
    jbatch = j_make_input_batch(jcfg, B, S, key=jax.random.PRNGKey(1))
    batch = {k: torch.as_tensor(np.array(v)) for k, v in jbatch.items()}
    return jmodel, jparams, jbatch, model, params, batch


def _prime(model, params, cache, batch, rt):
    if model.cfg.family == "audio":
        cache["enc_out"] = model.extras["encode"](params, batch["enc_input"],
                                                  rt)
    if model.cfg.family == "vlm":
        cache["image_embeds"] = batch["image_embeds"]
    return cache


def _assert_index_like(index, jindex, value):
    """The port's cache index is `repro`'s leaf: 0-d int32, on the cache's
    device, the same value."""
    assert torch.is_tensor(index) and index.device.type == "cpu"
    assert index.dtype == torch.int32 and tuple(index.shape) == ()
    assert np.asarray(jindex).dtype == np.int32 and jnp.shape(jindex) == ()
    assert int(index) == int(jindex) == value


@functools.lru_cache(maxsize=None)
def _run(name):
    """A prefill through `decode_step`, then STEPS steps of
    `serve.one_token_step` (the step `generate` captures on the card) fed
    `repro`'s greedy tokens, against `repro`'s prefill and jitted steps,
    through a float32 cache: every logits pair, the index after each, and
    both sides' greedy tokens."""
    jmodel, jparams, jbatch, model, params, batch = _repro(name)
    jrt, rt = JRuntime(cache_dtype="float32"), Runtime(cache_dtype="float32")
    s_max = S + STEPS
    jcache = _prime(jmodel, jparams, jmodel.init_cache(B, s_max, jrt),
                    jbatch, jrt)
    with torch.inference_mode():
        cache = _prime(model, params, model.init_cache(B, s_max, rt,
                                                       device="cpu"),
                       batch, rt)
        index0 = (cache["index"].clone(), jcache["index"])
        want, jcache = jmodel.decode_step(jparams, jbatch["tokens"], jcache,
                                          jrt)
        got, cache = model.decode_step(params, batch["tokens"], cache, rt)
        pairs = [(got.clone(), np.asarray(want))]
        indices = [(cache["index"].clone(), jcache["index"])]
        tok = jnp.argmax(want[:, -1], axis=-1)[:, None].astype(jnp.int32)
        tokens = torch.as_tensor(np.array(tok))
        step = serve.one_token_step(model, params, tokens, cache, rt)
        toks = ([], [])
        for _ in range(STEPS):
            tokens.copy_(torch.as_tensor(np.array(tok)))
            want, jcache = jmodel.decode_step(jparams, tok, jcache, jrt)
            got = step()
            pairs.append((got.clone(), np.asarray(want)))
            indices.append((cache["index"].clone(), jcache["index"]))
            tok = jnp.argmax(want[:, -1], axis=-1)[:, None].astype(jnp.int32)
            toks[0].append(torch.argmax(got[:, -1], dim=-1).numpy())
            toks[1].append(np.asarray(tok[:, 0]))
    return index0, pairs, indices, toks, cache


@pytest.mark.parametrize("name", NAMES)
def test_cache_index_is_repros_int32_leaf(name):
    """A fresh cache's index, after the prefill and after each of three
    steps: a 0-d int32 tensor on the cache's device, as `repro`'s
    ``jnp.zeros((), jnp.int32)`` leaf, with `repro`'s value."""
    index0, _, indices, _, cache = _run(name)
    _assert_index_like(*index0, 0)
    for i, (index, jindex) in enumerate(indices):
        _assert_index_like(index, jindex, S + i)
    assert cache["index"] is not None and int(cache["index"]) == S + STEPS


@pytest.mark.parametrize("name", NAMES)
def test_one_token_step_matches_repros_jitted_step(name):
    """The prefill and three steps of the step `generate` captures, run
    eagerly, against `repro`'s jitted decode step at the float32-cache
    tolerance, and the same greedy tokens."""
    _, pairs, _, toks, _ = _run(name)
    for got, want in pairs:
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(np.stack(toks[0]), np.stack(toks[1]))


def test_one_token_step_keeps_the_caches_buffers():
    """The step advances the index and the recurrent state in the buffers
    the cache already holds (what a replayed graph reads), and refuses a
    state of another dtype rather than cast it."""
    _, _, _, model, params, batch = _repro("zamba2-1.2b")
    rt = Runtime(cache_dtype="float32")
    with torch.inference_mode():
        cache = model.init_cache(B, S + 2, rt, device="cpu")
        _, cache = model.decode_step(params, batch["tokens"], cache, rt)
        index, conv = cache["index"], cache["units"][0][0]["conv"]
        before = conv.clone()
        step = serve.one_token_step(model, params, batch["tokens"][:, :1],
                                    cache, rt)
        step()
        assert cache["index"] is index and int(index) == S + 1
        assert cache["units"][0][0]["conv"] is conv
        assert not torch.equal(conv, before)
        cache["units"][0][0]["conv"] = conv.to(torch.float64)
        with pytest.raises(ValueError, match="conv"):
            step()


def test_generate_asks_the_card_for_a_capture():
    """`capture=True` on a CPU model raises; by default the CPU runs the
    step eagerly."""
    _, _, _, model, params, batch = _repro("smollm-360m")
    with pytest.raises(ValueError, match="capture=True"):
        serve.generate(model, params, batch["tokens"], max_new_tokens=2,
                       rt=Runtime(), capture=True)
    kinds = []

    def hook(kind, ids, run):
        kinds.append(kind)
        return run()

    serve.generate(model, params, batch["tokens"], max_new_tokens=3,
                   rt=Runtime(), step_hook=hook)
    assert kinds == ["prefill", "step", "step", "step"]


# -- the gathers of the step ---------------------------------------------


def _table_and_ids(rows, width, n, seed):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((rows, width)).astype(np.float32)
    ids = rng.integers(0, rows, n).astype(np.int32)
    ids[: n // 3] = ids[0]  # repeats within a window
    return table, ids


def _bits(a):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    return a.view(np.uint32)


@pytest.mark.parametrize("backend,rows,width,n,window,block_rows,seed", [
    ("coalesced", 300, 16, 75, 32, 8, 0),
    ("coalesced", 1000, 8, 600, 256, 8, 1),
    ("coalesced", 50, 4, 7, 32, 1, 2),
    ("index", 300, 16, 75, 32, 8, 3),
    ("pallas", 300, 16, 75, 32, 8, 4),
    ("pallas", 64, 8, 40, 16, 1, 5),
])
def test_in_step_gather_equals_repros_gather_in_trace(
        backend, rows, width, n, window, block_rows, seed):
    """`gather_in_step` against `repro`'s ``_gather_in_trace`` on the same
    seeded ids, bitwise (`repro`'s ``pallas`` is the port's ``cuda``: its
    plain version here, the Pallas kernel in interpret mode there; ``index``
    is `repro`'s ``jnp``)."""
    table, ids = _table_and_ids(rows, width, n, seed)
    want = _gather_in_trace(jnp.asarray(table), jnp.asarray(ids), None,
                            window=window, block_rows=block_rows,
                            backend={"index": "jnp"}.get(backend, backend))
    got = indirect_stream.gather_in_step(
        torch.as_tensor(table), torch.as_tensor(ids), window=window,
        block_rows=block_rows,
        backend={"pallas": "cuda"}.get(backend, backend))
    assert got.shape == (n, width)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(got.numpy(), table[ids])


@pytest.mark.parametrize("backend", ["index", "coalesced", "cuda", "auto"])
def test_gathers_in_a_step_take_no_digest_and_no_engine(backend,
                                                       monkeypatch):
    """Inside `in_step` an embedding lookup plans in the step: no stream
    digest, no engine, no copy of the ids to numpy; outside it the same
    lookup goes through the engine cache, as before."""
    table, ids = _table_and_ids(500, 8, 48, 7)
    table = torch.as_tensor(table)
    ids = torch.as_tensor(ids).reshape(6, 8)

    def refuse(*args, **kwargs):
        raise AssertionError("planned outside the step")

    with monkeypatch.context() as m:
        m.setattr(gather_engine, "stream_digest", refuse)
        m.setattr(indirect_stream, "get_gather_engine", refuse)
        m.setattr(torch.Tensor, "numpy", refuse)
        with indirect_stream.in_step():
            got = TL.embedding_apply({"embed": table}, ids, backend=backend,
                                     window=32)
    assert torch.equal(got, table[ids.long()])
    assert gather_engine_cache_stats()["size"] == 0
    if backend != "index":
        TL.embedding_apply({"embed": table}, ids, backend=backend, window=32)
        assert gather_engine_cache_stats()["size"] == 1


def test_in_step_cuda_gather_plans_untrimmed_at_the_window(monkeypatch):
    """The ``cuda`` gather of a step lowers a schedule of ``max_warps =
    window`` (nothing read back to trim it), as `repro`'s traced stream
    does."""
    from repro_torch.kernels import coalesced_gather as tg

    seen = []
    lower = tg.build_gather_plan

    def spy(schedule, **kw):
        seen.append(schedule.max_warps)
        return lower(schedule, **kw)

    monkeypatch.setattr(tg, "build_gather_plan", spy)
    table, ids = _table_and_ids(500, 8, 70, 8)
    got = indirect_stream.gather_in_step(
        torch.as_tensor(table), torch.as_tensor(ids), window=64,
        block_rows=8, backend="cuda")
    assert seen == [64]
    assert torch.equal(got, torch.as_tensor(table[ids]))


def test_a_tensor_cache_write_equals_the_int_write():
    """`_write_cache` and `_decode_mask` at a 0-d int32 index: the same
    bytes and mask as at the Python int, and no bounds check on the host
    (the caller sizes the cache)."""
    rng = np.random.default_rng(9)
    for sq, at in ((1, 0), (1, 5), (3, 2)):
        new = torch.as_tensor(rng.standard_normal((2, sq, 4, 8)),
                              dtype=torch.float32)
        by_int, by_tensor = torch.zeros((2, 8, 4, 8)), torch.zeros(
            (2, 8, 4, 8))
        TL._write_cache(by_int, new, at)
        TL._write_cache(by_tensor, new, torch.tensor(at, dtype=torch.int32))
        assert torch.equal(by_int, by_tensor)
        assert torch.equal(
            TL._decode_mask(at, sq, 8, "cpu"),
            TL._decode_mask(torch.tensor(at, dtype=torch.int32), sq, 8,
                            "cpu"))


# -- the cache write on a process mesh -----------------------------------


@pytest.mark.parametrize("placements", ["replicated", "sequence"])
def test_a_dtensor_cache_write_equals_index_copy(placements):
    """`sharding.dtensor.index_copy_` on a one-rank gloo mesh, the cache
    laid out replicated or with its sequence dim sharded over 'model' (an
    MLA latent's layout, the select over the shard): the bytes of a plain
    ``index_copy_`` at a 0-d int32 index."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import free_port, make_process_mesh
    from repro_torch.sharding import dtensor

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_process_mesh(1, 1, device="cpu")
        rng = np.random.default_rng(10)
        cache = torch.as_tensor(rng.standard_normal((2, 8, 6)),
                                dtype=torch.float32)
        new = torch.as_tensor(rng.standard_normal((2, 3, 6)),
                              dtype=torch.float32)
        index = torch.tensor(4, dtype=torch.int32)
        place = [Replicate(), Replicate() if placements == "replicated"
                 else Shard(1)]
        got = dtensor.wrap(cache.clone(), mesh, place)
        TL._write_cache(got, dtensor.replicated_value(new, mesh), index)
        want = cache.clone()
        TL._write_cache(want, new, index)
        assert torch.equal(got.to_local(), want)
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def test_local_offset_is_where_local_chunk_starts():
    """Each rank's first index along a dim sharded over one or two mesh
    dims, unevenly too, is where `local_chunk`'s shard starts."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.sharding import dtensor

    class Mesh:
        def __init__(self, sizes, ranks):
            self.sizes, self.ranks = sizes, ranks

        def size(self, i):
            return self.sizes[i]

        def get_local_rank(self, i):
            return self.ranks[i]

    full = torch.arange(2 * 37).reshape(2, 37)
    for sizes, place in (((4,), [Shard(1)]), ((2, 3), [Shard(1), Shard(1)]),
                         ((2, 4), [Shard(0), Shard(1)]),
                         ((3, 2), [Replicate(), Shard(1)])):
        for ranks in np.ndindex(*sizes):
            mesh = Mesh(sizes, ranks)
            part = dtensor.local_chunk(full, mesh, place)
            first = dtensor.local_offset(full.shape, mesh, place, 1)
            if part.shape[1]:
                assert int(part[0, 0]) % 37 == first, (sizes, ranks)
            assert tuple(part.shape) == dtensor.local_shape(
                full.shape, mesh, place)


def test_mla_decode_cell_runs_on_a_fake_mesh():
    """A reduced deepseek decode cell on a fake 2x4 world: its latent
    cache is sharded over 'model' on the sequence (`repro`'s KV rule on
    the stacked latent), and the write at the cache index lands there."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun as dr

    res = dr.run_cell(ARCHS["deepseek-v2-lite-16b"].reduced(),
                      ShapeCell("decode_mini", 64, 8, "decode"), save=False,
                      device="cpu", mesh_shape=(2, 4))
    assert res.ok, res.error


# -- C27: the ZeRO-1 fold of a bias already on 'model' ---------------------


def _mesh(shape, names):
    return SimpleNamespace(shape=shape, axis_names=names)


@pytest.mark.parametrize("mesh,bias,ffn_in", [
    (((16, 16), ("data", "model")), (("data", "model"),),
     (("data", "model"),)),
    (((2, 16, 16), ("pod", "data", "model")), ("model",),
     (("pod", "data", "model"),)),
])
def test_zero1_folds_a_model_sharded_bias_jointly(mesh, bias, ffn_in):
    """whisper-large-v3's (1280,) q/k/v biases and (5120,) FFN-in biases,
    on 'model' with no free dim: the DP axes join 'model' on that dim
    where dp x model divides it (1280 / 256 on 16x16, 5120 / 512 on both),
    `repro`'s bytes a device; 1280 on 2x16x16 stays on 'model' (C27)."""
    from repro_torch.models import param_shapes

    specs = rules.zero1_tensor_pspecs(param_shapes(ARCHS["whisper-large-v3"]),
                                      _mesh(*mesh))
    assert specs["dec.0.self_attn.bq"] == bias
    assert specs["enc.3.attn.bv"] == bias
    assert specs["dec.7.ffn.b_in"] == ffn_in
    assert specs["dec.0.self_attn.wq"] == (("pod", "data")
                                           if len(mesh[0]) == 3 else "data",
                                           "model")
