"""The port's model stack (`repro_torch.models`) against `repro.models` for
every reduced arch in `ARCHS`, with `repro`'s initialised parameters carried
across by `core.interop.model_params_from_numpy`: forward logits and
`decode_step` logits at ``cache_dtype="float32"`` within
``1e-5 + 1e-5 * |ref|`` (Mamba2 and xLSTM too: their chunked scans agree
to that here), logits at the default bf16 cache within 2e-2 (as `repro`'s
own tests), greedy `generate` tokens identical, and `lm_loss` values; the
parameter carry's round trip, the embedding backends, and the runtime
flags that change nothing."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.launch.serve import generate as j_generate
from repro.models import build_model as j_build_model
from repro.models import count_params as j_count_params
from repro.models import lm_loss as j_lm_loss
from repro.models import make_input_batch as j_make_input_batch
from repro.models.transformer import Runtime as JRuntime
from repro_torch.configs import ARCHS
from repro_torch.core.engine import clear_engine_cache, clear_schedule_cache
from repro_torch.core.gather_engine import clear_gather_engine_cache
from repro_torch.core.interop import model_params_from_numpy, \
    model_params_to_numpy
from repro_torch.launch.serve import generate
from repro_torch.models import Runtime, build_model, count_params, \
    input_specs, lm_loss, make_input_batch

NAMES = sorted(ARCHS)
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
B, S = 2, 24  # 24 tokens: two SSD/mLSTM chunks of 16, the second padded


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    clear_engine_cache()
    clear_schedule_cache()
    clear_gather_engine_cache()
    yield


@functools.lru_cache(maxsize=None)
def _repro(name):
    """`repro`'s reduced model, its parameters and a batch, built once per
    arch in this module. The model's functions are jitted (as `repro`'s
    `generate` jits its steps): on the CPU that costs a third of eager
    dispatch here."""
    jcfg = J_ARCHS[name].reduced()
    jmodel = j_build_model(jcfg)
    jmodel = dataclasses.replace(
        jmodel, forward=jax.jit(jmodel.forward, static_argnums=2),
        decode_step=jax.jit(jmodel.decode_step, static_argnums=3),
        extras={k: jax.jit(f, static_argnums=2)
                for k, f in jmodel.extras.items()})
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    jbatch = j_make_input_batch(jcfg, B, S, key=jax.random.PRNGKey(1))
    return jcfg, jmodel, jparams, jbatch


def _port(name):
    """The port's model with `repro`'s parameters, and the same batch."""
    jcfg, jmodel, jparams, jbatch = _repro(name)
    cfg = ARCHS[name].reduced()
    params = model_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    batch = {k: torch.as_tensor(np.array(v)) for k, v in jbatch.items()}
    return cfg, build_model(cfg), params, batch


def _prime(model, params, cache, batch, rt):
    if model.cfg.family == "audio":
        cache["enc_out"] = model.extras["encode"](params, batch["enc_input"],
                                                  rt)
    if model.cfg.family == "vlm":
        cache["image_embeds"] = batch["image_embeds"]
    return cache


@pytest.mark.parametrize("name", NAMES)
def test_params_carry_and_round_trip(name):
    """Every stacked subtree is unstacked into one module per layer, the
    values are `repro`'s, and the inverse restacks `repro`'s pytree."""
    jcfg, _, jparams, _ = _repro(name)
    cfg, _, params, _ = _port(name)
    tree = jax.tree.map(np.asarray, jparams)
    back = model_params_to_numpy(cfg, params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert count_params(params) == j_count_params(jparams)
    names = dict(params.named_parameters())
    assert all(p.requires_grad for p in names.values())
    layer = {"dense": "units.pos0.0.attn.wq", "moe": "units.pos0.0.attn.wq",
             "hybrid": "mamba_units.0.1.mixer.w_in",
             "ssm": "mlstm.0.0.cell.wq", "audio": "dec.1.cross_attn.bk",
             "vlm": "self_units.1.0.ffn.w_gate"}[cfg.family]
    assert layer in names


@pytest.mark.parametrize("name", NAMES)
def test_forward_and_loss_match_repro(name):
    jcfg, jmodel, jparams, jbatch = _repro(name)
    cfg, model, params, batch = _port(name)
    want, jaux = jmodel.forward(jparams, jbatch, JRuntime())
    with torch.no_grad():
        got, aux = model.forward(params, batch, Runtime())
    assert got.shape == (B, S, cfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    mask = (np.arange(S)[None, :] % 3 != 0).astype(np.int32).repeat(B, 0)
    for extra in ({}, {"loss_mask": mask}):
        jl = j_lm_loss(jmodel, jparams, dict(jbatch, **extra), JRuntime())
        with torch.no_grad():
            tl = lm_loss(model, params, dict(
                batch, **{k: torch.as_tensor(v) for k, v in extra.items()}),
                Runtime())
        np.testing.assert_allclose(float(tl), float(jl), **TOL)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_decode_step_matches_repro(name, cache_dtype):
    """A prefill through `decode_step` (the whole prompt), then one step:
    the logits, and the cache index, against `repro`'s."""
    jcfg, jmodel, jparams, jbatch = _repro(name)
    cfg, model, params, batch = _port(name)
    jrt, rt = JRuntime(cache_dtype=cache_dtype), Runtime(
        cache_dtype=cache_dtype)
    tol = TOL if cache_dtype == "float32" else BF16_TOL
    jcache = _prime(jmodel, jparams, jmodel.init_cache(B, S + 4, jrt),
                    jbatch, jrt)
    cache = _prime(model, params, model.init_cache(B, S + 4, rt,
                                                   device="cpu"), batch, rt)
    nxt = np.array(jbatch["tokens"][:, :1])
    with torch.no_grad():
        for toks in (jbatch["tokens"], nxt):
            want, jcache = jmodel.decode_step(jparams, toks, jcache, jrt)
            got, cache = model.decode_step(
                params, torch.as_tensor(np.array(toks)), cache, rt)
            assert got.shape == (B, 1, cfg.vocab_size)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    assert cache["index"] == int(jcache["index"]) == S + 1


@pytest.mark.parametrize("name", NAMES)
def test_greedy_generate_tokens_equal_repro(name):
    jcfg, jmodel, jparams, jbatch = _repro(name)
    cfg, model, params, batch = _port(name)
    prompt = jbatch["tokens"][:, :8]
    want = j_generate(jmodel, jparams, prompt, max_new_tokens=4,
                      rt=JRuntime(cache_dtype="float32"), extras_batch=jbatch)
    got = generate(model, params, torch.as_tensor(np.array(prompt)),
                   max_new_tokens=4, rt=Runtime(cache_dtype="float32"),
                   extras_batch=batch)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "zamba2-1.2b",
                                  "xlstm-1.3b", "deepseek-v2-lite-16b"])
def test_token_by_token_decode_matches_prefill(name):
    """One-token steps (the recurrent Mamba2/mLSTM updates, the cached
    attention, MLA's latent cache) against the parallel forward at every
    position, at a float32 cache."""
    cfg, model, params, batch = _port(name)
    rt = Runtime(cache_dtype="float32")
    tokens = batch["tokens"][:1, :8]
    with torch.no_grad():
        want, _ = model.forward(params, {"tokens": tokens}, rt)
        cache = model.init_cache(1, 16, rt, device="cpu")
        steps = []
        for t in range(8):
            lg, cache = model.decode_step(params, tokens[:, t:t + 1], cache,
                                          rt)
            steps.append(lg[:, 0])
    # MoE: one token a step has its own capacity, so only dense archs and
    # deepseek's lead + shared path are compared at every position below
    got = torch.stack(steps, dim=1)
    if cfg.moe is None:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4)
    else:
        np.testing.assert_allclose(got[:, 0].numpy(), want[:, 0].numpy(),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["smollm-360m", "deepseek-v2-lite-16b",
                                  "zamba2-1.2b"])
@pytest.mark.parametrize("backend", ["coalesced", "cuda", "auto"])
def test_embedding_backends_give_the_same_logits(name, backend):
    """Every gather backend copies the table's rows, so the logits equal
    the ``index`` embedding's bitwise (``cuda``: the kernel's plain
    version on the CPU)."""
    cfg, model, params, batch = _port(name)
    with torch.no_grad():
        want, _ = model.forward(params, batch, Runtime())
        got, _ = model.forward(params, batch, Runtime(
            embed_backend=backend, embed_window=32, embed_block_rows=8))
    assert torch.equal(got, want)


def test_scan_remat_and_layout_flags_change_nothing():
    cfg, model, params, batch = _port("qwen2-1.5b")
    with torch.no_grad():
        want, _ = model.forward(params, batch, Runtime())
        for rt in (Runtime(scan_layers=False), Runtime(remat="full"),
                   Runtime(seq_shard_attention=True,
                           moe_ep_constraint=True)):
            got, _ = model.forward(params, batch, rt)
            assert torch.equal(got, want)


def test_init_batch_and_specs_are_seeded_and_shaped():
    cfg = ARCHS["whisper-large-v3"].reduced()
    model = build_model(cfg)
    a = model.init(torch.Generator().manual_seed(5), device="cpu")
    b = model.init(torch.Generator().manual_seed(5), device="cpu")
    c = model.init(torch.Generator().manual_seed(6), device="cpu")
    assert torch.equal(a.dec[0].ffn.w_in, b.dec[0].ffn.w_in)
    assert not torch.equal(a.dec[0].ffn.w_in, c.dec[0].ffn.w_in)
    assert a.tok.embed.dtype == torch.float32
    batch = make_input_batch(cfg, 3, 5, torch.Generator().manual_seed(1),
                             device="cpu")
    specs = input_specs(cfg, 3, 5)
    assert set(batch) == set(specs) == {"tokens", "enc_input"}
    for k in batch:
        assert batch[k].shape == specs[k].shape
        assert batch[k].dtype == specs[k].dtype
        assert specs[k].device.type == "meta"
    assert int(batch["tokens"].max()) < cfg.vocab_size
    vlm = ARCHS["llama-3.2-vision-11b"].reduced()
    assert make_input_batch(vlm, 2, 4, device="cpu")["image_embeds"].shape \
        == (2, vlm.cross_attn.n_image_tokens, vlm.d_model)
