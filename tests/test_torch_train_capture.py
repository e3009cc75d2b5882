"""`train`'s update over static buffers (`train.loop.update_over_buffers`),
the port of `repro`'s ``jax.jit(make_update_fn(...))`` that the card
captures as one CUDA graph, on the CPU, where it runs eagerly:

  * bitwise equal to `make_update_fn`'s update, two steps, microbatches 1
    and 2, compression off and on (the residual copied back);
  * within `tests/test_torch_train.py`'s ``UPDATE_TOL`` of `repro`'s jitted
    update;
  * reading its static batch when it runs (batches b1, b2, b1 from one
    state give b1's result twice, ROADMAP C10's pattern);
  * ``capture=True`` raising on the CPU and on a gloo process mesh (a
    one-rank group), where the default trains eagerly;
  * the bias corrections made without a host copy, with today's bits;
  * a resume restoring into the tensors the update reads;
  * ZeRO-1's stacked moments (ROADMAP C27) updating as the per-layer
    moments do, on a one-rank gloo mesh.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.models import build_model as j_build_model
from repro.models.transformer import Runtime as JRuntime
from repro.optim.compression import init_residual as j_init_residual
from repro.optim.optimizer import OptConfig as JOptConfig
from repro.optim.optimizer import init_opt_state as j_init_opt_state
from repro.train.loop import TrainConfig as JTrainConfig
from repro.train.loop import make_update_fn as j_make_update_fn
from repro_torch.configs import ARCHS, get_arch
from repro_torch.core.engine import clear_engine_cache, clear_schedule_cache
from repro_torch.core.gather_engine import clear_gather_engine_cache
from repro_torch.core.interop import model_params_from_numpy, \
    model_params_to_numpy, opt_state_to_numpy
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import Runtime, build_model
from repro_torch.optim.compression import init_residual
from repro_torch.optim.optimizer import OptConfig, bias_corrections, \
    init_opt_state
from repro_torch.optim.tree import leaves, named_tensors
from repro_torch.train import loop as tloop
from repro_torch.train.loop import TrainConfig, make_update_fn, train, \
    update_over_buffers

NAME = "tinyllama-1.1b"
UPDATE_TOL = dict(rtol=1e-5, atol=1e-5)  # test_torch_train.py's
LOSS_RTOL = 1e-5
DATA = dict(seq_len=16, global_batch=4)
CASES = [(1, False), (1, True), (2, False), (2, True)]


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    clear_engine_cache()
    clear_schedule_cache()
    clear_gather_engine_cache()
    yield


@functools.lru_cache(maxsize=None)
def _repro_params(name):
    jcfg = J_ARCHS[name].reduced()
    jmodel = j_build_model(jcfg)
    return jcfg, jmodel, jax.tree.map(
        np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0)))


def _batches(cfg, steps=(3, 4)):
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, **DATA))
    return [pipe.batch_at(s) for s in steps]


def _port_state(name=NAME, compression=False):
    """The port's reduced model, `repro`'s seeded parameters, fresh
    moments and residual, on the CPU."""
    _, _, arrays = _repro_params(name)
    cfg = ARCHS[name].reduced()
    params = model_params_from_numpy(cfg, arrays, device="cpu")
    return (cfg, build_model(cfg), params, init_opt_state(params),
            init_residual(params) if compression else None)


def _bits(tree) -> dict:
    return {n: t.detach().clone() for n, t in named_tensors(tree).items()}


def _assert_bitwise(got: dict, want: dict):
    assert got.keys() == want.keys()
    for n, w in want.items():
        assert torch.equal(got[n], w), n


@pytest.mark.parametrize("microbatches,compression", CASES)
def test_update_over_buffers_equals_make_update_fn_bitwise(microbatches,
                                                           compression):
    """Two updates on two batches: the buffers' update and `make_update_fn`'s
    (the residual threaded through its return) give the same parameters,
    moments, step, residual and metrics, bit for bit; the metrics are the
    same tensors after each call and the residual the same objects."""
    tcfg = TrainConfig(microbatches=microbatches,
                       grad_compression=compression)
    cfg, model, p1, o1, r1 = _port_state(compression=compression)
    _, _, p2, o2, r2 = _port_state(compression=compression)
    residual_ids = {n: id(t) for n, t in named_tensors(r1).items()} \
        if compression else None
    batch = {}
    step = update_over_buffers(model, OptConfig(), Runtime(), tcfg, p1, o1,
                               r1, batch)
    update = make_update_fn(model, OptConfig(), Runtime(), tcfg)
    seen = None
    for host in _batches(cfg):
        batch["tokens"] = torch.from_numpy(host["tokens"].copy())
        out = step()
        assert seen is None or out is seen
        seen = out
        _, _, r2, want = update(p2, o2, r2, {
            "tokens": torch.from_numpy(host["tokens"].copy())})
        for k in ("loss", "grad_norm", "lr"):
            assert torch.equal(out[k], want[k].detach()), k
    _assert_bitwise(_bits(p1), _bits(p2))
    _assert_bitwise(_bits(o1.mu), _bits(o2.mu))
    _assert_bitwise(_bits(o1.nu), _bits(o2.nu))
    assert int(o1.step) == int(o2.step) == 2
    if compression:
        _assert_bitwise(_bits(r1), _bits(r2))
        assert {n: id(t) for n, t in named_tensors(r1).items()} == \
            residual_ids


@functools.lru_cache(maxsize=None)
def _repro_update(microbatches, compression):
    jcfg, jmodel, jparams = _repro_params(NAME)
    jbatch = JTokenPipeline(JDataConfig(vocab_size=jcfg.vocab_size,
                                        **DATA)).batch_at(3)
    kw = dict(microbatches=microbatches, grad_compression=compression)
    j_update = jax.jit(j_make_update_fn(jmodel, JOptConfig(), JRuntime(),
                                        JTrainConfig(**kw)))
    jres = j_init_residual(jparams) if compression else \
        jax.tree.map(lambda _: jnp.zeros((), jnp.float32), jparams)
    jp, jo, _, jm = j_update(jparams, j_init_opt_state(jparams), jres,
                             jbatch)
    return (jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, jo),
            {k: float(v) for k, v in jm.items()}, jbatch)


@pytest.mark.parametrize("microbatches,compression", CASES)
def test_update_over_buffers_matches_repros_jitted_update(microbatches,
                                                          compression):
    """One update against `repro`'s ``jax.jit(make_update_fn(...))`` on
    the same parameters and pipeline batch: loss within 1e-5 relative, lr
    to float32, parameters within ``UPDATE_TOL``, the moments within it
    (under compression at most 0.1% of a leaf one int8 step apart, as
    `test_torch_train.py` allows) and the step 1."""
    jp, jo, jm, jbatch = _repro_update(microbatches, compression)
    cfg, model, params, opt, res = _port_state(compression=compression)
    batch = {k: torch.from_numpy(v.copy()) for k, v in jbatch.items()}
    out = update_over_buffers(
        model, OptConfig(), Runtime(),
        TrainConfig(microbatches=microbatches, grad_compression=compression),
        params, opt, res, batch)()
    assert abs(float(out["loss"]) - jm["loss"]) <= LOSS_RTOL * abs(jm["loss"])
    np.testing.assert_allclose(float(out["grad_norm"]), jm["grad_norm"],
                               rtol=1e-4)
    np.testing.assert_allclose(float(out["lr"]), jm["lr"], rtol=1e-6)
    for g, w in zip(jax.tree.leaves(model_params_to_numpy(cfg, params)),
                    jax.tree.leaves(jp)):
        np.testing.assert_allclose(g, w, **UPDATE_TOL)
    mu, nu, step = opt_state_to_numpy(cfg, opt)
    for mine, theirs in ((mu, jo.mu), (nu, jo.nu)):
        for g, w in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
            scale = np.abs(w).max()
            bad = np.abs(g - w) > 1e-5 * np.abs(w) + 1e-5 * scale
            if compression and bad.any():
                assert bad.mean() <= 1e-3, bad.sum()
                np.testing.assert_allclose(g[bad], w[bad], rtol=0,
                                           atol=1.0001 * scale / 127)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5,
                                           atol=1e-5 * scale)
    assert int(step) == int(jo.step) == 1


def test_static_buffers_are_read_at_call_time():
    """C10's pattern: from one state, the step run on batches b1, b2, b1
    (each copied into the static batch, the state copied back between
    runs) gives b1's loss, parameters and moments twice, bit for bit, and
    b2's apart."""
    cfg, model, params, opt, res = _port_state(compression=True)
    start = [_bits(params), _bits(opt.mu), _bits(opt.nu), _bits(res),
             opt.step.clone()]
    b1, b2 = _batches(cfg)
    batch = {"tokens": torch.zeros(b1["tokens"].shape, dtype=torch.int32)}
    step = update_over_buffers(model, OptConfig(), Runtime(),
                               TrainConfig(grad_compression=True), params,
                               opt, res, batch)
    results = []
    for host in (b1, b2, b1):
        with torch.no_grad():
            for tree, saved in zip((params, opt.mu, opt.nu, res), start):
                for n, t in named_tensors(tree).items():
                    t.copy_(saved[n])
            opt.step.copy_(start[4])
            batch["tokens"].copy_(torch.from_numpy(host["tokens"]))
        out = step()
        results.append((out["loss"].clone(), _bits(params), _bits(opt.mu)))
    (l1, p1, m1), (l2, p2, _), (l3, p3, m3) = results
    assert torch.equal(l1, l3) and not torch.equal(l1, l2)
    _assert_bitwise(p3, p1)
    _assert_bitwise(m3, m1)
    assert any(not torch.equal(p2[n], p1[n]) for n in p1)


def _small_train(**kw):
    cfg = get_arch("smollm-360m").reduced()
    return train(build_model(cfg),
                 opt_cfg=OptConfig(lr=1e-3, warmup_steps=2, total_steps=6),
                 data_cfg=DataConfig(vocab_size=cfg.vocab_size, **DATA),
                 **kw)


def test_capture_true_on_the_cpu_raises():
    """``capture=True`` needs the card; None (the default) and False train
    eagerly on the CPU and give the same history."""
    with pytest.raises(ValueError, match="capture=True needs the card"):
        _small_train(device="cpu", capture=True,
                     tcfg=TrainConfig(total_steps=2))
    runs = [_small_train(device="cpu", capture=c,
                         tcfg=TrainConfig(total_steps=3, log_every=1))
            for c in (None, False)]
    assert [h["loss"] for h in runs[0]["history"]] == \
        [h["loss"] for h in runs[1]["history"]]
    assert not runs[0]["captured"] and runs[0]["capture_seconds"] is None


def test_capture_true_on_a_process_mesh_raises_naming_a4():
    """ROADMAP A4 (done): the sharded update is captured on an NCCL mesh
    only. On a one-rank gloo mesh ``capture=True`` raises ValueError, as
    on the CPU, before anything is drawn; the default (None) and False
    train there eagerly and give the same history."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import free_port, make_process_mesh

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_process_mesh(1, 1, device="cpu")
        with pytest.raises(ValueError, match="capture=True needs the card"):
            _small_train(mesh=mesh, capture=True,
                         tcfg=TrainConfig(total_steps=2))
        runs = [_small_train(mesh=mesh, capture=c, tcfg=TrainConfig(
            total_steps=2, log_every=1)) for c in (None, False)]
        for out in runs:
            assert len(out["history"]) == 2 and not out["captured"]
            assert out["capture_seconds"] is None
            assert [h["kind"] for h in out["history"]] == ["step", "step"]
        assert [h["loss"] for h in runs[0]["history"]] == \
            [h["loss"] for h in runs[1]["history"]]
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def test_bias_corrections_keep_the_host_betas_bits():
    """``1 - beta**step`` from a beta filled on the step's device has the
    bits of the beta copied from the host (the update's former
    ``torch.tensor(beta)``), at every step to 20,000 and for three beta
    pairs."""
    steps = torch.arange(0, 20000, dtype=torch.int32)
    for betas in ((0.9, 0.95), (0.8, 0.999), (0.95, 0.98)):
        got = bias_corrections(OptConfig(betas=betas), steps)
        for b, g in zip(betas, got):
            want = 1 - torch.pow(torch.tensor(b, dtype=torch.float32),
                                 steps.to(torch.float32))
            assert g.dtype == torch.float32
            assert torch.equal(g, want), b


def test_a_resume_restores_into_the_update_buffers(tmp_path, monkeypatch):
    """`train` resumed from its checkpoint copies the stored values into
    the very tensors its update reads (a captured graph reads no others),
    and ends where an uninterrupted run ends."""
    seen = {}
    real_restore, real_buffers = tloop.restore_latest, \
        tloop.update_over_buffers

    def restore(directory, tree, **kw):
        seen["restored"] = tree
        return real_restore(directory, tree, **kw)

    def buffers(model, opt_cfg, rt, tcfg, params, opt_state, *rest):
        seen["buffers"] = {"params": params, "opt": opt_state}
        return real_buffers(model, opt_cfg, rt, tcfg, params, opt_state,
                            *rest)

    whole = _small_train(device="cpu", tcfg=TrainConfig(total_steps=6))
    _small_train(device="cpu", tcfg=TrainConfig(
        total_steps=4, ckpt_every=1, ckpt_dir=str(tmp_path)))
    monkeypatch.setattr(tloop, "restore_latest", restore)
    monkeypatch.setattr(tloop, "update_over_buffers", buffers)
    resumed = _small_train(device="cpu", tcfg=TrainConfig(
        total_steps=6, ckpt_every=1, ckpt_dir=str(tmp_path), log_every=1))
    assert [h["step"] for h in resumed["history"]] == [4, 5]
    for part in ("params", "opt"):
        a, b = seen["restored"][part], seen["buffers"][part]
        assert a is b
        got = named_tensors(a if part == "params" else a.mu)
        assert all(t is named_tensors(
            resumed["params"] if part == "params"
            else resumed["opt_state"].mu)[n] for n, t in got.items())
    assert seen["restored"]["opt"].step is resumed["opt_state"].step
    _assert_bitwise(_bits(resumed["params"]), _bits(whole["params"]))


def test_stacked_moments_update_as_the_per_layer_moments():
    """ROADMAP C27: ZeRO-1's stacked moments (`optimizer.zero1_opt_state`)
    on a one-rank gloo mesh, forced for qwen2's q/k/v biases and its
    attention out-projection: two updates give the parameters of the same
    update on plain tensors, and each stacked moment's rows the plain
    per-layer moments, bit for bit."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import free_port, make_process_mesh
    from repro_torch.sharding import rules
    from repro_torch.sharding.dtensor import distribute_module, full

    name = "qwen2-1.5b"
    cfg, model, plain, plain_opt, _ = _port_state(name)
    _, _, sharded, _, _ = _port_state(name)
    update = make_update_fn(model, OptConfig(), Runtime(), TrainConfig())
    batches = _batches(cfg)
    for host in batches:
        update(plain, plain_opt, None,
               {"tokens": torch.from_numpy(host["tokens"].copy())})
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_process_mesh(1, 1, device="cpu")
        distribute_module(sharded, rules.param_shardings(sharded, mesh))
        folded = rules.zero1_pspecs(sharded, mesh)
        forced = {k: v for k, v in folded.items()
                  if k.endswith(("['bq']", "['bk']", "['bv']", "['wo']"))}
        assert len(forced) == 4
        real = rules.zero1_stacked_pspecs
        rules.zero1_stacked_pspecs = lambda p, mesh, **kw: forced
        try:
            opt = init_opt_state(sharded, zero1=True)
        finally:
            rules.zero1_stacked_pspecs = real
        assert sorted(opt.stacked["mu"]) == sorted(forced)
        for host in batches:
            update(sharded, opt, None,
                   {"tokens": torch.from_numpy(host["tokens"].copy())})
        got = {n: full(t.detach()) for n, t in named_tensors(sharded).items()}
        _assert_bitwise(got, _bits(plain))
        by_key = {leaf.key: leaf for leaf in leaves(plain)}
        for part in ("mu", "nu"):
            want = named_tensors(getattr(plain_opt, part))
            held = named_tensors(getattr(opt, part))
            for key, stack in opt.stacked[part].items():
                rows = full(stack).reshape((-1,) + tuple(
                    want[by_key[key].names[0]].shape))
                for i, n in enumerate(by_key[key].names):
                    assert n not in held
                    assert torch.equal(rows[i], want[n]), (part, n)
            for n, t in held.items():
                assert torch.equal(full(t), want[n]), (part, n)
        assert int(opt.step) == 2
    finally:
        dist.destroy_process_group()
