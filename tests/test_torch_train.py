"""The port's training half against `repro`'s on the same numpy inputs, with
`repro`'s parameters carried by `core.interop`: `lm_loss` value and
gradients for every reduced arch (loss within 1e-5 relative, each gradient
leaf within ``1e-4 * max|g| + 1e-7``), the remat modes, the embedding's
gradients per gather backend (the cuda backend refuses autograd, C19), one
`make_update_fn` update (microbatches 1 and 2, compression off and on;
float32 accumulation, C20), the step functions, `train()` and the
launcher."""
import dataclasses
import functools
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import ARCHS as J_ARCHS
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.models import build_model as j_build_model
from repro.models import lm_loss as j_lm_loss
from repro.models import make_input_batch as j_make_input_batch
from repro.models.transformer import Runtime as JRuntime
from repro.optim.compression import init_residual as j_init_residual
from repro.optim.optimizer import OptConfig as JOptConfig
from repro.optim.optimizer import init_opt_state as j_init_opt_state
from repro.train import steps as jsteps
from repro.train.loop import TrainConfig as JTrainConfig
from repro.train.loop import make_update_fn as j_make_update_fn
from repro_torch.configs import ARCHS, get_arch
from repro_torch.core.engine import clear_engine_cache, clear_schedule_cache
from repro_torch.core.gather_engine import clear_gather_engine_cache
from repro_torch.core.interop import model_params_from_numpy, \
    model_params_to_numpy, opt_state_from_numpy, opt_state_to_numpy
from repro_torch.core.runtime import DeviceMesh
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import train as launch_train
from repro_torch.models import Runtime, build_model, lm_loss
from repro_torch.optim.compression import init_residual
from repro_torch.optim.optimizer import OptConfig, init_opt_state
from repro_torch.optim.tree import map_tree, named_tensors
from repro_torch.train import loop as tloop
from repro_torch.train import steps as tsteps
from repro_torch.train.loop import TrainConfig, make_update_fn, train, \
    value_and_grad

ROOT = Path(__file__).resolve().parents[1]
NAMES = sorted(ARCHS)
B, S = 2, 24
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
UPDATE_TOL = dict(rtol=1e-5, atol=1e-5)
UPDATE_ARCHS = ["deepseek-v2-lite-16b", "tinyllama-1.1b", "zamba2-1.2b"]


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    clear_engine_cache()
    clear_schedule_cache()
    clear_gather_engine_cache()
    yield


@functools.lru_cache(maxsize=None)
def _repro(name, dtype=None):
    """`repro`'s reduced model, its numpy parameters, a batch, and the
    jitted loss value and gradients on it."""
    jcfg = J_ARCHS[name].reduced()
    if dtype is not None:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
    jmodel = j_build_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    jbatch = j_make_input_batch(jcfg, B, S, key=jax.random.PRNGKey(1))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: j_lm_loss(jmodel, p, b, JRuntime())))(jparams, jbatch)
    return (jcfg, jmodel, jax.tree.map(np.asarray, jparams),
            {k: np.asarray(v) for k, v in jbatch.items()},
            float(loss), jax.tree.map(np.asarray, grads))


def _port(name, dtype=None):
    _, _, params, batch, _, _ = _repro(name, dtype)
    cfg = ARCHS[name].reduced()
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return (cfg, build_model(cfg),
            model_params_from_numpy(cfg, params, device="cpu"),
            {k: torch.from_numpy(v.copy()) for k, v in batch.items()})


def _assert_grads_close(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rtol * np.abs(w).max() + atol)


@pytest.mark.parametrize("name", NAMES)
def test_lm_loss_and_grads_match_repro(name):
    _, _, _, _, jloss, jgrads = _repro(name)
    cfg, model, params, batch = _port(name)
    loss, grads = value_and_grad(
        lambda p: lm_loss(model, p, batch, Runtime()), params)
    assert abs(float(loss) - jloss) <= LOSS_RTOL * abs(jloss)
    assert all(not g.requires_grad for g in named_tensors(grads).values())
    _assert_grads_close(model_params_to_numpy(cfg, grads), jgrads)


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def _backward_ops(model, params, batch, remat):
    """(loss, grads, matmuls the backward pass runs) under `remat`."""
    loss = lm_loss(model, params, batch, Runtime(remat=remat))
    with _OpCounter() as ops:
        grads = torch.autograd.grad(loss, list(params.parameters()))
    mm = sum(ops.counts.get(f, 0) for f in (torch.ops.aten.mm.default,
                                            torch.ops.aten.addmm.default))
    return float(loss.detach()), grads, mm, ops.counts.get(
        torch.ops.aten.bmm.default, 0)


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "whisper-large-v3",
                                  "xlstm-1.3b", "zamba2-1.2b"])
def test_remat_modes_agree_and_recompute(name):
    """full and dots give the loss and gradients of none; full recomputes
    each checkpointed layer's weight matmuls in the backward pass, dots
    keeps them (`dots_with_no_batch_dims_saveable`) and recomputes only
    the batched ones."""
    _, model, params, batch = _port(name)
    loss, grads, mm, bmm = _backward_ops(model, params, batch, "none")
    seen = {}
    for remat in ("full", "dots"):
        l2, g2, mm2, bmm2 = _backward_ops(model, params, batch, remat)
        assert abs(l2 - loss) <= 1e-6 * abs(loss)
        for a, b in zip(grads, g2):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6,
                                       atol=1e-6 * float(a.abs().max()))
        seen[remat] = (mm2, bmm2)
    assert seen["full"][0] > mm
    assert seen["dots"][0] == mm
    assert seen["dots"][1] >= bmm
    with pytest.raises(ValueError, match="remat"):
        lm_loss(model, params, batch, Runtime(remat="some"))


def test_embedding_grads_per_backend_and_c19():
    """index and coalesced give the same embedding gradient, equal to
    `repro`'s under jnp and coalesced; cuda (`repro`'s pallas) refuses
    autograd on the CPU as `repro` does, and gathers under no_grad; auto
    on the CPU is coalesced and differentiates."""
    name = "tinyllama-1.1b"
    jcfg, jmodel, jparams, jbatch, _, _ = _repro(name)
    cfg, model, params, batch = _port(name)
    want = {}
    for backend in ("jnp", "coalesced"):
        g = jax.grad(lambda p: j_lm_loss(
            jmodel, p, jbatch, JRuntime(embed_backend=backend)))(jparams)
        want[backend] = np.asarray(g["tok"]["embed"])
    np.testing.assert_allclose(want["jnp"], want["coalesced"], rtol=1e-6,
                               atol=1e-9)
    got = {}
    for backend in ("index", "coalesced", "auto"):
        _, grads = value_and_grad(lambda p: lm_loss(
            model, p, batch, Runtime(embed_backend=backend)), params)
        got[backend] = grads.tok.embed.numpy()
    np.testing.assert_array_equal(got["index"], got["coalesced"])
    np.testing.assert_array_equal(got["auto"], got["coalesced"])
    scale = np.abs(want["jnp"]).max()
    np.testing.assert_allclose(got["index"], want["jnp"], rtol=0,
                               atol=GRAD_RTOL * scale + GRAD_ATOL)
    with pytest.raises(NotImplementedError, match="no gradient"):
        lm_loss(model, params, batch, Runtime(embed_backend="cuda"))
    with pytest.raises(NotImplementedError):
        jax.grad(lambda p: j_lm_loss(
            jmodel, p, jbatch, JRuntime(embed_backend="pallas")))(jparams)
    with torch.no_grad():
        plain = lm_loss(model, params, batch, Runtime())
        via_cuda = lm_loss(model, params, batch,
                           Runtime(embed_backend="cuda"))
    assert float(plain) == float(via_cuda)


def _update_inputs(name, dtype=None):
    """Both packages' reduced model, parameters and a pipeline batch."""
    jcfg, jmodel, jparams, _, _, _ = _repro(name, dtype)
    cfg, model, params, _ = _port(name, dtype)
    data = dict(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    jbatch = JTokenPipeline(JDataConfig(**data)).batch_at(3)
    batch = {k: torch.from_numpy(v.copy()) for k, v in jbatch.items()}
    return jcfg, jmodel, jparams, jbatch, cfg, model, params, batch


@pytest.mark.parametrize("compression", [False, True])
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("name", UPDATE_ARCHS)
def test_update_matches_repro(name, microbatches, compression):
    jcfg, jmodel, jparams, jbatch, cfg, model, params, batch = \
        _update_inputs(name)
    kw = dict(microbatches=microbatches, grad_compression=compression)
    j_update = jax.jit(j_make_update_fn(jmodel, JOptConfig(), JRuntime(),
                                        JTrainConfig(**kw)))
    jopt = j_init_opt_state(jparams)
    jres = j_init_residual(jparams) if compression else \
        jax.tree.map(lambda _: jnp.zeros((), jnp.float32), jparams)
    jp, jo, _, jm = j_update(jparams, jopt, jres, jbatch)

    update = make_update_fn(model, OptConfig(), Runtime(), TrainConfig(**kw))
    opt = init_opt_state(params)
    res = init_residual(params) if compression else None
    p, o, _, m = update(params, opt, res, batch)
    assert p is params and o is opt
    assert abs(float(m["loss"]) - float(jm["loss"])) <= \
        LOSS_RTOL * abs(float(jm["loss"]))
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    got = model_params_to_numpy(cfg, p)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jp)):
        np.testing.assert_allclose(g, np.asarray(w), **UPDATE_TOL)
    mu, nu, step = opt_state_to_numpy(cfg, o)
    for mine, theirs in ((mu, jo.mu), (nu, jo.nu)):
        for g, w in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
            _assert_moment_close(g, np.asarray(w), compression)
    assert int(step) == int(jo.step) == 1


def _assert_moment_close(got, want, compression):
    """Within ``1e-5 + 1e-5 * max|want|``. Under compression a gradient
    element whose scaled value lies within the two frameworks' rounding of a
    .5 tie rounds to neighbouring int8 levels: such elements (at most 0.1%
    of a leaf) may differ by one quantization step of the moment, its
    largest magnitude / 127."""
    scale = np.abs(want).max()
    bad = np.abs(got - want) > 1e-5 * np.abs(want) + 1e-5 * scale
    if compression and bad.any():
        assert bad.mean() <= 1e-3, bad.sum()
        np.testing.assert_allclose(got[bad], want[bad], rtol=0,
                                   atol=1.0001 * scale / 127)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


def test_c20_microbatch_gradients_accumulate_in_float32(monkeypatch):
    """A bf16 model at microbatches 2: the gradients AdamW receives are
    float32, the float32 sum of each microbatch's bf16 gradients halved
    (the parameters' dtype would round each partial sum to bf16), and each
    first-moment leaf is within 5e-2 of `repro`'s in relative norm: bf16
    forward and backward passes in two frameworks round apart, and one
    batch's bf16 gradients already differ by up to ~2.1% there."""
    jcfg, jmodel, jparams, jbatch, cfg, model, params, batch = \
        _update_inputs("tinyllama-1.1b", "bfloat16")
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in batch.items()}
              for i in range(2)]
    parts = [value_and_grad(lambda p, mb=mb: lm_loss(model, p, mb, Runtime()),
                            params)[1] for mb in halves]
    want = map_tree(lambda a, b: (a.float() + b.float()) / 2, parts[0],
                    parts[1])
    seen = {}
    real = tloop.adamw_update

    def spy(cfg_, params_, grads, state):
        seen["grads"] = map_tree(lambda g: g.clone(), grads)
        return real(cfg_, params_, grads, state)

    monkeypatch.setattr(tloop, "adamw_update", spy)
    update = make_update_fn(model, OptConfig(), Runtime(),
                            TrainConfig(microbatches=2))
    _, opt, _, _ = update(params, init_opt_state(params), None, batch)
    got, ref = named_tensors(seen["grads"]), named_tensors(want)
    assert all(g.dtype == torch.float32 for g in got.values())
    for name, g in got.items():
        torch.testing.assert_close(g, ref[name], rtol=0, atol=0)
    a, b = named_tensors(parts[0]), named_tensors(parts[1])
    assert any(bool(((a[n] + b[n]) / 2).float().ne(ref[n]).any())
               for n in ref), "bf16 accumulation would round the same"
    j_update = jax.jit(j_make_update_fn(jmodel, JOptConfig(), JRuntime(),
                                        JTrainConfig(microbatches=2)))
    _, jo, _, _ = j_update(jparams, j_init_opt_state(jparams),
                           jax.tree.map(lambda _: jnp.zeros(()), jparams),
                           jbatch)
    mu = opt_state_to_numpy(cfg, opt)[0]
    for g, w in zip(jax.tree.leaves(mu), jax.tree.leaves(jo.mu)):
        w = np.asarray(w, np.float64)
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert err < 5e-2, err


def test_train_step_and_inference_steps_match_repro():
    jcfg, jmodel, jparams, jbatch, cfg, model, params, batch = \
        _update_inputs("qwen2-1.5b")
    prefill = tsteps.make_prefill_step(model, Runtime())(params, batch)
    jprefill = jax.jit(jsteps.make_prefill_step(jmodel, JRuntime()))(
        jparams, jbatch)
    np.testing.assert_allclose(prefill.numpy(), np.asarray(jprefill),
                               rtol=1e-5, atol=1e-5)
    serve = tsteps.make_serve_step(model, Runtime(cache_dtype="float32"))
    cache = model.init_cache(4, 20, Runtime(cache_dtype="float32"),
                             device="cpu")
    logits, cache = serve(params, batch["tokens"], cache)
    np.testing.assert_allclose(logits[:, 0].numpy(), prefill.numpy(),
                               rtol=1e-4, atol=1e-4)
    assert cache["index"] == 16
    jp, jo, jm = jax.jit(jsteps.make_train_step(jmodel, JOptConfig(),
                                                JRuntime()))(
        jparams, j_init_opt_state(jparams), jbatch)
    p, o, m = tsteps.make_train_step(model, OptConfig(), Runtime())(
        params, init_opt_state(params), batch)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= \
        LOSS_RTOL * abs(float(jm["loss"]))
    for g, w in zip(jax.tree.leaves(model_params_to_numpy(cfg, p)),
                    jax.tree.leaves(jp)):
        np.testing.assert_allclose(g, np.asarray(w), **UPDATE_TOL)
    assert int(o.step) == 1


def test_opt_state_carry_round_trip():
    _, _, jparams, _, _, _ = _repro("zamba2-1.2b")
    cfg = ARCHS["zamba2-1.2b"].reduced()
    rng = np.random.default_rng(0)
    mu = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), jparams)
    state = opt_state_from_numpy(cfg, (mu, mu, np.int32(4)), device="cpu")
    assert not any(t.requires_grad for t in state.mu.parameters())
    back = opt_state_to_numpy(cfg, state)
    assert jax.tree.structure(back[0]) == jax.tree.structure(mu)
    for g, w in zip(jax.tree.leaves(back[1]), jax.tree.leaves(mu)):
        np.testing.assert_array_equal(g, w)
    assert int(back[2]) == 4


def test_train_loss_decreases():
    """`repro`'s `test_training_loss_decreases`, on the port."""
    cfg = get_arch("smollm-360m").reduced()
    out = train(
        build_model(cfg),
        rt=Runtime(),
        opt_cfg=OptConfig(lr=1e-3, warmup_steps=5, total_steps=40),
        tcfg=TrainConfig(total_steps=40, log_every=5),
        data_cfg=DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                            global_batch=8),
        device="cpu",
    )
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 9 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.3
    assert out["steps"] == 40


def test_train_resumes_from_its_checkpoint(tmp_path):
    """A run cut at step 4 and restarted ends with the parameters of an
    uninterrupted run (the pipeline skips to the restored step)."""
    cfg = get_arch("smollm-360m").reduced()
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    opt = OptConfig(lr=1e-3, warmup_steps=2, total_steps=8)

    def run(steps, ckpt_dir=None):
        return train(build_model(cfg), opt_cfg=opt, data_cfg=data,
                     tcfg=TrainConfig(total_steps=steps, ckpt_every=2,
                                      ckpt_dir=ckpt_dir, log_every=1),
                     device="cpu")

    whole = run(8)
    run(5, str(tmp_path))
    resumed = run(8, str(tmp_path))
    assert [h["step"] for h in resumed["history"]] == [5, 6, 7]
    for (n, a), b in zip(whole["params"].named_parameters(),
                         resumed["params"].parameters()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=n)
    assert int(resumed["opt_state"].step) == 8


def test_train_on_a_mesh_of_more_than_one_device_raises():
    """A grid of devices driven from one process (the sharded SpMV
    engine's mesh) cannot train: training shards over a process mesh, one
    rank a device (`test_torch_train_sharded.py`)."""
    cfg = get_arch("smollm-360m").reduced()
    mesh = DeviceMesh(np.array([[torch.device("cpu")],
                                [torch.device("cpu")]], dtype=object))
    with pytest.raises(ValueError, match="make_process_mesh"):
        train(build_model(cfg), mesh=mesh)


def test_launch_train_on_the_cpu_exits_0():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "smollm-360m", "--reduced", "--steps", "3", "--batch", "2",
         "--seq", "16", "--microbatches", "2", "--grad-compression",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "HOME": str(ROOT)})
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout)
    assert [h["step"] for h in out["history"]] == [0, 2]
    assert out["tokens_per_s"] > 0 and out["device"] == "cpu"
    assert out["peak_device_memory_bytes"] is None


def test_launch_train_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "smollm-360m", "--reduced", "--steps",
                           "1"])
    with pytest.raises(NotImplementedError, match="no gradient"):
        launch_train.main(["--arch", "smollm-360m", "--reduced", "--steps",
                           "1", "--batch", "2", "--seq", "8",
                           "--embed-backend", "cuda", "--device", "cpu"])
