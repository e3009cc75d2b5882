"""The port's sharded training step on a (data, model) process grid against
`repro`'s single-device jitted step, on four gloo ranks on the CPU.

`repro`'s own multi-device step (`tests/test_sharding.py::
test_multidevice_train_step_runs`) stops in its vocab-sharded embedding
lookup, so the grid is held to `repro`'s single-device `make_train_step` and
`make_update_fn` on the same `interop`-carried parameters and batch, at the
tolerances `test_torch_train.py` holds the single-device update to. One
process grid serves the module (`launch.mesh.run_grid` with
`train.grid.run_cases`): reduced tinyllama-1.1b at batch 4 x 32 on the 2x2,
1x4 and 4x1 meshes, microbatches 2 with compression and reduced smollm-360m
on 2x2, the shards' shapes, the vocab-sharded lookup of data-sharded ids
(C5's site) bitwise, a checkpoint saved on 2x2 restored on 4x1 and on one
process, `train(mesh=...)` against `train()`, and the update `train`
captures on an NCCL mesh (`update_over_buffers` over a static DTensor
batch that `copy_batch` refills) against the eager update bitwise, with
no host read in it. Every other family's update on 2x2 is in
`test_torch_train_sharded_families.py`."""
import dataclasses
import functools
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import build_model as j_build_model
from repro.models import lm_loss as j_lm_loss
from repro.models import make_input_batch as j_make_input_batch
from repro.models.transformer import Runtime as JRuntime
from repro.optim.compression import init_residual as j_init_residual
from repro.optim.optimizer import OptConfig as JOptConfig
from repro.optim.optimizer import init_opt_state as j_init_opt_state
from repro.train.loop import TrainConfig as JTrainConfig
from repro.train.loop import make_update_fn as j_make_update_fn
from repro.train.steps import make_train_step as j_make_train_step
from repro_torch.configs import ARCHS
from repro_torch.core.engine import clear_engine_cache, clear_schedule_cache
from repro_torch.core.gather_engine import clear_gather_engine_cache
from repro_torch.core.interop import model_params_from_numpy, \
    model_params_to_numpy, opt_state_from_numpy
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import run_grid
from repro_torch.models import build_model
from repro_torch.optim.optimizer import OptConfig
from repro_torch.sharding import rules
from repro_torch.train.checkpoint import restore_latest, save_checkpoint
from repro_torch.train.grid import run_cases
from repro_torch.train.loop import TrainConfig, train

WORLD = 4
B, S = 4, 32  # the JAX multi-device snippet's batch
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
UPDATE_TOL = dict(rtol=1e-5, atol=1e-5)
STEP_CASES = [("tinyllama-1.1b", (2, 2)), ("tinyllama-1.1b", (1, 4)),
              ("tinyllama-1.1b", (4, 1)), ("smollm-360m", (2, 2))]
MB_COMPRESSION = dict(microbatches=2, grad_compression=True)
CKPT_STEP = 7
TRAIN = dict(arch="tinyllama-1.1b", steps=3, batch=4, seq=16, ckpt_every=2)
TRAIN_PARAM_ATOL = 1e-4
BUFFER_TCFGS = [{}, MB_COMPRESSION]  # microbatches 1 and 2, compression
BUFFER_STEPS = 3  # batches b1, b2, b1


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    clear_engine_cache()
    clear_schedule_cache()
    clear_gather_engine_cache()
    yield


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _repro(name, dtype=None):
    """`repro`'s reduced model, numpy parameters and a B x S batch."""
    jcfg = J_ARCHS[name].reduced()
    if dtype is not None:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
    jmodel = j_build_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    jbatch = j_make_input_batch(jcfg, B, S, key=jax.random.PRNGKey(1))
    return jcfg, jmodel, _np(jparams), {k: np.asarray(v)
                                        for k, v in jbatch.items()}


def _ckpt_state():
    """A bf16 state with moments that are not zeros: parameters from
    `repro`, moments drawn from a seed."""
    _, _, params, _ = _repro("tinyllama-1.1b", "bfloat16")
    rng = np.random.default_rng(3)
    mu = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), params)
    nu = jax.tree.map(lambda a: np.abs(rng.standard_normal(a.shape)).astype(
        np.float32), params)
    return params, (mu, nu, np.int32(CKPT_STEP + 1))


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """Every case of the module on one grid of four gloo ranks: the
    results by rank, and the directories the grid wrote."""
    dirs = SimpleNamespace(ckpt=tmp_path_factory.mktemp("ckpt-2x2"),
                           train=tmp_path_factory.mktemp("train-2x2"))
    cases = []
    for name, mesh in STEP_CASES:
        _, _, params, batch = _repro(name)
        cases.append(dict(kind="update", arch=name, mesh=mesh,
                          device="cpu", params=params, batch=batch))
    _, _, params, batch = _repro("tinyllama-1.1b")
    cases.append(dict(kind="update", arch="tinyllama-1.1b", mesh=(2, 2),
                      device="cpu", params=params, batch=batch,
                      tcfg=MB_COMPRESSION, grads=False))
    rng = np.random.default_rng(5)
    cases.append(dict(kind="embed", mesh=(2, 2), device="cpu",
                      table=rng.standard_normal((256, 64)).astype(np.float32),
                      ids=rng.integers(0, 256, (B, S)).astype(np.int32)))
    params, opt = _ckpt_state()
    cases.append(dict(kind="checkpoint", arch="tinyllama-1.1b",
                      dtype="bfloat16", mesh=(2, 2), restore_mesh=(4, 1),
                      device="cpu", params=params, opt=opt, step=CKPT_STEP,
                      save_dir=str(dirs.ckpt)))
    cases.append(dict(kind="train", mesh=(2, 2), device="cpu",
                      ckpt_dir=str(dirs.train), **TRAIN))
    _, _, params, batch = _repro("tinyllama-1.1b")
    other = {k: np.ascontiguousarray(v[:, ::-1]) for k, v in batch.items()}
    for tcfg in BUFFER_TCFGS:
        cases.append(dict(kind="buffers", arch="tinyllama-1.1b", mesh=(2, 2),
                          device="cpu", params=params, tcfg=tcfg,
                          batches=[batch, other], steps=BUFFER_STEPS))
    by_rank = run_grid(run_cases, WORLD, (cases,), timeout=900)
    return SimpleNamespace(cases=cases, by_rank=by_rank, dirs=dirs)


def _result(grid, **match):
    """(case, results of every rank) of the first case matching `match`."""
    for i, case in enumerate(grid.cases):
        if all(case.get(k) == v for k, v in match.items()):
            return case, [r[i] for r in grid.by_rank]
    raise KeyError(match)


def _assert_grads_close(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(
            g, w, rtol=0, atol=GRAD_RTOL * np.abs(w).max() + GRAD_ATOL)


def _assert_update_close(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), **UPDATE_TOL)


def _assert_moment_close(got, want, compression):
    """As `test_torch_train.py`: within ``1e-5 + 1e-5 * max|want|``; under
    compression at most 0.1% of a leaf one quantization step apart (an
    element on a rounding tie of the int8 scale)."""
    scale = np.abs(want).max()
    bad = np.abs(got - want) > 1e-5 * np.abs(want) + 1e-5 * scale
    if compression and bad.any():
        assert bad.mean() <= 1e-3, bad.sum()
        np.testing.assert_allclose(got[bad], want[bad], rtol=0,
                                   atol=1.0001 * scale / 127)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


def _same_on_every_rank(results, key):
    first = results[0][key]
    for r in results[1:]:
        assert r[key] == first


@pytest.mark.parametrize("name,mesh", STEP_CASES,
                         ids=[f"{n}-{d}x{m}" for n, (d, m) in STEP_CASES])
def test_step_matches_repro_single_device(grid, name, mesh):
    """`lm_loss`'s value and gradients and one `make_train_step` update on
    the grid against `repro`'s jitted single-device ones."""
    case, results = _result(grid, kind="update", arch=name, mesh=mesh,
                            tcfg=None)
    _, jmodel, jparams, jbatch = _repro(name)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: j_lm_loss(jmodel, p, b, JRuntime())))(jparams, jbatch)
    jp, jo, jm = jax.jit(j_make_train_step(jmodel, JOptConfig(),
                                           JRuntime()))(
        jparams, j_init_opt_state(jparams), jbatch)
    for key in ("loss", "update_loss", "grad_norm"):
        _same_on_every_rank(results, key)
    got = results[0]
    assert abs(got["loss"] - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    assert abs(got["update_loss"] - float(jm["loss"])) <= LOSS_RTOL * abs(
        float(jm["loss"]))
    assert got["grad_norm"] == pytest.approx(float(jm["grad_norm"]),
                                             rel=1e-5)
    _assert_grads_close(got["grads"], _np(jgrads))
    _assert_update_close(got["params"], jp)
    mu, nu, step = got["opt"]
    for mine, theirs in ((mu, jo.mu), (nu, jo.nu)):
        for g, w in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
            _assert_moment_close(g, np.asarray(w), False)
    assert int(step) == int(jo.step) == 1
    assert got["moment_dtensors"] == ["DTensor"]


def test_microbatches_and_compression_match_repro_single_device(grid):
    """`make_update_fn` at microbatches 2 with int8 compression on 2x2: the
    data-reduced gradient is compressed on its leaf's global scale."""
    _, results = _result(grid, kind="update", tcfg=MB_COMPRESSION)
    _, jmodel, jparams, jbatch = _repro("tinyllama-1.1b")
    j_update = jax.jit(j_make_update_fn(jmodel, JOptConfig(), JRuntime(),
                                        JTrainConfig(**MB_COMPRESSION)))
    jp, jo, _, jm = j_update(jparams, j_init_opt_state(jparams),
                             j_init_residual(jparams), jbatch)
    _same_on_every_rank(results, "update_loss")
    got = results[0]
    assert abs(got["update_loss"] - float(jm["loss"])) <= LOSS_RTOL * abs(
        float(jm["loss"]))
    _assert_update_close(got["params"], jp)
    mu, nu, _ = got["opt"]
    for mine, theirs in ((mu, jo.mu), (nu, jo.nu)):
        for g, w in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
            _assert_moment_close(g, np.asarray(w), True)


def _fake_mesh(mesh):
    return SimpleNamespace(axis_names=("data", "model"), shape=mesh)


def _expected_local(shape, spec, mesh, rank):
    """The shape of `rank`'s shard of a `shape` tensor under `spec` on a
    (data, model) mesh of ranks in row-major order."""
    sizes = dict(zip(("data", "model"), mesh))
    coord = dict(zip(("data", "model"), divmod(rank, mesh[1])))
    out = list(shape)
    for dim, entry in enumerate(spec):
        for axis in ((entry,) if isinstance(entry, str) else entry or ()):
            n = out[dim]
            chunk = -(-n // sizes[axis])  # torch.chunk's piece size
            out[dim] = max(0, min(chunk, n - chunk * coord[axis]))
    return tuple(out)


def _check_shards(cfg, mesh, results):
    params = model_params_from_numpy(cfg, results[0]["params"], "cpu")
    specs = rules.tensor_pspecs(params, rules.param_pspecs(
        params, _fake_mesh(mesh)))
    shapes = {n: tuple(t.shape) for n, t in params.named_parameters()}
    for rank, res in enumerate(results):
        assert res["shard_shapes"] == {
            n: _expected_local(shapes[n], specs[n], mesh, rank)
            for n in shapes}
    return specs


@pytest.mark.parametrize("name,mesh", STEP_CASES,
                         ids=[f"{n}-{d}x{m}" for n, (d, m) in STEP_CASES])
def test_shards_follow_the_specs(grid, name, mesh):
    """Each rank's local shard of every parameter is the global shape
    divided as `param_pspecs` says; the table is vocab-sharded over
    'model' and the attention projections shard their heads."""
    _, results = _result(grid, kind="update", arch=name, mesh=mesh,
                         tcfg=None)
    specs = _check_shards(ARCHS[name].reduced(), mesh, results)
    assert specs["tok.embed"] == ("model", None)
    assert specs["units.pos0.0.attn.wq"] == (None, "model")
    placements = results[0]["placements"]
    if mesh[1] > 1:
        assert placements["tok.embed"] == "(Replicate(), Shard(dim=0))"
    assert placements["final_norm.scale"] == "(Replicate(), Replicate())"


def test_c5_vocab_sharded_embedding_is_bitwise(grid):
    """`repro`'s C5 site: a vocab-sharded table indexed by data-sharded ids.
    On the grid the lookup runs and equals ``table[ids]`` bit for bit, the
    rows sharded over 'data'."""
    case, results = _result(grid, kind="embed")
    want = case["table"][case["ids"]]
    for res in results:
        assert res["out"].dtype == want.dtype
        assert res["out"].tobytes() == want.tobytes()
        assert res["placements"] == "(Shard(dim=0), Replicate())"


def _files(directory):
    return {p.name: p.read_bytes() for p in sorted(directory.iterdir())}


def test_checkpoint_saved_on_2x2_restores_on_4x1_and_one_process(
        grid, tmp_path):
    """Elastic re-shard: a bf16 state saved on 2x2 is `repro`'s unsharded
    files, byte for byte those of a single-device save of the same state;
    it restores bitwise on 4x1 (placed by `remesh_shardings`) and into a
    single-process model."""
    case, results = _result(grid, kind="checkpoint")
    cfg = dataclasses.replace(ARCHS["tinyllama-1.1b"].reduced(),
                              dtype="bfloat16")
    params, opt = case["params"], case["opt"]
    for res in results:  # 4x1, every rank
        assert res["step"] == CKPT_STEP
        for got, want in ((res["params"], params), (res["opt"][0], opt[0]),
                          (res["opt"][1], opt[1])):
            for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
                assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
        assert int(res["opt"][2]) == CKPT_STEP + 1
    _check_shards(cfg, (4, 1), results)

    single = {"params": model_params_from_numpy(cfg, params, "cpu"),
              "opt": opt_state_from_numpy(cfg, opt, "cpu")}
    save_checkpoint(tmp_path, CKPT_STEP, single)
    [saved] = sorted(Path(case["save_dir"]).glob("step_*"))
    assert _files(saved) == _files(tmp_path / saved.name)

    fresh = build_model(cfg).init(torch.Generator().manual_seed(9),
                                  device="cpu")
    step, state = restore_latest(case["save_dir"], {
        "params": fresh, "opt": opt_state_from_numpy(cfg, jax.tree.map(
            np.zeros_like, opt), "cpu")})
    assert step == CKPT_STEP
    restored = dict(state["params"].named_parameters())
    for n, a in single["params"].named_parameters():
        assert torch.equal(a.view(torch.int16),
                           restored[n].view(torch.int16)), n


def test_train_on_a_process_mesh_matches_train(grid):
    """`train(mesh=2x2)`: every rank builds the pipeline's global batch
    and keeps its rows; its losses and final parameters match `train()` on
    one device, and its checkpoints are the single-device run's files."""
    case, results = _result(grid, kind="train")
    cfg = ARCHS[case["arch"]].reduced()
    out = train(build_model(cfg),
                opt_cfg=OptConfig(lr=1e-3, warmup_steps=2,
                                  total_steps=case["steps"]),
                tcfg=TrainConfig(total_steps=case["steps"], log_every=1),
                data_cfg=DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=case["seq"],
                                    global_batch=case["batch"]),
                device="cpu")
    want = [h["loss"] for h in out["history"]]
    for res in results:
        got = [h["loss"] for h in res["history"]]
        assert [h["step"] for h in res["history"]] == list(range(
            case["steps"]))
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)
    # three AdamW steps at lr up to 1e-3: an element whose gradient is at
    # rounding level moves by up to ~lr in either run, so the parameters
    # are held at 1e-4 (a wrong gradient moves its elements by ~1e-3)
    want_params = model_params_to_numpy(cfg, out["params"])
    for g, w in zip(jax.tree.leaves(results[0]["params"]),
                    jax.tree.leaves(want_params)):
        np.testing.assert_allclose(g, w, rtol=0, atol=TRAIN_PARAM_ATOL)
    saved = sorted(p.name for p in Path(case["ckpt_dir"]).glob("step_*"))
    assert saved == ["step_00000000", "step_00000002"]


def _leaves_bits(tree):
    return [np.asarray(x).tobytes() for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("tcfg", BUFFER_TCFGS,
                         ids=["mb1", "mb2-compression"])
def test_buffers_update_on_a_static_dtensor_batch_is_bitwise(grid, tcfg):
    """What `train` captures on an NCCL mesh, eagerly on 2x2: three
    updates of `update_over_buffers` over the first batch's DTensors, the
    batches b1, b2, b1 copied into them by `copy_batch` (each rank its
    rows), equal three `make_update_fn` updates on each batch placed anew,
    bit for bit: every step's loss, grad norm and lr, then every parameter
    and moment. The static batch keeps its rows on 'data'."""
    case, results = _result(grid, kind="buffers", tcfg=tcfg)
    first = results[0]["eager"]["metrics"]
    assert len(first) == BUFFER_STEPS
    assert first[0] != first[1] and first[0][0] == pytest.approx(
        first[2][0], rel=1e-2)  # b1, b2, b1: the batch changed twice
    for res in results:
        assert res["buffers"]["metrics"] == res["eager"]["metrics"] == first
        for part in ("params", "opt"):
            assert _leaves_bits(res["buffers"][part]) == \
                _leaves_bits(res["eager"][part])
        assert int(res["buffers"]["opt"][2]) == BUFFER_STEPS
        assert res["batch_placements"] == {
            "tokens": "(Shard(dim=0), Replicate())"}


def test_the_sharded_update_reads_nothing_on_the_host(grid):
    """`core.capture.HostReads` over one more buffers update on every rank
    of 2x2 (microbatches 1, and 2 with compression) finds no
    ``aten._local_scalar_dense`` and no ``aten.nonzero``: nothing a CUDA
    graph would refuse. It fires on the same update followed by a planted
    ``.item()`` of its loss."""
    for tcfg in BUFFER_TCFGS:
        _, results = _result(grid, kind="buffers", tcfg=tcfg)
        for res in results:
            assert res["host_reads"]["update"] == []
            assert res["host_reads"]["planted"] == \
                ["aten._local_scalar_dense"]
