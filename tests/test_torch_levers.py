"""The two `Runtime` layout levers (``seq_shard_attention``,
``moe_ep_constraint``), the per-layer ZeRO-1 fold and a batch smaller than
the data axis, in the port against `repro`:

  (a) on one device each lever changes no bit of reduced smollm-360m's,
      deepseek-v2-lite-16b's (MLA + MoE) and llama4's logits, on `repro`'s
      parameters carried by `core.interop`;
  (b) on a 2x2 grid of four gloo ranks (`launch.mesh.run_grid`,
      `train.grid.LEVER_CASES`) reduced smollm with the sequence sharded,
      reduced deepseek with its data-local dispatch pinned to ('data',
      'model') and unpinned, and reduced smollm with ZeRO-1 moments each
      give `repro`'s jitted single-device step with the same `Runtime`
      (`train.grid.update_errors`);
  (c) on fake 2x4 worlds a lever changes the counts it aims at (the
      scores' temporaries, the dispatch's collectives), the argument bytes
      equal those of `repro`'s compiled cells under the same `Runtime`,
      the cell's JSON records both levers, and a lever that cannot be
      applied fails the cell;
  (e) a reduced train cell whose batch is smaller than the data axis runs,
      its argument bytes those of `repro`'s rules.
"""
import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys
import textwrap
import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import build_model as j_build_model
from repro.models import input_specs as j_input_specs
from repro.models import lm_loss as j_lm_loss
from repro.models import make_input_batch as j_make_input_batch
from repro.models.transformer import Runtime as JRuntime
from repro.optim.optimizer import OptConfig as JOptConfig
from repro.optim.optimizer import init_opt_state as j_init_opt_state
from repro.sharding import rules as jrules
from repro.train.steps import make_train_step as j_make_train_step
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeCell
from repro_torch.core.engine import clear_engine_cache, clear_schedule_cache
from repro_torch.core.gather_engine import clear_gather_engine_cache
from repro_torch.core.interop import model_params_from_numpy
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import run_grid
from repro_torch.models import Runtime, build_model
from repro_torch.optim.tree import named_tensors
from repro_torch.sharding.rules import zero1_tensor_pspecs
from repro_torch.train.grid import FAMILY_BATCH, LEVER_CASES, \
    lever_cases, nll_cases, nll_errors, nll_reference, run_cases, \
    update_errors

REPO = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
SMOLLM, DEEPSEEK, LLAMA4 = ("smollm-360m", "deepseek-v2-lite-16b",
                            "llama4-maverick-400b-a17b")
# A reduced train cell where the attention's S x S scores dominate the
# temporaries (smollm) and one where the MoE dispatch runs data-local
# (deepseek): (seq_len, global_batch) on a (data 2, model 4) world.
SP_CELL = ShapeCell("train_long", 256, 8, "train")
EP_CELL = ShapeCell("train_mini", 32, 8, "train")
SP = dict(remat="dots", seq_shard_attention=True)
EP = dict(remat="dots", moe_dp_shards=2, moe_ep_constraint=True)


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    clear_engine_cache()
    clear_schedule_cache()
    clear_gather_engine_cache()
    yield


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _repro(name):
    """`repro`'s reduced model, numpy parameters and a batch of
    `train.grid.FAMILY_BATCH`."""
    jcfg = J_ARCHS[name].reduced()
    jmodel = j_build_model(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    batch = j_make_input_batch(jcfg, *FAMILY_BATCH,
                               key=jax.random.PRNGKey(1))
    return jmodel, _np(params), {k: np.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# (a) one device: no bit changes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,lever", [
    (SMOLLM, "seq_shard_attention"), (DEEPSEEK, "seq_shard_attention"),
    (DEEPSEEK, "moe_ep_constraint"), (LLAMA4, "seq_shard_attention"),
    (LLAMA4, "moe_ep_constraint")])
def test_a_lever_changes_no_bit_on_one_device(name, lever):
    """The MoE runs take the data-local dispatch the pin applies to
    (``moe_dp_shards=2``), lever off and on."""
    _, params, batch = _repro(name)
    cfg = get_arch(name).reduced()
    model = build_model(cfg)
    p = model_params_from_numpy(cfg, params, "cpu")
    b = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    base = dict(moe_dp_shards=2) if lever == "moe_ep_constraint" else {}
    with torch.no_grad():
        off, aux_off = model.forward(p, b, Runtime(**base))
        on, aux_on = model.forward(p, b, Runtime(**base, **{lever: True}))
    assert torch.isfinite(off).all()
    assert torch.equal(on, off)
    assert torch.equal(aux_on, aux_off)


# ---------------------------------------------------------------------------
# (b) the 2x2 gloo grid against repro's single-device step; (c)'s repro
# compiles in a subprocess and the fake cells of (c) and (e) are counted
# in a spawned process meanwhile
# ---------------------------------------------------------------------------

REPRO_LEVER_SNIPPET = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, jax
    from repro.configs import ARCHS
    from repro.configs.base import ShapeCell
    from repro.models.transformer import Runtime
    import repro.launch.dryrun as dr
    import repro.launch.mesh as mesh_mod

    dr.make_production_mesh = mesh_mod.make_production_mesh = (
        lambda multi_pod=False: jax.make_mesh((2, 4), ("data", "model"))
    )
    out = {}
    for name, cell, rt in %s:
        res = dr.run_cell(ARCHS[name].reduced(), ShapeCell(*cell),
                          rt=Runtime(**rt), save=False)
        out[name] = {"ok": res.ok, "err": res.error, "memory": res.memory}
    print(json.dumps(out))
    """
)


def _repro_reference(name, runtime):
    """`repro`'s jitted loss, gradients and one `make_train_step` under
    ``Runtime(**runtime)``, in `update_errors`' keys."""
    jmodel, params, batch = _repro(name)
    rt = JRuntime(**runtime)
    step = j_make_train_step(jmodel, JOptConfig(), rt)

    def both(p, o, b):
        return jax.value_and_grad(
            lambda q: j_lm_loss(jmodel, q, b, rt))(p), step(p, o, b)

    (loss, grads), (jp, jo, jm) = jax.jit(both)(
        params, j_init_opt_state(params), batch)
    return {"loss": float(loss), "grads": _np(grads),
            "update_loss": float(jm["loss"]),
            "grad_norm": float(jm["grad_norm"]), "params": _np(jp),
            "opt": (_np(jo.mu), _np(jo.nu), np.asarray(jo.step))}


@pytest.fixture(scope="module")
def grid():
    """(cases, results by rank, `repro`'s references, `repro`'s compiled
    lever cells): the ranks, `repro`'s compiles and the fake cells
    (`FAKE_CELLS`, into `COUNTED`) run together."""
    cells = [(name, dataclasses.astuple(cell), rt) for name, cell, rt in
             ((SMOLLM, SP_CELL, SP), (DEEPSEEK, EP_CELL, EP))]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    compiled = subprocess.Popen(
        [sys.executable, "-c", REPRO_LEVER_SNIPPET % (cells,)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        names = sorted({name for name, _ in LEVER_CASES})
        cases = lever_cases({n: _repro(n)[1:] for n in names}) + [NLL_CASE]
        with ThreadPoolExecutor(1) as pool, ProcessPoolExecutor(
                1, mp_context=multiprocessing.get_context("spawn")) as cells:
            ranks = pool.submit(run_grid, run_cases, WORLD, (cases,),
                                timeout=600)
            fake = [cells.submit(dr.run_cell, get_arch(name).reduced(), cell,
                                 rt=Runtime(**dict(rt)), save=False,
                                 device="cpu", mesh_shape=mesh_shape)
                    for name, cell, rt, mesh_shape in FAKE_CELLS]
            refs = [_repro_reference(c["arch"], c.get("runtime", {}))
                    for c in cases if c["kind"] == "update"]
            by_rank = ranks.result()
            COUNTED.update(zip(FAKE_CELLS, (f.result() for f in fake)))
        out, err = compiled.communicate(timeout=600)
    finally:
        compiled.kill()
    assert compiled.returncode == 0, err[-3000:]
    return cases, by_rank, refs, json.loads(out.strip().splitlines()[-1])


NLL_CASE = nll_cases()[0]


@pytest.mark.parametrize("i", range(len(LEVER_CASES)),
                         ids=["sp", "ep", "moe_dp", "zero1"])
def test_levers_on_2x2_match_repro_single_device(grid, i):
    cases, by_rank, refs, _ = grid
    results = [r[i] for r in by_rank]
    for key in ("loss", "update_loss", "grad_norm"):
        assert {r[key] for r in results} == {results[0][key]}, key
    errs = update_errors(results[0], refs[i])
    assert max(errs.values()) <= 1, errs


def test_zero1_moments_are_folded_per_layer_on_the_grid(grid):
    """Reduced smollm's 2 layers on a data axis of 2: `repro` folds 'data'
    onto the stacked layer axis; the port's moments hold each layer's
    tensor cut over 'data' on its first free dim, rank 0 half the bytes of
    `repro`'s unfolded moments where a dim takes it."""
    cases, by_rank, _, _ = grid
    i = next(j for j, c in enumerate(cases) if c.get("zero1"))
    shapes = by_rank[0][i]["moment_shard_shapes"]
    params = dr._param_shapes(get_arch(SMOLLM).reduced())
    mesh = SimpleNamespace(axis_names=("data", "model"), shape=(2, 2))
    specs = zero1_tensor_pspecs(params, mesh)
    sizes = {"data": 2, "model": 2}
    folded = 0
    for name, t in named_tensors(params).items():
        ways = 1
        for entry in specs[name]:
            for axis in ((entry,) if isinstance(entry, str) else entry or ()):
                ways *= sizes[axis]
        assert int(np.prod(shapes[name])) * ways == t.numel(), name
        folded += "data" in str(specs[name])
    assert folded >= 9  # every layer tensor of the 2 layers, and more


# ---------------------------------------------------------------------------
# (c) fake 2x4 worlds
# ---------------------------------------------------------------------------


def _key(**rt):
    return tuple(sorted(rt.items()))


COUNTED = {}  # (arch, cell, runtime items, mesh shape): `CellResult`


def _cell(name, cell, mesh_shape=(2, 4), **rt):
    """A reduced cell on a fake world, once a module."""
    key = (name, cell, _key(**rt), mesh_shape)
    if key not in COUNTED:
        COUNTED[key] = dr.run_cell(
            get_arch(name).reduced(), cell, rt=Runtime(**rt), save=False,
            device="cpu", mesh_shape=mesh_shape)
    res = COUNTED[key]
    assert res.ok, res.error
    return res


# (e)'s cell: reduced tinyllama, batch 2 on a data axis of 4
SMALL_BATCH = ("tinyllama-1.1b", ShapeCell("train_small", 16, 2, "train"))
# `COUNTED`'s keys of the cells of (c) and (e)
FAKE_CELLS = (
    (SMOLLM, SP_CELL, _key(remat="dots"), (2, 4)),
    (SMOLLM, SP_CELL, _key(**SP), (2, 4)),
    (DEEPSEEK, EP_CELL, _key(remat="dots", moe_dp_shards=2), (2, 4)),
    (DEEPSEEK, EP_CELL, _key(**EP), (2, 4)),
    SMALL_BATCH + (_key(), (4, 2)))


def test_sequence_sharding_cuts_the_scores_temporaries():
    off = _cell(SMOLLM, SP_CELL, remat="dots")
    on = _cell(SMOLLM, SP_CELL, **SP)
    assert on.memory["temp_size_in_bytes"] < \
        0.75 * off.memory["temp_size_in_bytes"]
    assert on.cost["flops"] < off.cost["flops"]
    assert on.collectives != off.collectives
    assert on.runtime["seq_shard_attention"] is True
    assert off.runtime["seq_shard_attention"] is False


def test_the_ep_pin_changes_the_dispatch_collectives():
    off = _cell(DEEPSEEK, EP_CELL, remat="dots", moe_dp_shards=2)
    on = _cell(DEEPSEEK, EP_CELL, **EP)
    strip = ("op_count",)
    assert {k: v for k, v in on.collectives.items() if k not in strip} != \
        {k: v for k, v in off.collectives.items() if k not in strip}
    assert on.runtime["moe_ep_constraint"] is True
    assert off.runtime["moe_ep_constraint"] is False
    assert on.runtime["moe_dp_shards"] == 2


def test_lever_cells_argument_bytes_equal_repros_compiled(grid):
    """`repro` compiles the same reduced cells on its (2, 4) mesh under the
    same `Runtime`: the levers move activations, not arguments."""
    want = grid[3]
    for name, cell, rt in ((SMOLLM, SP_CELL, SP), (DEEPSEEK, EP_CELL, EP)):
        assert want[name]["ok"], want[name]["err"]
        got = _cell(name, cell, **rt)
        assert got.memory["argument_size_in_bytes"] == \
            want[name]["memory"]["argument_size_in_bytes"]


def test_a_lever_that_cannot_be_applied_fails_the_cell():
    """The EP pin with no data-local dispatch to pin: on a mesh the cell
    reports ``ok=False`` with the lever's error (`repro` would run its
    baseline layout); on one device the pin changes nothing."""
    res = dr.run_cell(get_arch(DEEPSEEK).reduced(), EP_CELL,
                      rt=Runtime(remat="dots", moe_ep_constraint=True),
                      save=False, device="cpu", mesh_shape=(2, 4))
    assert not res.ok
    assert "moe_ep_constraint" in res.error
    assert res.runtime["moe_ep_constraint"] is True


# ---------------------------------------------------------------------------
# (e) a batch smaller than the data axis
# ---------------------------------------------------------------------------


def test_a_batch_smaller_than_the_data_axis_runs():
    """Reduced tinyllama, batch 2 on a data axis of 4: `repro`'s
    `batch_pspecs` replicates the batch; the port's step runs (the flatten
    of 2 x 16 tokens in each matmul, and its gradient, fitted to the split
    back into the batch: `layers.mm`), its argument bytes those of
    `repro`'s rules (parameters, moments on their specs, the replicated
    batch, the 4-byte step)."""
    name, cell = SMALL_BATCH
    res = _cell(name, cell, mesh_shape=(4, 2))
    jcfg = J_ARCHS[name].reduced()
    mesh = SimpleNamespace(axis_names=("data", "model"),
                           devices=SimpleNamespace(shape=(4, 2)))
    sizes = {"data": 4, "model": 2}
    params = jax.eval_shape(j_build_model(jcfg).init, jax.random.PRNGKey(0))
    batch = j_input_specs(jcfg, cell.global_batch, cell.seq_len)
    assert jrules.batch_pspecs(batch, mesh)["tokens"] == \
        jax.sharding.PartitionSpec()

    def nbytes(tree, specs, itemsize=None):
        total = 0
        leaves = jax.tree.leaves(tree)
        spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
        for x, spec in zip(leaves, spec_leaves):
            n = itemsize or jnp.dtype(x.dtype).itemsize
            spec = tuple(spec) + (None,) * (len(x.shape) - len(spec))
            for d, entry in zip(x.shape, spec):
                ways = 1
                for axis in ((entry,) if isinstance(entry, str)
                             else entry or ()):
                    ways *= sizes[axis]
                n *= -(-d // ways)
            total += n
        return total

    pspecs = jrules.param_pspecs(params, mesh)
    want = nbytes(params, pspecs) + 2 * nbytes(params, pspecs, 4) + 4 + \
        nbytes(batch, jrules.batch_pspecs(batch, mesh))
    assert res.memory["argument_size_in_bytes"] == want


# ---------------------------------------------------------------------------
# The loss of vocab-sharded logits (ROADMAP C28)
# ---------------------------------------------------------------------------


def test_the_loss_keeps_the_logits_vocab_sharded():
    """On a fake 2x4 world, logits (16, 64, 4096) with the batch over
    'data' and the vocabulary over 'model', as a full-size train cell lays
    them out: `sharding.dtensor.vocab_nll` all-reduces (B, S) rows only
    and holds well under one rank's whole-vocab rows, where DTensor's
    ``log_softmax`` and ``gather`` (the loss before) gather the logits
    whole, over 'model' and 'data', to every rank."""
    import torch.nn.functional as F
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.sharding import dtensor
    from repro_torch.sharding.rules import to_shardings

    B, S, V = 16, 64, 4096

    def counted(fn):
        with dr.fake_world(8):
            mesh = dr.mesh_of((2, 4), "cpu")
            fake = FakeTensorMode(allow_non_fake_inputs=False)
            sh = to_shardings({"l": ("data", None, "model"),
                               "t": ("data", None)}, mesh)
            with fake:
                logits = dtensor.empty(torch.empty((B, S, V), device="meta"),
                                       sh["l"], "cpu")
                targets = dtensor.empty(torch.empty(
                    (B, S), dtype=torch.int64, device="meta"), sh["t"], "cpu")
            counter = dr.StepCounter(fake)
            return dr.count_step(fn, (logits, targets), counter)

    def before(logits, targets):
        logp = F.log_softmax(logits, dim=-1)
        return -torch.gather(logp, -1, targets[..., None])[..., 0]

    rows = B // 2 * S * V * 4  # one rank's rows over the whole vocabulary
    now = counted(dtensor.vocab_nll)
    assert set(now["collectives"]) - {"total_bytes", "op_count"} == \
        {"all-reduce"}
    assert now["collectives"]["all-reduce"] == 3 * (B // 2) * S * 4
    # the shifted logits and their exponentials, each a quarter of the rows
    assert now["memory"]["temp_size_in_bytes"] < 3 * rows / 4
    old = counted(before)
    assert old["collectives"].get("all-gather", 0) >= rows
    assert old["memory"]["temp_size_in_bytes"] >= rows


def test_the_vocab_sharded_loss_equals_log_softmax_on_the_grid(grid):
    """`vocab_nll` on the 2x2 gloo grid (the vocab over 'model', the batch
    over 'data') against ``-log_softmax(logits)[targets]`` and its
    gradient on one device (`train.grid.nll_errors`)."""
    cases, by_rank, _, _ = grid
    got = by_rank[0][-1]  # NLL_CASE, after the update cases
    errs = nll_errors(got, nll_reference(NLL_CASE))
    assert max(errs.values()) <= 1, errs
    assert "Shard(dim=0)" in got["placements"]
