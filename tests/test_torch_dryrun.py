"""The port's dry-run (`repro_torch.launch.dryrun`) against `repro`'s, on
the CPU (``device="cpu"``; the fake tensors allocate nothing):

  (i)   every arch x applicable shape at full size on 16x16 and 2x16x16:
        the port's per-device argument bytes (its step's inputs as placed
        on a mesh faked without a process group) equal those summed from
        `repro`'s own rules on `jax.eval_shape` shapes (no compile);
  (ii)  `repro`'s reduced tinyllama cells (`tests/test_system.py`'s
        DRYRUN_SNIPPET, a (2, 4) mesh), compiled by `repro` in one
        subprocess: argument and output bytes equal, the differences
        explained;
  (iii) fake equals real: four gloo ranks (`launch.mesh.run_grid`) run
        reduced tinyllama's train step on 2x2 under the same counter, and
        rank 0's collective bytes by kind, op count, FLOPs and argument
        bytes equal the dry-run's on a fake 2x2 world exactly;
  (iv)  on a fake 1x1 world the FLOPs equal the counter's over the real
        unsharded step; on 1x4 a dense arch counts fewer;
  (v)   tinyllama-1.1b train_4k at full size on 16x16 runs ok with no real
        tensor created;
  (vi)  `main()` writes `repro`'s JSON keys; without a card and without
        ``--device cpu`` it raises; under an existing process group a
        dry-run raises;
  (vii) the sLSTM scan operator's FLOP formulas equal the counter's over
        the plain loop, forward and backward, and its hand-written
        backward gives autograd's gradients.
"""
import ast
import functools
import json
import os
import pathlib
import resource
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from repro.configs import ARCHS as J_ARCHS
from repro.models import Runtime as JRuntime
from repro.models import build_model as j_build_model
from repro.models import input_specs as j_input_specs
from repro.optim.optimizer import init_opt_state as j_init_opt_state
from repro.sharding import rules as jrules
from repro_torch.configs import ARCHS, applicable_shapes, get_arch
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import free_port, run_grid

REPO = pathlib.Path(__file__).resolve().parents[1]
CELLS = [(name, cell.name) for name in sorted(ARCHS)
         for cell in applicable_shapes(ARCHS[name])]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
MINI = {"train_mini": ShapeCell("train_mini", 32, 8, "train"),
        "decode_mini": ShapeCell("decode_mini", 64, 8, "decode")}


# ---------------------------------------------------------------------------
# (i) argument bytes against repro's rules, every cell at full size
# ---------------------------------------------------------------------------


def _spec_bytes(shape_dtype, spec, sizes) -> int:
    """Rank 0's bytes of one leaf under `repro`'s spec (a dim over k
    devices holds ceil(n / k) of it)."""
    n = jnp.dtype(shape_dtype.dtype).itemsize
    spec = tuple(spec) + (None,) * (len(shape_dtype.shape) - len(spec))
    for d, entry in zip(shape_dtype.shape, spec):
        k = 1
        for axis in ((entry,) if isinstance(entry, str) else entry or ()):
            k *= sizes[axis]
        n *= -(-d // k)
    return n


def _tree_bytes(tree, specs, sizes) -> int:
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    return sum(_spec_bytes(x, s, sizes) for x, s in zip(leaves, spec_leaves))


@functools.lru_cache(maxsize=None)
def _repro_params(name):
    return jax.eval_shape(j_build_model(J_ARCHS[name]).init,
                          jax.random.PRNGKey(0))


def _repro_argument_bytes(name, cell, mesh_key, *, zero1=False,
                          fsdp=False) -> int:
    """What `repro`'s dry-run feeds its compiled step, per device: its
    rules (`param_pspecs`, `batch_pspecs`, `cache_pspecs`) on
    `jax.eval_shape` trees, as `repro.launch.dryrun.run_cell` builds them
    (AdamW moments on the parameters' specs, the step counter replicated;
    `_fill_cache_stubs`' enc_out/image_embeds)."""
    shape, names = MESHES[mesh_key]
    mesh = SimpleNamespace(axis_names=names,
                           devices=SimpleNamespace(shape=shape))
    sizes = dict(zip(names, shape))
    cfg = J_ARCHS[name]
    params = _repro_params(name)
    folded = jrules.zero1_pspecs(params, mesh)
    total = _tree_bytes(params, folded if fsdp else
                        jrules.param_pspecs(params, mesh), sizes)
    if cell.kind == "decode":
        model = j_build_model(cfg)
        cache = jax.eval_shape(lambda: model.init_cache(
            cell.global_batch, cell.seq_len, JRuntime()))
        B, dt = cell.global_batch, jnp.dtype(cfg.dtype)
        if cfg.family == "audio":
            cache["enc_out"] = jax.ShapeDtypeStruct(
                (B, cell.seq_len, cfg.d_model), dt)
        if cfg.family == "vlm":
            cache["image_embeds"] = jax.ShapeDtypeStruct(
                (B, cfg.cross_attn.n_image_tokens, cfg.d_model), dt)
        total += _tree_bytes(cache, jrules.cache_pspecs(cfg, cache, mesh),
                             sizes)
        tokens = {"tokens": jax.ShapeDtypeStruct((B, 1), jnp.int32)}
        return total + _tree_bytes(tokens, jrules.batch_pspecs(tokens, mesh),
                                   sizes)
    batch = j_input_specs(cfg, cell.global_batch, cell.seq_len)
    total += _tree_bytes(batch, jrules.batch_pspecs(batch, mesh), sizes)
    if cell.kind == "train":
        opt = jax.eval_shape(j_init_opt_state, params)
        moments = folded if zero1 else jrules.param_pspecs(params, mesh)
        total += 2 * _tree_bytes(opt.mu, moments, sizes) + 4  # + step
    return total


class FakeMesh:
    """A mesh without a process group, as `tests/test_torch_sharding.py`
    fakes one, seen from rank 0: what `sharding.rules.to_shardings` and
    `sharding.dtensor.local_shape` read."""

    def __init__(self, shape, names):
        self.shape, self.mesh_dim_names = shape, names
        self.ndim = len(shape)

    def size(self, i):
        return self.shape[i]

    def get_local_rank(self, i):
        return 0


def _local_meta(t, sharding, dtype=None):
    """The step's tensor as rank 0's shard of it, on ``meta``."""
    from repro_torch.sharding.dtensor import local_shape

    shape = t.shape if sharding is None else local_shape(
        t.shape, sharding.mesh, sharding.placements)
    return torch.empty(shape, dtype=dtype or t.dtype, device="meta")


@pytest.mark.parametrize("mesh_key", sorted(MESHES))
def test_argument_bytes_equal_repros_rules_on_every_cell(mesh_key):
    """(i) All 32 cells on the mesh: the step's inputs as `step_inputs`
    places them, each rank 0's shard (`dtensor.local_shape`, which
    `dtensor.empty` allocates), a decode cell's cache ``index`` the 4-byte
    int32 leaf it is in `repro`."""
    mesh = FakeMesh(*MESHES[mesh_key])
    got, want = {}, {}
    for name, shape in CELLS:
        cell = dr.SHAPES_BY_NAME[shape]
        _, args = dr.step_inputs(ARCHS[name], cell, dr.default_runtime(cell),
                                 mesh=mesh, device="meta", make=_local_meta)
        got[name, shape] = dr.local_bytes(args)
        want[name, shape] = _repro_argument_bytes(name, cell, mesh_key)
    assert got == want


# The leaves whose ZeRO-1 fold `repro` puts on the stacked layer axis while
# the port's per-layer tensor has no free dim the DP axes divide
# (`_fold_exceptions`), by mesh: whisper-large-v3's q/k/v biases, (32,
# 1280) in `repro` with 1280 on 'model', so one (1280,) tensor a layer,
# already model-sharded. On 16x16 the port folds 'data' jointly with 'model'
# onto it (1280 / 256), and its FFN-in biases (5120) on both meshes; on
# 2x16x16, 512 does not divide 1280 and no per-layer placement holds
# `repro`'s bytes (ROADMAP C27).
FOLD_EXCEPTIONS = {"16x16": {}, "2x16x16": {"whisper-large-v3": [
    f"['{stack}']['{block}']['{b}']"
    for stack, blocks in (("dec", ("cross_attn", "self_attn")),
                          ("enc", ("attn",)))
    for block in blocks for b in ("bk", "bq", "bv")]}}


def _names_data(spec) -> bool:
    """Whether a spec shards a dim over 'data' (alone, with 'pod', or
    jointly with 'model')."""
    return any(e is not None and "data" in ((e,) if isinstance(e, str)
                                           else e) for e in spec)


@functools.lru_cache(maxsize=None)
def _fold_exceptions(name, mesh_key) -> list:
    """The keystrs of the leaves of `name`'s parameters whose
    `rules.zero1_pspecs` spec shards a stacked layer axis and whose
    `rules.zero1_tensor_pspecs` spec names no DP axis, once a module."""
    from repro_torch.optim.tree import leaves
    from repro_torch.sharding import rules

    params, mesh = dr._param_shapes(ARCHS[name]), FakeMesh(*MESHES[mesh_key])
    folded = rules.zero1_pspecs(params, mesh)
    per_tensor = rules.zero1_tensor_pspecs(params, mesh)
    return sorted(
        leaf.key for leaf in leaves(params)
        if any(e is not None for e in folded[leaf.key][:len(leaf.lead)])
        and not _names_data(per_tensor[leaf.names[0]]))


def _fold_exception_bytes(name, mesh_key, *, zero1, fsdp) -> int:
    """What rank 0 holds more than `repro` of the `FOLD_EXCEPTIONS` leaves:
    each is model-sharded only, where `repro` also cuts its layer axis
    dp ways (the moments twice in float32 under `zero1`, a train cell's,
    the parameters in their dtype under `fsdp`)."""
    shape, names = MESHES[mesh_key]
    sizes = dict(zip(names, shape))
    dp = sizes["data"] * sizes.get("pod", 1)
    params = _repro_params(name)
    flat = {jax.tree_util.keystr(p): x for p, x in
            jax.tree_util.tree_leaves_with_path(params)}
    extra = 0
    for key in FOLD_EXCEPTIONS[mesh_key].get(name, []):
        x = flat[key]
        per_layer = x.size // x.shape[0] // sizes["model"]
        held = x.shape[0] * per_layer  # every layer, model-sharded
        want = x.shape[0] // dp * per_layer
        extra += (held - want) * (2 * 4 * zero1 + x.dtype.itemsize * fsdp)
    return extra


@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
@pytest.mark.parametrize("mesh_key", sorted(MESHES))
def test_zero1_and_fsdp_argument_bytes_equal_repros_rules(mesh_key, mode):
    """(i) on every cell with ``zero1=True`` (a train cell's moments) or
    ``fsdp=True`` (the parameters too, a train cell's moments on the
    parameters' rules): where `repro` folds the DP axes onto a stacked
    layer axis (smollm-360m, llama3-8b, whisper-large-v3) the port folds
    them onto each layer's tensor (`rules.zero1_tensor_pspecs`; jointly
    with 'model' on a bias already model-sharded), the same bytes a device,
    but for the named `FOLD_EXCEPTIONS` of 2x16x16, which hold their stated
    difference more."""
    mesh = FakeMesh(*MESHES[mesh_key])
    got, want = {}, {}
    for name, shape in CELLS:
        cell = dr.SHAPES_BY_NAME[shape]
        train = cell.kind == "train"
        flags = {"zero1": mode == "zero1", "fsdp": mode == "fsdp"}
        assert _fold_exceptions(name, mesh_key) == \
            sorted(FOLD_EXCEPTIONS[mesh_key].get(name, []))
        _, args = dr.step_inputs(ARCHS[name], cell, dr.default_runtime(cell),
                                 mesh=mesh, device="meta", make=_local_meta,
                                 **flags)
        got[name, shape] = dr.local_bytes(args)
        want[name, shape] = _repro_argument_bytes(
            name, cell, mesh_key, **flags) + _fold_exception_bytes(
            name, mesh_key, zero1=flags["zero1"] and train,
            fsdp=flags["fsdp"])
    assert len(got) == 32
    assert got == want


# ---------------------------------------------------------------------------
# (ii) the reduced cells against repro's compiled ones
# ---------------------------------------------------------------------------

REPRO_SNIPPET = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, jax
    from repro.configs import ARCHS
    from repro.configs.base import ShapeCell
    from repro.models import build_model, input_specs
    from repro.optim.optimizer import OptConfig, init_opt_state
    from repro.train.steps import make_serve_step, make_train_step
    import repro.launch.dryrun as dr
    import repro.launch.mesh as mesh_mod

    dr.make_production_mesh = mesh_mod.make_production_mesh = (
        lambda multi_pod=False: jax.make_mesh((2, 4), ("data", "model"))
    )
    cfg = ARCHS["tinyllama-1.1b"].reduced()
    model = build_model(cfg)
    out = {}
    for cell in (ShapeCell("train_mini", 32, 8, "train"),
                 ShapeCell("decode_mini", 64, 8, "decode")):
        res = dr.run_cell(cfg, cell, save=False)
        rt = dr.Runtime(remat="dots" if cell.kind == "train" else "none")
        params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        if cell.kind == "train":
            outs = jax.eval_shape(
                make_train_step(model, OptConfig(), rt), params,
                jax.eval_shape(init_opt_state, params),
                input_specs(cfg, cell.global_batch, cell.seq_len))
        else:
            cache = jax.eval_shape(lambda: model.init_cache(
                cell.global_batch, cell.seq_len, rt))
            outs = jax.eval_shape(
                make_serve_step(model, rt), params,
                jax.ShapeDtypeStruct((cell.global_batch, 1), "int32"), cache)
        out[cell.name] = {"ok": res.ok, "err": res.error,
                          "memory": res.memory,
                          "out_leaves": len(jax.tree.leaves(outs))}
    print(json.dumps(out))
    """
)


@pytest.fixture(scope="module")
def repro_mini():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", REPRO_SNIPPET],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("shape", sorted(MINI))
def test_reduced_cells_match_repros_compiled_bytes(repro_mini, shape):
    """(ii) Arguments equal, a decode cell's int32 cache ``index`` among
    them. Outputs: XLA's ``output_size_in_bytes`` also counts the output
    tuple's own buffer, 8 bytes a leaf (a lone array is no tuple); the
    port's count is the outputs' tensors alone (ROADMAP C)."""
    want = repro_mini[shape]
    assert want["ok"], want["err"]
    cell = MINI[shape]
    res = dr.run_cell(get_arch("tinyllama-1.1b").reduced(), cell,
                      save=False, device="cpu", mesh_shape=(2, 4))
    assert res.ok, res.error
    tuple_table = 8 * want["out_leaves"]
    assert res.memory["argument_size_in_bytes"] == \
        want["memory"]["argument_size_in_bytes"]
    assert res.memory["output_size_in_bytes"] + tuple_table == \
        want["memory"]["output_size_in_bytes"]


# ---------------------------------------------------------------------------
# (iii) fake equals real on a 2x2 gloo grid; (iv) FLOPs on 1x1 and 1x4
# ---------------------------------------------------------------------------

GRID_CASE = {"arch": "tinyllama-1.1b", "reduced": True,
             "cell": ("train_mini", 32, 8, "train"), "mesh": (2, 2)}


def test_fake_world_counts_equal_a_real_gloo_grid():
    """(iii)"""
    real = run_grid(dr.grid_counts, 4, (GRID_CASE,))[0]
    fake = dr.run_cell(get_arch("tinyllama-1.1b").reduced(),
                       ShapeCell(*GRID_CASE["cell"]), save=False,
                       device="cpu", mesh_shape=(2, 2))
    assert fake.ok, fake.error
    assert fake.collectives == real["collectives"]
    assert fake.collectives["op_count"] > 0
    assert set(fake.collectives) - {"total_bytes", "op_count"} <= \
        set(dr.COLLECTIVE_KINDS)
    assert fake.cost["flops"] == real["cost"]["flops"] > 0
    assert fake.memory["argument_size_in_bytes"] == \
        real["memory"]["argument_size_in_bytes"]


@pytest.mark.parametrize("shape", ["train_mini", "decode_mini"])
def test_flops_on_1x1_equal_the_real_step_and_fall_on_1x4(shape):
    """(iv)"""
    cfg, cell = get_arch("tinyllama-1.1b").reduced(), MINI[shape]
    one = dr.run_cell(cfg, cell, save=False, device="cpu", mesh_shape=(1, 1))
    step, args = dr.step_inputs(cfg, cell, dr.default_runtime(cell),
                                device="cpu")
    real = dr.count_step(step, args, dr.StepCounter())
    four = dr.run_cell(cfg, cell, save=False, device="cpu", mesh_shape=(1, 4))
    assert one.ok and four.ok, (one.error, four.error)
    assert one.cost["flops"] == real["cost"]["flops"] > 0
    assert one.memory["argument_size_in_bytes"] == \
        real["memory"]["argument_size_in_bytes"]
    assert four.cost["flops"] < one.cost["flops"]


# ---------------------------------------------------------------------------
# (v) a full-size cell; a real tensor in the step
# ---------------------------------------------------------------------------


def test_full_size_cell_runs_with_nothing_real():
    """(v) tinyllama-1.1b train_4k on 16x16: every input and output a fake
    tensor, the counter (which raises on a real tensor reaching an op of
    the step) through, and the process's peak memory grown by well under
    one device's share of the cell (its arguments alone are 0.69 GB a
    device, its temporaries ~200 GB)."""
    cfg, cell = get_arch("tinyllama-1.1b"), dr.SHAPES_BY_NAME["train_4k"]
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    outs = []
    count_step = dr.count_step

    def keep_outputs(step, args, counter):
        def run(*a):
            out = step(*a)
            outs.append((a, out))
            return out
        return count_step(run, args, counter)

    dr.count_step = keep_outputs
    try:
        res = dr.run_cell(cfg, cell, save=False, device="cpu")
    finally:
        dr.count_step = count_step
    grown = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before) \
        * 1024
    assert res.ok, res.error
    assert res.mesh == "16x16"
    assert res.memory["argument_size_in_bytes"] > 6e8
    assert res.memory["temp_size_in_bytes"] > 1e10
    # at least 6 N T / devices: the step's matmuls, each device a 256th
    n_params = sum(t.numel() for t in dr._param_shapes(cfg).parameters())
    assert res.cost["flops"] > 6 * n_params * 256 * 4096 / 256
    assert res.collectives["total_bytes"] > 0
    (args, out), = outs
    tensors = dr.tensors_of(args) + dr.tensors_of(out)
    assert tensors and all(isinstance(dr._local(t), FakeTensor)
                           for t in tensors)
    assert grown < 2e9


def test_zero1_without_a_per_layer_form_reports_the_cell_failed(
        monkeypatch):
    """``zero1`` folds 'data' onto reduced smollm's stacked layer axis (2
    layers on 2). The port holds one tensor a layer and folds 'data' onto
    each layer's tensor instead (`rules.zero1_tensor_pspecs`), so the cell
    runs; a spec on a stacked axis taken as it is has no per-layer form,
    `rules.tensor_pspecs` raises on it, and a cell laid out so reports
    ``ok=False`` with that error, as `repro` reports a failing cell."""
    from repro_torch.sharding import rules

    cfg, cell = get_arch("smollm-360m").reduced(), MINI["train_mini"]
    assert cfg.n_layers % 2 == 0
    res = dr.run_cell(cfg, cell, save=False, device="cpu",
                      mesh_shape=(2, 2), zero1=True)
    assert res.ok, res.error
    assert res.runtime["zero1"] is True
    params = dr._param_shapes(cfg)
    with pytest.raises(ValueError, match="shards a stacked layer axis"):
        rules.tensor_pspecs(params, rules.zero1_pspecs(
            params, FakeMesh((2, 2), ("data", "model"))))
    monkeypatch.setattr(rules, "zero1_tensor_pspecs", lambda p, mesh, **kw: (
        rules.tensor_pspecs(p, rules.zero1_pspecs(p, mesh, **kw))))
    failed = dr.run_cell(cfg, cell, save=False, device="cpu",
                         mesh_shape=(2, 2), zero1=True)
    assert not failed.ok
    assert "shards a stacked layer axis" in failed.error


def test_a_real_tensor_in_the_step_raises():
    cfg, cell = get_arch("tinyllama-1.1b").reduced(), MINI["decode_mini"]
    real = torch.ones(())
    with dr.fake_world(4):
        mesh = dr.mesh_of((2, 2), "cpu")
        fake = FakeTensorMode()
        step, args = dr.step_inputs(cfg, cell, dr.default_runtime(cell),
                                    mesh=mesh, device="cpu", fake_mode=fake)
        tokens = args[1]
        with pytest.raises(RuntimeError, match="real tensor"):
            dr.count_step(lambda t: t.to_local() * real, (tokens,),
                          dr.StepCounter(fake))


# ---------------------------------------------------------------------------
# (vi) main, the card, an existing process group
# ---------------------------------------------------------------------------


def _repro_cellresult_fields():
    tree = ast.parse((REPO / "src/repro/launch/dryrun.py").read_text())
    cls = next(n for n in tree.body if isinstance(n, ast.ClassDef)
               and n.name == "CellResult")
    return [n.target.id for n in cls.body if isinstance(n, ast.AnnAssign)]


def test_main_writes_repros_json(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dr, "ARTIFACTS", tmp_path)
    with pytest.raises(SystemExit) as ex:
        dr.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                 "--device", "cpu", "--tag", "t"])
    assert ex.value.code == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[OK ] smollm-360m") and "16x16" in line
    path = tmp_path / "smollm-360m__decode_32k__16x16__t.json"
    res = json.loads(path.read_text())
    assert list(res) == _repro_cellresult_fields()
    assert res["ok"] and res["mesh"] == "16x16"
    assert set(res["memory"]) == {"argument_size_in_bytes",
                                  "output_size_in_bytes",
                                  "temp_size_in_bytes"}
    assert set(res["cost"]) == {"flops", "bytes accessed"}
    assert {"total_bytes", "op_count"} <= set(res["collectives"])
    assert set(res["runtime"]) == {
        "remat", "scan_layers", "embed_backend", "tag", "zero1", "fsdp",
        "expert_2d", "moe_dp_shards", "moe_ep_constraint",
        "seq_shard_attention"}


def test_main_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dr.main(["--arch", "smollm-360m", "--shape", "decode_32k"])


def test_a_dryrun_under_an_existing_group_raises():
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already holds one"):
            dr.run_cell(get_arch("smollm-360m").reduced(),
                        MINI["decode_mini"], save=False, device="cpu",
                        mesh_shape=(1, 1))
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# The sLSTM scan's FLOP formulas and its backward
# ---------------------------------------------------------------------------


def _slstm_inputs(state):
    """A reduced xlstm cell's sLSTM scan inputs (batch 2, 8 steps), drawn
    from a seed: from the zero state (m = -inf) or from a drawn one."""
    from repro_torch.models.xlstm import slstm_init_state

    cfg = get_arch("xlstm-1.3b").reduced()
    B, S, H = 2, 8, cfg.n_heads
    P = cfg.d_model // H
    rng = np.random.default_rng(7)

    def draw(*shape, scale=1.0):
        return torch.tensor(scale * rng.standard_normal(shape),
                            dtype=torch.float32)

    wx, r, b = draw(B, S, 4, H, P), draw(4, H, P, P, scale=0.3), draw(4, H, P)
    if state == "zero":
        st = slstm_init_state(B, cfg.d_model, H)
        h, c, n, m = st["h"], st["c"], st["n"], st["m"]
    else:
        h, c, m = draw(B, H, P), draw(B, H, P), draw(B, H, P)
        n = draw(B, H, P).abs() + 0.5
    return [t.requires_grad_() for t in (wx, r, b, h, c, n, m)]


def _counted_scan(fn, ins):
    """``fn(*ins)`` and its backward (output gradients drawn from a seed),
    each under its own `StepCounter`: (fwd FLOPs, bwd FLOPs, gradients)."""
    fwd = dr.StepCounter()
    with fwd:
        outs = fn(*ins)
    rng = np.random.default_rng(11)
    gs = [torch.tensor(rng.standard_normal(o.shape), dtype=o.dtype)
          for o in outs]
    bwd = dr.StepCounter()
    with bwd:
        grads = torch.autograd.grad(outs, ins, gs, materialize_grads=True)
    return fwd.flops, bwd.flops, grads


@pytest.mark.parametrize("state", ["zero", "drawn"])
def test_slstm_scan_formulas_and_backward_match_the_plain_loop(state):
    """``repro_torch::slstm_scan`` against `_slstm_steps` run op by op under
    autograd, on a reduced xlstm cell: the forward formula counts the
    loop's recurrent products, the backward formula the loop's recompute
    plus autograd's backward of it (the two gradient products a step), and
    the hand-written backward gives autograd's gradients."""
    from repro_torch.models import xlstm as X

    plain_f, plain_b, want = _counted_scan(X._slstm_steps,
                                           _slstm_inputs(state))
    op_f, op_b, got = _counted_scan(X._slstm_scan_op(), _slstm_inputs(state))
    assert plain_f > 0 and plain_b == 2 * plain_f
    assert op_f == plain_f
    assert op_b == plain_f + plain_b
    for name, a, g in zip("wx r b h c n m".split(), want, got):
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(a.abs().max()) + 1e-30,
                                   err_msg=name)
