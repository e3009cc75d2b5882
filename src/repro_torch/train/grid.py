"""The sharded training step from numpy state, on a process mesh: the rank
side of `launch.mesh.run_grid`, with which a host holds the grid to a
reference on the same inputs (the CPU tests against `repro`'s
single-device step, four gloo ranks on one host).

Every rank receives the same numpy state (`repro`'s parameter layout,
carried by `core.interop`), places it by `sharding.rules` on its mesh, runs
the port's own functions on DTensors and returns numpy: gathered values
(the same on every rank; gathering is a collective, so every rank gathers)
and the shapes of its own shards. `run_cases` runs a list of cases in one
process group, each on its own mesh, so one spawn serves many checks:

  * ``update``: `lm_loss`'s value and gradients, then one `make_train_step`
    (or a `make_update_fn` with microbatches or compression) update, under
    the case's `Runtime` fields (the layout levers) and optionally with
    ZeRO-1 moments;
  * ``embed``: the index embedding of data-sharded ids in a vocab-sharded
    table (`repro`'s C5 site);
  * ``nll``: the next-token loss of vocab-sharded logits and its
    gradient;
  * ``checkpoint``: a save on one mesh, a restore on another;
  * ``train``: `train()` on the mesh from the seed.

An ``update`` case is judged by `update_errors` against a reference on
the same inputs: `repro`'s jitted single-device step in the CPU tests, or
`port_reference` (the port on one device) in ``python -m
repro_torch.train.grid``, which runs every reduced family's update on a
2x2 grid of four gloo ranks (`family_cases`; reduced tinyllama's also on
1x4 and 4x1 and at microbatches 2 with compression; the layout levers and
ZeRO-1, `lever_cases`) and exits 1 on a case
outside its tolerance: the check of the grid under a machine's own torch,
without JAX.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List

import torch

from repro_torch.configs import get_arch
from repro_torch.core.interop import model_params_from_numpy, \
    model_params_to_numpy, opt_state_from_numpy, opt_state_to_numpy
from repro_torch.launch.mesh import make_process_mesh
from repro_torch.models import Runtime, build_model, lm_loss, \
    param_shapes
from repro_torch.optim.compression import init_residual
from repro_torch.optim.optimizer import OptConfig, init_opt_state
from repro_torch.optim.tree import named_tensors
from repro_torch.sharding.dtensor import holds_dtensors, mesh_device
from repro_torch.sharding.rules import batch_pspecs, param_pspecs, \
    param_shardings, tensor_pspecs, to_shardings
from repro_torch.train.checkpoint import restore_latest, save_checkpoint
from repro_torch.train.fault_tolerance import remesh_shardings
from repro_torch.train.loop import TrainConfig, make_update_fn, \
    value_and_grad
from repro_torch.train.steps import make_train_step


def _cfg(case):
    cfg = get_arch(case["arch"]).reduced()
    if case.get("dtype"):
        cfg = dataclasses.replace(cfg, dtype=case["dtype"])
    return cfg


def _local_shapes(module) -> Dict[str, tuple]:
    return {n: tuple(t.to_local().shape)
            for n, t in named_tensors(module).items()}


def _placed(cfg, case, mesh):
    """The case's parameters and batch on `mesh` (the batch's rows by
    `batch_pspecs`)."""
    from repro_torch.data.pipeline import device_put_batch

    device = mesh_device(mesh)
    params = model_params_from_numpy(
        cfg, case["params"], device, param_shardings(param_shapes(cfg),
                                                     mesh))
    batch = device_put_batch(
        case["batch"], device,
        shardings=to_shardings(batch_pspecs(case["batch"], mesh), mesh))
    return params, batch


def _update(case: Dict[str, Any], params, batch) -> Dict[str, Any]:
    """`lm_loss`'s value and gradients, then one update, of `params` on
    `batch` (DTensors on a mesh, or plain tensors on one device): the
    numbers `update_errors` compares. ``tcfg`` (TrainConfig fields) runs
    `make_update_fn`; without it `make_train_step`. ``runtime`` holds
    `Runtime` fields (the layout levers); ``zero1`` places the moments on
    a mesh as ZeRO-1 does (one device: the parameters' layout)."""
    cfg = _cfg(case)
    model = build_model(cfg)
    rt = Runtime(**case.get("runtime", {}))
    out: Dict[str, Any] = {}
    if case.get("grads", True):
        loss, grads = value_and_grad(
            lambda p: lm_loss(model, p, batch, rt), params)
        out["loss"] = float(loss)
        out["grads"] = model_params_to_numpy(cfg, grads)
        del grads
    opt = init_opt_state(params, zero1=bool(case.get("zero1")))
    opt_cfg = OptConfig(**case.get("opt", {}))
    if case.get("tcfg") is None:
        _, opt, metrics = make_train_step(model, opt_cfg, rt)(
            params, opt, batch)
    else:
        tcfg = TrainConfig(**case["tcfg"])
        residual = init_residual(params) if tcfg.grad_compression else None
        _, opt, residual, metrics = make_update_fn(
            model, opt_cfg, rt, tcfg)(params, opt, residual, batch)
    out["update_loss"] = float(metrics["loss"])
    out["grad_norm"] = float(metrics["grad_norm"])
    out["params"] = model_params_to_numpy(cfg, params)
    out["opt"] = opt_state_to_numpy(cfg, opt)
    out["moment_dtensors"] = sorted({type(t).__name__ for t in
                                     named_tensors(opt.mu).values()})
    if holds_dtensors(opt.mu):
        out["moment_shard_shapes"] = _local_shapes(opt.mu)
    return out


def update_case(case: Dict[str, Any]) -> Dict[str, Any]:
    """`_update` on the case's mesh, with each rank's shard shapes and
    placements."""
    cfg = _cfg(case)
    mesh = make_process_mesh(*case["mesh"], device=case.get("device"))
    params, batch = _placed(cfg, case, mesh)
    out = {"shard_shapes": _local_shapes(params),
           "placements": {n: repr(t.placements) for n, t in
                          named_tensors(params).items()}}
    out.update(_update(case, params, batch))
    return out


def port_reference(case: Dict[str, Any]) -> Dict[str, Any]:
    """`_update` of an ``update`` case's inputs by the port on one device
    (the CPU): the reference the grid is held to without JAX."""
    cfg = _cfg(case)
    params = model_params_from_numpy(cfg, case["params"], "cpu")
    batch = {k: torch.from_numpy(v.copy()) for k, v in case["batch"].items()}
    return _update(case, params, batch)


def embed_case(case: Dict[str, Any]) -> Dict[str, Any]:
    """The index embedding of the case's ids, data-sharded, in its table,
    vocab-sharded by the ``embed`` rule."""
    from repro_torch.models.layers import embedding_apply
    from repro_torch.sharding.dtensor import distribute, full

    mesh = make_process_mesh(*case["mesh"], device=case.get("device"))
    table = torch.from_numpy(case["table"])
    ids = torch.from_numpy(case["ids"])
    [tsh] = to_shardings({"embed": ("model", None)}, mesh).values()
    ish = to_shardings(batch_pspecs({"ids": ids}, mesh), mesh)["ids"]
    got = embedding_apply({"embed": distribute(table, tsh)},
                          distribute(ids, ish))
    return {"out": full(got).numpy(), "placements": repr(got.placements)}


def nll_case(case: Dict[str, Any]) -> Dict[str, Any]:
    """`sharding.dtensor.vocab_nll` of the case's logits (B, S, V), laid
    out with the batch over 'data' and the vocabulary over 'model', and the
    gradient of ``sum(nll * weights)`` in them, gathered."""
    from repro_torch.sharding.dtensor import distribute, full, vocab_nll

    mesh = make_process_mesh(*case["mesh"], device=case.get("device"))
    sh = to_shardings({"logits": ("data", None, "model"),
                       "rows": ("data", None)}, mesh)
    logits = distribute(torch.from_numpy(case["logits"]),
                        sh["logits"]).requires_grad_()
    rows = {k: distribute(torch.from_numpy(case[k]), sh["rows"])
            for k in ("targets", "weights")}
    nll = vocab_nll(logits, rows["targets"])
    (grad,) = torch.autograd.grad((nll * rows["weights"]).sum(), logits)
    return {"nll": full(nll).detach().numpy(), "grad": full(grad).numpy(),
            "placements": repr(nll.placements)}


def checkpoint_case(case: Dict[str, Any]) -> Dict[str, Any]:
    """Save the case's state (parameters and moments) from ``mesh`` into
    ``save_dir``; restore it into a fresh state on ``restore_mesh``, placed
    there by `remesh_shardings`; return the restored state gathered and its
    shards' shapes."""
    cfg = _cfg(case)
    mesh = make_process_mesh(*case["mesh"], device=case.get("device"))
    device = mesh_device(mesh)
    sh = param_shardings(param_shapes(cfg), mesh)
    state = {"params": model_params_from_numpy(cfg, case["params"], device,
                                               sh),
             "opt": opt_state_from_numpy(cfg, case["opt"], device, sh)}
    save_checkpoint(case["save_dir"], case["step"], state)
    del state

    new_mesh = make_process_mesh(*case["restore_mesh"],
                                 device=case.get("device"))
    fresh = param_shapes(cfg)  # restored shard by shard: nothing drawn
    fresh = {"params": fresh, "opt": init_opt_state(fresh)._replace(
        step=torch.zeros((), dtype=torch.int32, device=device))}
    specs = tensor_pspecs(fresh["params"],
                          param_pspecs(fresh["params"], new_mesh))
    step, fresh = restore_latest(case["save_dir"], fresh,
                                 shardings=remesh_shardings(specs, new_mesh))
    return {"step": step,
            "params": model_params_to_numpy(cfg, fresh["params"]),
            "opt": opt_state_to_numpy(cfg, fresh["opt"]),
            "shard_shapes": _local_shapes(fresh["params"])}


def train_case(case: Dict[str, Any]) -> Dict[str, Any]:
    """`train()` on the case's mesh from the seed (``steps`` steps of the
    token pipeline at ``batch`` x ``seq``, a checkpoint into ``ckpt_dir``
    every ``ckpt_every``): the history and the final parameters."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.loop import train

    cfg = _cfg(case)
    mesh = make_process_mesh(*case["mesh"], device=case.get("device"))
    out = train(
        build_model(cfg), mesh=mesh,
        opt_cfg=OptConfig(lr=1e-3, warmup_steps=2,
                          total_steps=case["steps"]),
        tcfg=TrainConfig(total_steps=case["steps"], log_every=1,
                         ckpt_dir=case.get("ckpt_dir"),
                         ckpt_every=case.get("ckpt_every", 50)),
        data_cfg=DataConfig(vocab_size=cfg.vocab_size, seq_len=case["seq"],
                            global_batch=case["batch"]),
        device=case.get("device"))
    return {"history": out["history"],
            "params": model_params_to_numpy(cfg, out["params"]),
            "shard_shapes": _local_shapes(out["params"])}


CASES = {"update": update_case, "embed": embed_case, "nll": nll_case,
         "checkpoint": checkpoint_case, "train": train_case}


def run_cases(cases: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Each case (a dict with its ``kind``) in turn on this rank, with its
    seconds: the target of `launch.mesh.run_grid`."""
    out = []
    for case in cases:
        t0 = time.perf_counter()
        res = CASES[case["kind"]](case)
        res["seconds"] = time.perf_counter() - t0
        out.append(res)
    return out



# The tolerances of one update against a reference on the same inputs
# (those `repro`'s single-device step holds the port's to): the losses and
# the gradient norm relative; each gradient within GRAD_RTOL * max|g| +
# GRAD_ATOL; parameters and moments after the update elementwise.
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
UPDATE_RTOL = UPDATE_ATOL = 1e-5
MOMENT_RTOL = 1e-5  # of the element and of the leaf's max, at the
# default betas
FAMILY_MESH, FAMILY_BATCH = (2, 2), (4, 16)


def family_cases(inputs: Dict[str, tuple]) -> List[Dict[str, Any]]:
    """An ``update`` case (loss, gradients, one `make_train_step`) on the
    2x2 mesh for each family of `inputs` ({arch name: (numpy parameters,
    numpy batch)})."""
    return [dict(kind="update", arch=name, mesh=FAMILY_MESH, device="cpu",
                 params=params, batch=batch)
            for name, (params, batch) in inputs.items()]


# The layout levers and ZeRO-1 on the 2x2 grid: reduced smollm's 1 kv head
# on a model axis of 2 (its queries' heads replicated) with the sequence
# sharded over 'model'; reduced deepseek's data-local dispatch pinned to
# ('data', 'model') and unpinned; reduced smollm's moments folded over
# 'data' per layer.
LEVER_CASES = (
    ("smollm-360m", dict(runtime=dict(seq_shard_attention=True))),
    ("deepseek-v2-lite-16b",
     dict(runtime=dict(moe_dp_shards=2, moe_ep_constraint=True))),
    ("deepseek-v2-lite-16b", dict(runtime=dict(moe_dp_shards=2))),
    ("smollm-360m", dict(zero1=True)),
)


def lever_cases(inputs: Dict[str, tuple]) -> List[Dict[str, Any]]:
    """The ``update`` cases of `LEVER_CASES` on the 2x2 mesh, on `inputs`
    ({arch name: (numpy parameters, numpy batch)})."""
    return [dict(kind="update", arch=name, mesh=FAMILY_MESH, device="cpu",
                 params=inputs[name][0], batch=inputs[name][1], **extra)
            for name, extra in LEVER_CASES]


def nll_reference(case: Dict[str, Any]) -> Dict[str, Any]:
    """An ``nll`` case on one device: ``-log_softmax(logits)[targets]`` and
    the gradient of ``sum(nll * weights)``."""
    logits = torch.from_numpy(case["logits"]).requires_grad_()
    logp = torch.log_softmax(logits, -1)
    nll = -torch.gather(logp, -1, torch.from_numpy(case["targets"])[
        ..., None])[..., 0]
    (grad,) = torch.autograd.grad(
        (nll * torch.from_numpy(case["weights"])).sum(), logits)
    return {"nll": nll.detach().numpy(), "grad": grad.numpy()}


def nll_cases() -> List[Dict[str, Any]]:
    """An ``nll`` case on the 2x2 mesh: logits (4, 6, 24), 12 vocabulary
    columns a model rank, targets on both halves, drawn from a seed."""
    import numpy as np

    rng = np.random.default_rng(3)
    return [dict(kind="nll", mesh=FAMILY_MESH, device="cpu",
                 logits=(3 * rng.standard_normal((4, 6, 24))).astype(
                     np.float32),
                 targets=rng.integers(0, 24, (4, 6)),
                 weights=rng.standard_normal((4, 6)).astype(np.float32))]


NLL_RTOL, NLL_ATOL, NLL_GRAD_ATOL = 1e-6, 1e-6, 1e-7


def nll_errors(got: Dict[str, Any], want: Dict[str, Any]) -> Dict[str, float]:
    """An ``nll`` case's loss and gradient against `nll_reference`'s, as
    their worst error over ``NLL_ATOL + NLL_RTOL * |want|``."""
    return {key: _worst(got[key], want[key],
                        lambda w, atol=atol: atol + NLL_RTOL * abs(w))
            for key, atol in (("nll", NLL_ATOL), ("grad", NLL_GRAD_ATOL))}


def _leaves(tree, path="") -> list:
    """(path, float64 array) of every leaf, dicts by sorted key."""
    import numpy as np

    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, f"{path}/{i}")]
    return [(path, np.asarray(tree, np.float64))]


def _worst(got, want, tol, compression=False) -> float:
    """The largest error of `got`'s leaves over ``tol(want leaf)``, inf
    where the trees differ or a value is not finite. Under `compression`
    at most 0.1% of a leaf may sit one int8 quantization step (the leaf's
    max / 127) apart: an element on a rounding tie of the scale."""
    import numpy as np

    got, want = _leaves(got), _leaves(want)
    if [p for p, _ in got] != [p for p, _ in want]:
        return float("inf")
    worst = 0.0
    for (_, g), (_, w) in zip(got, want):
        if g.shape != w.shape or not np.isfinite(g).all():
            return float("inf")
        if not g.size:
            continue
        t = np.maximum(tol(w), np.finfo(np.float64).tiny)
        ratio = np.abs(g - w) / t
        bad = ratio > 1
        if compression and bad.any():
            if bad.mean() > 1e-3:
                return float("inf")
            step = 1.0001 * np.abs(w).max() / 127
            ratio = np.where(bad, np.abs(g - w) / max(step, 1e-300), ratio)
        worst = max(worst, float(ratio.max()))
    return worst


def update_errors(got: Dict[str, Any], want: Dict[str, Any], *,
                  compression: bool = False) -> Dict[str, float]:
    """Each quantity of an ``update`` case's result `got` against `want`,
    the same quantities from a reference on the same inputs (`port_
    reference`, or `repro`'s jitted step in the tests: ``loss`` and
    ``grads`` where `got` has them, ``update_loss``, ``grad_norm``,
    ``params``, ``opt`` as (mu, nu, step)), as its worst error over its
    tolerance: the case passes where every value is at most 1.
    `compression`: the case's ``tcfg`` compresses the gradients."""
    import numpy as np

    def rel(key):
        return abs(got[key] - want[key]) / (LOSS_RTOL * abs(want[key]))

    out = {key: rel(key) for key in ("loss", "update_loss") if key in got}
    out["grad_norm"] = rel("grad_norm")
    if "grads" in got:
        out["grads"] = _worst(got["grads"], want["grads"], lambda w: (
            GRAD_RTOL * np.abs(w).max() + GRAD_ATOL) * np.ones_like(w))
    out["params"] = _worst(got["params"], want["params"],
                           lambda w: UPDATE_ATOL + UPDATE_RTOL * np.abs(w))
    # a moment after one update is (1 - beta) times the clipped gradient
    # (squared): held relative to itself and to its leaf's max, and to what
    # GRAD_ATOL lets through where the gradient is rounding noise (a key
    # bias's: softmax cancels it)
    for i, (name, beta) in enumerate(zip(("mu", "nu"), OptConfig().betas)):
        floor = (1 - beta) * GRAD_ATOL ** (i + 1)
        out[name] = _worst(
            got["opt"][i], want["opt"][i],
            lambda w: MOMENT_RTOL * (np.abs(w) + np.abs(w).max()) + floor,
            compression=compression)
    out["step"] = 0.0 if int(got["opt"][2]) == int(want["opt"][2]) \
        else float("inf")
    return out


def main() -> int:
    """Every reduced family's update on a 2x2 grid of four gloo ranks,
    reduced tinyllama's on 1x4 and 4x1 and at microbatches 2 with
    compression, and `LEVER_CASES`, against `port_reference`, and the
    vocab-sharded loss (`nll_cases`) against `nll_reference`; exit 1 on a
    case outside its tolerance."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.mesh import run_grid
    from repro_torch.models import make_input_batch

    torch.set_num_threads(4)
    inputs = {}
    for name in sorted(ARCHS):
        cfg = ARCHS[name].reduced()
        gen = torch.Generator().manual_seed(0)
        params = build_model(cfg).init(gen, device="cpu")
        batch = make_input_batch(cfg, *FAMILY_BATCH, gen, device="cpu")
        inputs[name] = (model_params_to_numpy(cfg, params),
                        {k: v.numpy() for k, v in batch.items()})
    tiny = dict(kind="update", arch="tinyllama-1.1b", device="cpu",
                params=inputs["tinyllama-1.1b"][0],
                batch=inputs["tinyllama-1.1b"][1])
    cases = family_cases(inputs) + [
        dict(tiny, mesh=(1, 4)), dict(tiny, mesh=(4, 1)),
        dict(tiny, mesh=(2, 2), grads=False,
             tcfg=dict(microbatches=2, grad_compression=True))] + \
        lever_cases(inputs) + nll_cases()
    t0 = time.perf_counter()
    results = run_grid(run_cases, 4, (cases,), timeout=900)[0]
    print(f"torch {torch.__version__}: {len(cases)} cases on a grid of 4 "
          f"gloo ranks in {time.perf_counter() - t0:.1f} s")
    failed = 0
    for case, res in zip(cases, results):
        if case["kind"] == "nll":
            errs = nll_errors(res, nll_reference(case))
            failed += max(errs.values()) > 1
            print(f"vocab-sharded loss {case['mesh']}: {res['seconds']:.1f} "
                  f"s; errors over their tolerances " + ", ".join(
                      f"{k} {v:.2e}" for k, v in errs.items()))
            continue
        errs = update_errors(res, port_reference(case), compression=bool(
            (case.get("tcfg") or {}).get("grad_compression")))
        ok = max(errs.values()) <= 1
        failed += not ok
        extra = {k: case[k] for k in ("tcfg", "runtime", "zero1")
                 if case.get(k)}
        print(f"{case['arch']} {case['mesh']} {extra or ''}: "
              f"{res['seconds']:.1f} s; errors over their tolerances "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + ("" if ok else " FAIL"))
    return failed


if __name__ == "__main__":
    raise SystemExit(1 if main() else 0)
