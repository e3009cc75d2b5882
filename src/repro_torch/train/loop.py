"""Training loop (port of `repro.train.loop`): microbatched
(gradient-accumulation) training with checkpoint/restart, async saves,
optional error-feedback gradient compression and straggler accounting, on
one device or on a (data, model) process mesh.

Gradients come from `torch.autograd.grad` per microbatch and are summed
into float32 accumulators, as `repro` sums into float32 zeros (``.grad``
would accumulate in the parameters' dtype, bf16 at full width).

On a process mesh (`launch.mesh.make_process_mesh`) the parameters and the
AdamW moments are DTensors placed by `sharding.rules.param_pspecs`, each
rank keeps its rows of the batch by `batch_pspecs`, and the same update
runs on them: DTensor inserts the collectives `repro`'s pjit leaves to
XLA, and each gradient is reduced onto its parameter's layout before the
optimizer sees it. Metrics come back as replicated scalars on every rank.

On the card `train` runs `repro`'s ``jax.jit(update)`` as one CUDA graph:
`update_over_buffers` is the update over static buffers (the parameters,
the moments and the step updated in place, the compression residual and
the metrics copied back, a static batch the pipeline's batch is copied
into); `train` runs it once eagerly on a side stream, the warm-up and a
real step, then captures it there once (`core.capture.CapturedStep`) and
replays it a step. On an NCCL process mesh the same: the parameters,
moments and batch are DTensors that live across steps, each rank copies
its rows of the next batch into its shard of the static batch, and the
graph holds DTensor's local kernels and its NCCL collectives. A gloo (CPU)
mesh trains eagerly, as the CPU does.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.capture import CapturedStep, on_side_stream
from repro_torch.core.runtime import resolve_device
from repro_torch.data.pipeline import DataConfig, PrefetchIterator, \
    TokenPipeline, device_put_batch, local_rows
from repro_torch.models import Model, lm_loss
from repro_torch.models.transformer import Runtime
from repro_torch.optim.compression import compress_with_feedback, \
    init_residual
from repro_torch.optim.optimizer import OptConfig, OptState, adamw_update, \
    init_opt_state
from repro_torch.optim.tree import map_tree, named_tensors
from repro_torch.sharding.dtensor import distribute, full, is_dtensor, \
    like, mesh_device, place_tree, replicate, replication
from repro_torch.sharding.rules import Sharding, batch_pspecs, to_shardings
from repro_torch.train.checkpoint import AsyncCheckpointer, restore_latest


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    total_steps: int = 200
    microbatches: int = 1  # gradient-accumulation steps per update
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    grad_compression: bool = False  # error-feedback int8 on the DP reduce
    step_deadline_s: Optional[float] = None


def value_and_grad(loss_fn: Callable, params) -> Tuple[torch.Tensor, Any]:
    """(loss, grads): ``loss_fn(params)`` detached and its gradients as a
    tree of the parameters' structure (zeros for a parameter the loss does
    not use, as ``jax.grad`` gives). On DTensor parameters each gradient
    comes back on its parameter's layout (the data-axis reduction done) and
    the loss replicated."""
    named = named_tensors(params)
    with torch.enable_grad(), replication(params):
        loss = loss_fn(params)
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True,
                                    materialize_grads=True)
    by_name = {n: like(g, named[n]) for n, g in zip(named, grads)}
    return replicate(loss.detach()), map_tree(lambda p, g: g, params,
                                              by_name)


def _microbatch(v: torch.Tensor, n: int, i: int) -> torch.Tensor:
    """Rows ``[i*B/n, (i+1)*B/n)`` of a batch tensor, `repro`'s reshape to
    (n, B/n, ...) indexed at i; a DTensor batch's microbatch is sharded as
    the batch is (its ids gathered first: a collective)."""
    if not is_dtensor(v):
        return v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))[i]
    whole = full(v)
    part = whole.reshape((n, whole.shape[0] // n) + tuple(whole.shape[1:]))
    return distribute(part[i], Sharding(v.device_mesh, v.placements))


def make_update_fn(model: Model, opt_cfg: OptConfig, rt: Runtime,
                   tcfg: TrainConfig):
    """Returns update(params, opt_state, residual, batch) ->
    (params, opt_state, residual, metrics): the batch split into
    `tcfg.microbatches` along its leading axis, their gradients summed in
    float32 and averaged, optional error-feedback compression, then AdamW
    (in place)."""

    def loss_on(mb):
        return lambda p: lm_loss(model, p, mb, rt)

    def update(params, opt_state: OptState, residual, batch):
        n = tcfg.microbatches
        if n > 1:
            gsum = map_tree(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            acc = named_tensors(gsum)
            lsum = None
            for i in range(n):
                mb = {k: _microbatch(v, n, i) for k, v in batch.items()}
                loss, grads = value_and_grad(loss_on(mb), params)
                for name, g in named_tensors(grads).items():
                    acc[name].add_(g)
                lsum = loss.float() if lsum is None else lsum + loss
                del grads
            for g in acc.values():
                g.div_(n)
            grads, loss = gsum, lsum / n
        else:
            loss, grads = value_and_grad(loss_on(batch), params)

        if tcfg.grad_compression:
            grads, residual = compress_with_feedback(grads, residual)

        params, opt_state, metrics = adamw_update(
            opt_cfg, params, grads, opt_state
        )
        metrics["loss"] = loss
        return params, opt_state, residual, metrics

    return update


METRICS = ("loss", "grad_norm", "lr")


def update_over_buffers(model: Model, opt_cfg: OptConfig, rt: Runtime,
                        tcfg: TrainConfig, params, opt_state: OptState,
                        residual, batch: Dict[str, torch.Tensor]):
    """The update `train` runs over static buffers, the counterpart of
    `launch.serve.one_token_step`: `make_update_fn`'s update of `params`
    and `opt_state` (in place) on the tensors `batch` holds when it runs,
    the new compression residual copied back into `residual`'s tensors.
    Returns a function of no arguments that runs one update and returns
    its metrics, ``{"loss", "grad_norm", "lr"}``, as the same tensors on
    every call (made by the first; a captured graph writes them)."""
    update = make_update_fn(model, opt_cfg, rt, tcfg)
    outputs: Dict[str, torch.Tensor] = {}

    def step():
        _, _, new, metrics = update(params, opt_state, residual, batch)
        if new is not residual:  # compression: a new residual tree
            into = named_tensors(residual)
            for name, t in named_tensors(new).items():
                into[name].copy_(t)
        for k in METRICS:
            if k in outputs:
                outputs[k].copy_(metrics[k])
            else:
                outputs[k] = metrics[k].detach().clone()
        return outputs

    return step


def copy_batch(static: Dict[str, torch.Tensor], host) -> None:
    """The pipeline's numpy batch copied into the static batch in place; a
    DTensor of it takes this rank's rows into its local shard (the batch's
    placements stay as the first step made them). A copy to the card goes
    through pinned memory without blocking the host."""
    for name, arr in host.items():
        dst = static[name]
        if is_dtensor(dst):
            arr = local_rows(arr, Sharding(dst.device_mesh, dst.placements))
            dst = dst.to_local()
        src = torch.from_numpy(np.ascontiguousarray(arr))
        if dst.device.type == "cuda":
            src = src.pin_memory()
        dst.copy_(src, non_blocking=True)


def _process_mesh(mesh) -> bool:
    """Whether `mesh` is a ``torch.distributed`` process mesh (a
    ``DeviceMesh`` with named dims), not a grid of devices in one
    process."""
    return hasattr(mesh, "mesh_dim_names") and hasattr(mesh, "get_group")


def _single_device(mesh, device):
    if mesh is None:
        return resolve_device(device)
    devices = list(mesh.devices.reshape(-1))
    if len(devices) > 1:
        raise ValueError(
            f"train on a grid of {len(devices)} devices in one process: "
            f"training shards over a process mesh, one rank a device "
            f"(launch.mesh.make_process_mesh under torch.distributed.run); "
            f"pass that, mesh=None or a one-device mesh")
    return resolve_device(devices[0])


def _mesh_device(mesh, device) -> torch.device:
    """This rank's device on a process mesh (`sharding.dtensor.
    mesh_device`), which `device`, when given, must agree with."""
    dev = mesh_device(mesh)
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"device {device} on a {mesh.device_type} mesh")
    return dev


def train(
    model: Model,
    *,
    mesh=None,
    rt: Runtime = Runtime(),
    opt_cfg: OptConfig = OptConfig(),
    tcfg: TrainConfig = TrainConfig(),
    data_cfg: Optional[DataConfig] = None,
    seed: int = 0,
    device=None,
    capture: Optional[bool] = None,
) -> Dict[str, Any]:
    """End-to-end training on `device` (default the card; a one-device
    `mesh` of `launch.mesh` names it instead), or sharded over a process
    mesh (`launch.mesh.make_process_mesh`; every rank of it calls this).
    Returns summary metrics (final loss, history) with the trained
    parameters and optimizer state (DTensors on a process mesh).

    Every step is `update_over_buffers`' update. On the card (``capture``
    None or True) the first step runs eagerly on a side stream, the
    capture's warm-up and a real step (logged, checkpointed), then the
    update is captured there once as a CUDA graph
    (`core.capture.CapturedStep`) and each later step copies the
    pipeline's batch into the static batch and replays it; a capture that
    fails raises. On an NCCL process mesh the same (`repro` jits the
    update on any mesh): the first step's batch DTensors are the static
    batch, each rank copying its rows of the next into its shard.
    ``capture=False`` runs every step eagerly, as the CPU and a gloo mesh
    do; ``capture=True`` off the card raises ValueError. Each history
    entry reads the step's loss, grad norm and lr from its outputs and
    names its kind: ``"step"`` (eager) or ``"replay"``."""
    sharded = _process_mesh(mesh)
    device = _mesh_device(mesh, device) if sharded \
        else _single_device(mesh, device)
    if capture is None:
        capture = device.type == "cuda"
    if capture and device.type != "cuda":
        raise ValueError(f"capture=True needs the card; training runs on "
                         f"{device}")
    cfg = model.cfg
    data_cfg = data_cfg or DataConfig(
        vocab_size=cfg.vocab_size, seq_len=128, global_batch=8
    )
    pipeline = TokenPipeline(data_cfg)

    # every rank draws the same parameters from the seed and keeps its
    # shards of them, placing each layer as it is drawn
    params = model.init(
        torch.Generator(device=device).manual_seed(seed), device=device,
        place=functools.partial(place_tree, mesh=mesh) if sharded else None)
    batch_sh = None
    if sharded:
        batch_sh = to_shardings(
            batch_pspecs(pipeline.batch_at(0), mesh), mesh)
    opt_state = init_opt_state(params)
    residual = init_residual(params) if tcfg.grad_compression else None

    batch: Dict[str, torch.Tensor] = {}  # the static batch the update reads
    update = update_over_buffers(model, opt_cfg, rt, tcfg, params,
                                 opt_state, residual, batch)
    side = torch.cuda.Stream(device) if capture else None
    graph: Optional[CapturedStep] = None

    ckpt = AsyncCheckpointer(tcfg.ckpt_dir) if tcfg.ckpt_dir else None
    start_step = 0
    if ckpt is not None:
        # into the same tensors: the update (and its graph) reads them
        restored = restore_latest(
            tcfg.ckpt_dir, {"params": params, "opt": opt_state}
        )
        if restored is not None:
            start_step = restored[0] + 1
            pipeline.skip_to(start_step)

    history = []
    it = PrefetchIterator(iter(pipeline), depth=2)
    t_start = time.time()
    slow_steps = 0
    capture_s = None
    for step in range(start_step, tcfg.total_steps):
        t0 = time.time()
        host = next(it)
        if graph is not None:
            copy_batch(batch, host)
            kind, metrics = "replay", graph()
        else:
            batch.update(device_put_batch(host, device, shardings=batch_sh))
            kind = "step"
            metrics = update() if side is None else on_side_stream(side,
                                                                   update)
        if device.type == "cuda":
            torch.cuda.synchronize(device)  # honest step timing
        dt = time.time() - t0
        if tcfg.step_deadline_s and dt > tcfg.step_deadline_s:
            slow_steps += 1
        if step % tcfg.log_every == 0 or step == tcfg.total_steps - 1:
            history.append(
                {"step": step, "loss": float(metrics["loss"]),
                 "grad_norm": float(metrics["grad_norm"]),
                 "lr": float(metrics["lr"]), "kind": kind, "sec": dt}
            )
        if ckpt is not None and (
            step % tcfg.ckpt_every == 0 or step == tcfg.total_steps - 1
        ):
            ckpt.save(step, {"params": params, "opt": opt_state})
        if side is not None and graph is None \
                and step + 1 < tcfg.total_steps:
            t0 = time.time()
            graph = CapturedStep(update, side, f"{cfg.name}: train could "
                                 f"not capture the training update",
                                 process_group=sharded)
            torch.cuda.synchronize(device)
            capture_s = time.time() - t0
    if ckpt is not None:
        ckpt.wait()
    it.close()
    return {
        "history": history,
        "final_loss": history[-1]["loss"] if history else None,
        "params": params,
        "opt_state": opt_state,
        "wall_seconds": time.time() - t_start,
        "slow_steps": slow_steps,
        "steps": max(tcfg.total_steps - start_step, 0),
        "device": device,
        "captured": graph is not None,
        "capture_seconds": capture_s,
    }
