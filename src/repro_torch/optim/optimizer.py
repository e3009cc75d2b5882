"""AdamW with a warmup-cosine schedule and global-norm clipping (port of
`repro.optim.optimizer`).

`repro`'s arithmetic, leaf by leaf in `repro`'s leaf order
(`optim.tree.leaves`): float32 moments, clipping by the global norm of the
gradients, float32 bias corrections, decoupled weight decay on every leaf,
the result cast back to the parameter's dtype. `repro` returns new trees;
here the parameters and the moments are updated in place under
`torch.no_grad()` and returned. The moments are trees of the parameters'
structure (for a family module, a module of its class); on a process mesh
they are DTensors on their parameters' layouts, or on ZeRO-1's
(`zero1_opt_state`: `repro`'s fold of the DP axes, per layer, and a leaf
that no per-layer placement holds in `repro`'s bytes kept stacked, as
`repro` holds it). A parameter held stacked (FSDP, `optim.tree.
stack_leaves`) is one tensor of its leaf, its moments stacked too; where
they lie on another layout than the parameter's, the update runs on
theirs."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.sharding.dtensor import holds_dtensors, is_dtensor, \
    redistribute, replicate, replication

from .tree import Leaf, leaves, map_named, map_tree, named_tensors


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    mu: Any  # first moment (a tree like the parameters, float32)
    nu: Any  # second moment
    step: torch.Tensor  # scalar int32, on the parameters' device
    # ZeRO-1 on a process mesh only: {"mu": {keystr: tensor}, "nu": ...},
    # the stacked moments of the leaves `mu` and `nu` hold None for
    stacked: Optional[dict] = None


def _device(tree) -> torch.device:
    return next(iter(named_tensors(tree).values())).device


def init_opt_state(params, *, zero1: bool = False) -> OptState:
    """Zero moments on the parameters' layouts (DTensors on a process mesh)
    and step 0; with `zero1` on DTensor parameters, on ZeRO-1's layout
    (`zero1_opt_state`)."""
    if zero1 and holds_dtensors(params):
        mesh = next(iter(named_tensors(params).values())).device_mesh
        return zero1_opt_state(params, mesh)
    # zeros_like: a DTensor parameter's moments are DTensors on its layout
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return OptState(
        mu=map_tree(zeros, params),
        nu=map_tree(zeros, params),
        step=torch.zeros((), dtype=torch.int32, device=_device(params)),
    )


def zero1_opt_state(shapes, mesh, *, expert_2d: bool = False, make=None,
                    device=None) -> OptState:
    """Zero AdamW moments for parameters of `shapes`' structure and global
    shapes (a family module on any device, ``meta`` too) on ZeRO-1's layout
    on the process mesh `mesh`: each port tensor's by
    `rules.zero1_tensor_pspecs` (`repro`'s fold of the DP axes, per layer),
    but for the leaves `rules.zero1_stacked_pspecs` names (no per-layer
    placement holds `repro`'s bytes), whose moments are one float32 tensor
    a leaf, its layers stacked on the leading axes as `repro` holds the
    leaf, on `repro`'s spec: ``stacked`` holds them and ``mu``/``nu`` None
    in their place. ``make(t, sharding)`` makes each moment from a float32
    tensor `t` on ``meta`` of its global shape (default: zeros, only this
    rank's shard allocated); the step lives on `device` (default the
    mesh's)."""
    from repro_torch.sharding import dtensor, rules

    per_tensor = rules.to_shardings(rules.zero1_tensor_pspecs(
        shapes, mesh, expert_2d=expert_2d), mesh)
    stacked = {key: rules.Sharding(mesh, rules.to_placements(spec, mesh))
               for key, spec in rules.zero1_stacked_pspecs(
                   shapes, mesh, expert_2d=expert_2d).items()}
    named = named_tensors(shapes)
    by_key = {leaf.key: leaf for leaf in leaves(shapes)}
    skip = {n for key in stacked for n in by_key[key].names}

    if make is None:
        def make(t, sharding):
            out = dtensor.empty(t, sharding)
            out.to_local().zero_()
            return out

    def on_meta(shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    def moments():
        tree = map_named(lambda n, t: None if n in skip else make(
            on_meta(t.shape), per_tensor[n]), shapes)
        return tree, {key: make(on_meta(_stacked_shape(by_key[key], named)),
                                sh) for key, sh in stacked.items()}

    (mu, smu), (nu, snu) = moments(), moments()
    step = torch.zeros((), dtype=torch.int32,
                       device=device or dtensor.mesh_device(mesh))
    return OptState(mu, nu, step, {"mu": smu, "nu": snu} if stacked
                    else None)


def _stacked_shape(leaf: Leaf, named) -> tuple:
    """A `repro` leaf's shape: its stacked axes, then a layer's."""
    return tuple(leaf.lead) + tuple(named[leaf.names[0]].shape)


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at `step` (a tensor), in float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0,
    )
    cos = cfg.lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5
                    * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def bias_corrections(cfg: OptConfig, step: torch.Tensor):
    """(1 - b1**step, 1 - b2**step) in float32 at the device tensor `step`,
    `repro`'s float32 powers of the float32 betas. Each beta is filled into
    a tensor on the step's device (a fill, not a copy from the host: the
    update is captured as a CUDA graph on the card)."""
    stepf = step.to(torch.float32)
    return tuple(1 - torch.pow(torch.full((), b, dtype=torch.float32,
                                          device=stepf.device), stepf)
                 for b in cfg.betas)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, summed leaf by
    leaf in `repro`'s order, each tensor in row-major order (a gradient
    that autograd laid out transposed is summed from a contiguous copy, so
    the norm's bits do not depend on the layout). On DTensors each rank
    sums its shards and the total is reduced over the mesh into a
    replicated scalar."""
    named = named_tensors(tree)
    total = None
    for leaf in leaves(tree):
        s = sum(torch.sum(torch.square(
            named[n].to(torch.float32).contiguous())) for n in leaf.names)
        total = s if total is None else total + s
    return torch.sqrt(replicate(total))


@torch.no_grad()
def adamw_update(
    cfg: OptConfig,
    params,
    grads,
    state: OptState,
    *,
    grad_scale: Optional[torch.Tensor] = None,
):
    """One AdamW step on `params` with `grads` (a tree of the same
    structure). Updates `params`, ``state.mu``, ``state.nu`` and
    ``state.step`` in place; returns (params, state, metrics). DTensor
    parameters take gradients and moments on their own layouts; the
    schedule's scalars meet them as replicated values."""
    with replication(params):
        return _adamw_update(cfg, params, grads, state, grad_scale)


def _adamw_update(cfg, params, grads, state, grad_scale):
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    scale = clip if grad_scale is None else clip * grad_scale
    state.step.add_(1)
    lr = lr_at(cfg, state.step)
    b1, b2 = cfg.betas
    bc1, bc2 = bias_corrections(cfg, state.step)
    P, G = named_tensors(params), named_tensors(grads)
    M, V = named_tensors(state.mu), named_tensors(state.nu)
    stacked = state.stacked or {"mu": {}, "nu": {}}
    for leaf in leaves(params):
        if leaf.key in stacked["mu"]:
            _update_stacked(cfg, leaf, P, G, stacked["mu"][leaf.key],
                            stacked["nu"][leaf.key], scale, lr, bc1, bc2)
            continue
        for name in leaf.names:
            p, m, v = P[name], M[name], V[name]
            g = G[name].to(torch.float32) * scale
            pf = p.to(torch.float32)
            # FSDP's stacked parameter on the fold, its moments on the
            # rules' layout (`repro`'s bytes): the update on the moments'
            moved = is_dtensor(m) and tuple(m.placements) != \
                tuple(p.placements)
            if moved:
                g, pf = (redistribute(t, m.placements) for t in (g, pf))
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
                + cfg.weight_decay * pf
            new = pf - lr * delta
            p.copy_(redistribute(new, p.placements) if moved else new)
    return params, state, {"grad_norm": gnorm, "lr": lr}


def _update_stacked(cfg, leaf: Leaf, P, G, m, v, scale, lr, bc1, bc2):
    """One leaf whose moments `m`, `v` are stacked (`zero1_opt_state`), in
    the per-layer update's arithmetic: its layers' gradients and parameters
    stacked the same way and taken on the moments' layout (each rank cuts
    its rows of the replicated layer axis: no collective), the update there,
    then the new parameters gathered back onto their layout and each layer
    copied its row."""
    b1, b2 = cfg.betas
    first = P[leaf.names[0]]

    def on_moments(tensors):
        t = torch.stack([x.to(torch.float32) for x in tensors])
        if len(leaf.lead) > 1:
            t = t.reshape(m.shape)
        return redistribute(t, m.placements) if is_dtensor(m) else t

    g = on_moments([G[n] for n in leaf.names]) * scale
    p = on_moments([P[n] for n in leaf.names])
    m.copy_(b1 * m + (1 - b1) * g)
    v.copy_(b2 * v + (1 - b2) * g * g)
    delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
        + cfg.weight_decay * p
    new = (p - lr * delta).to(first.dtype)
    if is_dtensor(first):
        from torch.distributed.tensor import Shard

        n = len(leaf.lead)
        new = redistribute(new, [Shard(q.dim + n) if q.is_shard() else q
                                 for q in first.placements])
    new = new.reshape((-1,) + tuple(first.shape))
    for i, name in enumerate(leaf.names):
        P[name].copy_(new[i])
