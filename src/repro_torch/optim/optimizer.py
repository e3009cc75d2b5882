"""AdamW with a warmup-cosine schedule and global-norm clipping (port of
`repro.optim.optimizer`).

`repro`'s arithmetic, leaf by leaf in `repro`'s leaf order
(`optim.tree.leaves`): float32 moments, clipping by the global norm of the
gradients, float32 bias corrections, decoupled weight decay on every leaf,
the result cast back to the parameter's dtype. `repro` returns new trees;
here the parameters and the moments are updated in place under
`torch.no_grad()` and returned. The moments are trees of the parameters'
structure (for a family module, a module of its class); on a process mesh
they are DTensors on their parameters' layouts."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.sharding.dtensor import replicate, replication

from .tree import leaves, map_tree, named_tensors


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


def _device(tree) -> torch.device:
    return next(iter(named_tensors(tree).values())).device


def init_opt_state(params) -> OptState:
    # zeros_like: a DTensor parameter's moments are DTensors on its layout
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return OptState(
        mu=map_tree(zeros, params),
        nu=map_tree(zeros, params),
        step=torch.zeros((), dtype=torch.int32, device=_device(params)),
    )


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
    stepf = state.step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=stepf.device), stepf)
    P, G = named_tensors(params), named_tensors(grads)
    M, V = named_tensors(state.mu), named_tensors(state.nu)
    for leaf in leaves(params):
        for name in leaf.names:
            p, m, v = P[name], M[name], V[name]
            g = G[name].to(torch.float32) * scale
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
                + cfg.weight_decay * p.to(torch.float32)
            p.copy_(p.to(torch.float32) - lr * delta)
    return params, state, {"grad_norm": gnorm, "lr": lr}
