"""pagerank: one PageRank solve a call, `solvers.pagerank(engine,
x0=start, **solver_args)`, the start from a pool of ``pool`` positive
vectors summing to 1. Compared: ``rank_l1_error``, the largest
||x - x*||_1 of the kept solves, x* the reference's float64 fixed point of
the operator it derives itself."""
from __future__ import annotations

import math

import torch

from portbench import reference
from portbench.kinds import Answer

SOLVES = True
#: Steps the control's solve may take: the port's own PageRank maxiter.
LOW_MAXITER = 200


def columns(traffic: dict) -> int:
    return 1


def pool(traffic: dict, n: int, gen: torch.Generator, device) -> list:
    u = torch.rand((int(traffic["pool"]), n), generator=gen, device=device)
    return list((u / u.sum(dim=1, keepdim=True)).unbind(0))


def warm(answer, traffic: dict, pool: list) -> None:
    for x0 in pool:
        answer(x0)


def call(engine, traffic: dict, x0: torch.Tensor) -> Answer:
    from repro_torch.core import solvers

    res = solvers.pagerank(engine, x0=x0, **traffic["solver_args"])
    return Answer(res.x, res.iterations, res.matvecs, res.converged)


def call_low(op: reference.Operator, traffic: dict, x0: torch.Tensor
             ) -> Answer:
    kw = traffic["solver_args"]
    x = reference.pagerank_low(op, float(kw["damping"]), x0,
                               tol=float(kw["tol"]), maxiter=LOW_MAXITER)
    return Answer(x, LOW_MAXITER, LOW_MAXITER, True)


def check(traffic: dict, limits: dict, op: reference.Operator, pool: list,
          samples: list) -> dict:
    worst = math.inf
    if samples:
        want = reference.pagerank(op, float(traffic["solver_args"]["damping"]))
        worst = max(float((a.out.to(want.device, want.dtype) - want)
                          .abs().sum()) for _, a in samples)
    return {"rank_l1_error": (worst, float(limits["rank_l1_error"]))}
