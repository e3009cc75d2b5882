"""cg: one unpreconditioned CG solve a call, `solvers.cg(engine, b,
**solver_args)` from x = 0, b from a pool of ``pool`` standard normal
float32 vectors. Compared: ``true_residual``, the largest ||b - A x|| /
||b|| of the kept solves, in float64 against the benchmark's matrix."""
from __future__ import annotations

import math

import torch

from portbench import reference
from portbench.kinds import Answer

SOLVES = True
#: Steps the control's solve may take: about 2.5x what the port's float32
#: CG takes on hpcg-104.
LOW_MAXITER = 400


def columns(traffic: dict) -> int:
    return 1


def pool(traffic: dict, n: int, gen: torch.Generator, device) -> list:
    return list(torch.randn((int(traffic["pool"]), n), generator=gen,
                            device=device).unbind(0))


def warm(answer, traffic: dict, pool: list) -> None:
    # a solver's graph blocks are captured on first use; each right-hand
    # side takes its own blocks, and the same again when it comes back
    for b in pool:
        answer(b)


def call(engine, traffic: dict, b: torch.Tensor) -> Answer:
    from repro_torch.core import solvers

    res = solvers.cg(engine, b, **traffic["solver_args"])
    return Answer(res.x, res.iterations, res.matvecs, res.converged)


def call_low(op: reference.Operator, traffic: dict, b: torch.Tensor
             ) -> Answer:
    x = reference.cg_low(op, b, tol=float(traffic["solver_args"]["tol"]),
                         maxiter=LOW_MAXITER)
    return Answer(x, LOW_MAXITER, LOW_MAXITER, True)


def check(traffic: dict, limits: dict, op: reference.Operator, pool: list,
          samples: list) -> dict:
    worst = max((reference.relative_residual(op, pool[p], a.out)
                 for p, a in samples), default=math.inf)
    return {"true_residual": (worst, float(limits["true_residual"]))}
