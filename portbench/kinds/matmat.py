"""matmat: `SpMVEngine.matmat(X)` a call, X one of a pool of ``pool``
blocks of ``k`` standard normal float32 columns already on the device.
Compared: ``spmm_error``, the largest |Y - A X| / (|A| |X|) over every
entry of the kept calls, against float64."""
from __future__ import annotations

import math

import torch

from portbench import reference
from portbench.kinds import Answer

SOLVES = False


def columns(traffic: dict) -> int:
    return int(traffic["k"])


def pool(traffic: dict, n: int, gen: torch.Generator, device) -> list:
    block = torch.randn((int(traffic["pool"]), n, int(traffic["k"])),
                        generator=gen, device=device)
    return list(block.unbind(0))


def warm(answer, traffic: dict, pool: list) -> None:
    answer(pool[0])  # every block has the same shape


def call(engine, traffic: dict, X: torch.Tensor) -> Answer:
    return Answer(engine.matmat(X))


def call_low(op: reference.Operator, traffic: dict, X: torch.Tensor
             ) -> Answer:
    return Answer(op.apply_low(X).to(torch.float32))


def check(traffic: dict, limits: dict, op: reference.Operator, pool: list,
          samples: list) -> dict:
    worst = -math.inf if samples else math.inf
    for p in sorted({p for p, _ in samples}):
        ref = (op.apply(pool[p]), op.apply(pool[p], absolute=True))
        for q, a in samples:
            if q == p:
                worst = max(worst, reference.spmm_error(op, pool[p], a.out,
                                                        ref))
        del ref
    return {"spmm_error": (worst, float(limits["spmm_error"]))}
