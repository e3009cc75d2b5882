"""Traffic kinds: one module a kind, found by the ``kind`` a traffic file
(`traffic/<mix>.json`) names (`spec.kind`).

A kind module gives:

- ``SOLVES``: whether each call is a solve (iterations, matvecs and
  convergence of its own), which the solve metrics read;
- ``columns(traffic)``: right-hand sides a call completes;
- ``pool(traffic, n, gen, device)``: the window's inputs, drawn with `gen`
  (seeded from the traffic file's ``pool_seed``), on `device`;
- ``warm(answer, traffic, pool)``: every path and shape the window takes,
  once, through `answer(x)`;
- ``call(engine, traffic, x)``: the port's entry the window times, over the
  engine the benchmark planned;
- ``call_low(op, traffic, x)``: the plain reference computed in the
  nearest precision below the configuration's (the control);
- ``check(traffic, limits, op, pool, samples)``: the numbers compared for
  the kept answers, ``name -> (value, limit)``.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Answer:
    """One call's output and the port's counts for it."""
    out: torch.Tensor
    iterations: int = 0
    matvecs: int = 0
    converged: bool = True
