"""Whether the window's answers are right: the numbers compared, each with
the limit that `cells/<cell>.json` gives it.

- every kind: ``raised``, the calls of the window that raised (limit 0);
- a kind whose calls are solves: ``unconverged``, the solves that returned
  without reaching their tolerance (limit 0);
- the kind's own numbers for the kept answers (`kinds/<kind>.py`'s
  ``check``).

A window that kept no answer reads inf: nothing came.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from . import reference


def numbers(kind, traffic: dict, limits: dict, op: reference.Operator,
            pool: list, samples: List[tuple], *, raised: int,
            unconverged: int) -> Dict[str, Tuple[float, float]]:
    """name -> (value, limit)."""
    out = {"raised": (float(raised), float(limits["raised"]))}
    if kind.SOLVES:
        out["unconverged"] = (float(unconverged),
                              float(limits["unconverged"]))
    out.update(kind.check(traffic, limits, op, pool, samples))
    return out


def passed(checks: Dict[str, Tuple[float, float]]) -> bool:
    """Every number at or under its limit (a NaN fails)."""
    return all(v <= lim for v, lim in checks.values())
