"""Readings that set a cell's limits: the port's over many seeds, and the
control's, which must fail.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <s> --mode port|port-bf16|reference-bf16

runs the cell's set-up, a short window and the check once a seed, in one
process, and prints each seed's numbers compared (one JSON line each).
``port`` is the program as the benchmark runs it; ``port-bf16`` the port
with its bfloat16 value storage (`value_dtype="bf16"`), the port's own
lower precision; ``reference-bf16`` the plain reference put in the port's
place and computed in bfloat16 (`ReferenceLow`). The benchmark's runs do
not run this; `portbench/tests/test_portbench_control.py` runs it small
on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class ReferenceLow:
    """The reference computed in bfloat16, in the port's place: each call
    the window makes answered by its kind's `call_low`."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.op = None

    def plan(self, cfg, n, indptr, indices, data) -> None:
        from portbench import reference

        self.op = reference.Operator(n, indptr, indices, data,
                                     kind=cfg["operator"], device=self.device)

    def plan_elements(self) -> int:
        return self.op.nnz

    def answer(self, kind, traffic, x):
        return kind.call_low(self.op, traffic, x)

    @staticmethod
    def captures() -> int:
        return 0

    def release(self) -> None:
        self.op = None


def make_port(mode: str, device):
    from portbench import program

    if mode == "port":
        return program.Port(device)
    if mode == "port-bf16":
        return program.Port(device, value_dtype="bf16")
    if mode == "reference-bf16":
        return ReferenceLow(device)
    raise ValueError(f"unknown mode {mode!r}")


def readings(cell, seeds, seconds: float, mode: str, device) -> list:
    """One dict a seed: the numbers compared and the window's counts."""
    from portbench import bench

    out = []
    for seed in seeds:
        line = bench.run(cell, seed=seed, seconds=seconds, traced=False,
                         device=device, t_start=time.perf_counter(),
                         port=make_port(mode, device))
        out.append({"seed": seed, "mode": mode, "correct": line["correct"],
                    "attempted": line["attempted"],
                    "checks": {k: v["value"]
                               for k, v in line["checks"].items()}})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--mode", default="port")
    args = ap.parse_args(argv)
    for path in (os.path.join(ROOT, "src"), ROOT):
        if path not in sys.path:
            sys.path.insert(0, path)
    from portbench import spec

    cell = spec.resolve(spec.load_spec(ROOT), ROOT, args.workload)
    device = "cuda:0" if torch.cuda.is_available() else "cpu"
    seeds = [int(s) for s in args.seeds.split(",")]
    for r in readings(cell, seeds, args.seconds, args.mode, device):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
