"""The benchmark's cells at sizes a CPU test run holds: the same files,
with the configuration's scale cut; on the CPU the port runs its kernels'
plain versions."""
import os
import time
from typing import Optional

from portbench import bench, spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = ("hpcg-104.cg", "graph500-s16.pagerank", "hpcg-104.spmm64",
         "graph500-s16.spmm64")
SMALL = {"hpcg": {"nx": 4, "ny": 5, "nz": 6}, "kronecker": {"scale": 7}}


def cell(name: str, maxiter: Optional[int] = None) -> spec.Cell:
    """The cell small; ``maxiter`` caps a solver where a fault keeps it
    from converging."""
    c = spec.resolve(spec.load_spec(ROOT), ROOT, name)
    c.config.update(SMALL[c.config["generator"]])
    c.traffic.update(pool=4, sample=4)
    if maxiter is not None and c.kind.SOLVES:
        c.traffic["solver_args"] = dict(c.traffic["solver_args"],
                                        maxiter=maxiter)
    return c


def run(name: str, *, seed: int = 2**31 + 17, seconds: float = 0.3,
        traced: bool = False, port=None, maxiter: Optional[int] = None
        ) -> dict:
    return bench.run(cell(name, maxiter), seed=seed, seconds=seconds,
                     traced=traced, device="cpu",
                     t_start=time.perf_counter(), port=port)
