"""Graph500's Kronecker generator and kernel 1's graph.

The edge list follows the Graph500 specification's reference generator
(`kronecker_generator.m`): for each of `scale` bits an edge picks a
quadrant with probabilities A, B, C and D = 1 - A - B - C, then the
vertices are relabelled by a random permutation. As kernel 1 builds it, the
graph is undirected: self-loops are dropped, each edge stored both ways and
duplicates merged, so the adjacency is symmetric with values 1. The
random numbers come from a `torch.Generator` on `device` seeded with the
configuration's ``seed``, so a configuration is one graph, as a
Graphalytics data set is (the specification's own generator is another;
the distribution is the same). The specification's final shuffle of the edge list is left
out: the CSR it turns into is the same.
"""
from __future__ import annotations

import numpy as np
import torch


def edges(cfg: dict, device) -> tuple:
    """(i, j) int64 tensors of the edge list on `device`, drawn from the
    configuration's ``seed``."""
    scale, ef = int(cfg["scale"]), int(cfg["edgefactor"])
    a, b, c = float(cfg["A"]), float(cfg["B"]), float(cfg["C"])
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(cfg["seed"]))
    n, m = 1 << scale, ef << scale
    ab, c_norm, a_norm = a + b, c / (1.0 - (a + b)), a / (a + b)
    i = torch.zeros(m, dtype=torch.int64, device=dev)
    j = torch.zeros(m, dtype=torch.int64, device=dev)
    for bit in range(scale):
        ii = torch.rand(m, generator=gen, device=dev) > ab
        jj = torch.rand(m, generator=gen, device=dev) > torch.where(
            ii, c_norm, a_norm)
        i += ii.to(torch.int64) << bit
        j += jj.to(torch.int64) << bit
    perm = torch.randperm(n, generator=gen, device=dev)
    return perm[i], perm[j]


def build(cfg: dict, device) -> tuple:
    """Host CSR of kernel 1's undirected graph (values 1)."""
    n = 1 << int(cfg["scale"])
    i, j = edges(cfg, device)
    keep = i != j
    i, j = i[keep], j[keep]
    key = torch.unique(torch.cat([i * n + j, j * n + i]))  # sorted
    rows = torch.div(key, n, rounding_mode="floor")
    cols = key - rows * n
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=i.device)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n), dim=0)
    return (n, indptr.cpu().numpy(), cols.to(torch.int32).cpu().numpy(),
            np.ones(key.numel(), dtype=np.float64))
