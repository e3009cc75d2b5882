"""HPCG's matrix: the 27-point stencil on an nx x ny x nz local grid.

As HPCG's reference `GenerateProblem`: row ``ix*ny*nz + iy*nz + iz`` holds
26 on the diagonal and -1 for every neighbour inside the grid (no periodic
boundary), so interior rows have 27 entries. The matrix does not depend on
the seed. Columns come out sorted within each row because the offsets are
walked in lexicographic (dx, dy, dz) order.
"""
from __future__ import annotations

import numpy as np
import torch

DIAG = 26.0
OFF = -1.0


def offsets():
    """The 27 (dx, dy, dz) offsets in lexicographic order."""
    return [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)]


def build(cfg: dict, device) -> tuple:
    """Host CSR of the stencil."""
    nx, ny, nz = int(cfg["nx"]), int(cfg["ny"]), int(cfg["nz"])
    dev = torch.device(device)
    ix = torch.arange(nx, device=dev).view(nx, 1, 1).expand(nx, ny, nz)
    iy = torch.arange(ny, device=dev).view(1, ny, 1).expand(nx, ny, nz)
    iz = torch.arange(nz, device=dev).view(1, 1, nz).expand(nx, ny, nz)
    ix, iy, iz = ix.reshape(-1), iy.reshape(-1), iz.reshape(-1)
    n = nx * ny * nz
    cols, ok = [], []
    for dx, dy, dz in offsets():
        jx, jy, jz = ix + dx, iy + dy, iz + dz
        ok.append((jx >= 0) & (jx < nx) & (jy >= 0) & (jy < ny)
                  & (jz >= 0) & (jz < nz))
        cols.append(jx * (ny * nz) + jy * nz + jz)
    cols = torch.stack(cols, dim=1)  # (n, 27), sorted within each row
    ok = torch.stack(ok, dim=1)
    counts = ok.sum(dim=1)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(counts, dim=0)
    indices = cols[ok].to(torch.int32)
    rows = torch.arange(n, device=dev).view(n, 1).expand(n, 27)[ok]
    data = torch.where(indices.to(torch.int64) == rows,
                       torch.tensor(DIAG, dtype=torch.float64, device=dev),
                       torch.tensor(OFF, dtype=torch.float64, device=dev))
    return (n, indptr.cpu().numpy(), indices.cpu().numpy(),
            data.cpu().numpy().astype(np.float64))


def expected_nnz(nx: int, ny: int, nz: int) -> int:
    """Entries of the stencil: (3n - 2) per axis multiplied out."""
    return (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)
