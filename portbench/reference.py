"""The plain reference: what the timed path's answers must be, worked out
again from the matrix the benchmark made.

Plain torch in float64, in blocks of nonzeros so that it fits beside the
program's state. It imports nothing of the port and takes nothing the port
made: the PageRank operator is derived here from the adjacency, as the
configuration defines it. `*_low` are the same computations in bfloat16
(products and sums in float32, each result rounded to bfloat16): the
control put in the program's place.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

F64 = torch.float64
BLOCK_NNZ = 1 << 22


class Operator:
    """y = A @ x for the cell's operator, as coordinate lists on a device.

    ``kind="matrix"``: A is the CSR as made. ``kind="transition"``: A is
    PageRank's column-stochastic operator of the adjacency, A[j, i] =
    1 / outdeg(i) for each edge i -> j; columns of vertices without edges
    are zero."""

    def __init__(self, n: int, indptr, indices, data, *, kind: str, device):
        dev = torch.device(device)
        indptr = torch.as_tensor(indptr, dtype=torch.int64)
        rows = torch.repeat_interleave(
            torch.arange(n, dtype=torch.int64), indptr[1:] - indptr[:-1])
        cols = torch.as_tensor(indices, dtype=torch.int64)
        if kind == "matrix":
            vals = torch.as_tensor(data, dtype=F64)
            self.out, self.inp = rows, cols
        elif kind == "transition":
            deg = (indptr[1:] - indptr[:-1]).to(F64)
            vals = 1.0 / deg[rows]
            self.out, self.inp = cols, rows  # edge i -> j lands in row j
        else:
            raise ValueError(f"unknown operator kind {kind!r}")
        self.n, self.device = n, dev
        self.out, self.inp = self.out.to(dev), self.inp.to(dev)
        self.vals = vals.to(dev)
        self.nnz = int(self.vals.numel())

    def apply(self, X: torch.Tensor, *, absolute: bool = False
              ) -> torch.Tensor:
        """A @ X (X: (n,) or (n, k)) in float64; with ``absolute``
        |A| @ |X|, the scale of each entry's rounding."""
        X = X.to(self.device, F64)
        if absolute:
            X = X.abs()
        Y = torch.zeros((self.n,) + tuple(X.shape[1:]), dtype=F64,
                        device=self.device)
        for lo in range(0, self.nnz, BLOCK_NNZ):
            hi = min(lo + BLOCK_NNZ, self.nnz)
            v = self.vals[lo:hi]
            if absolute:
                v = v.abs()
            prod = X[self.inp[lo:hi]]
            prod = prod * (v if X.dim() == 1 else v[:, None])
            Y.index_add_(0, self.out[lo:hi], prod)
        return Y

    def apply_low(self, X: torch.Tensor) -> torch.Tensor:
        """A @ X with A and X rounded to bfloat16, summed in float32,
        rounded to bfloat16."""
        bf = torch.bfloat16
        Xl = X.to(self.device).to(bf).to(torch.float32)
        Y = torch.zeros((self.n,) + tuple(X.shape[1:]), dtype=torch.float32,
                        device=self.device)
        for lo in range(0, self.nnz, BLOCK_NNZ):
            hi = min(lo + BLOCK_NNZ, self.nnz)
            v = self.vals[lo:hi].to(bf).to(torch.float32)
            prod = Xl[self.inp[lo:hi]]
            prod = prod * (v if X.dim() == 1 else v[:, None])
            Y.index_add_(0, self.out[lo:hi], prod)
        return Y.to(bf)


def relative_residual(A: Operator, b: torch.Tensor, x: torch.Tensor) -> float:
    """||b - A x|| / ||b|| in float64."""
    b64 = b.to(A.device, F64)
    r = b64 - A.apply(x)
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b64))


def pagerank(A: Operator, damping: float, *, tol: float = 1e-13,
             maxiter: int = 2000) -> torch.Tensor:
    """PageRank's fixed point in float64: x <- d A x + (1 - sum(d A x)) / n
    from the uniform vector until the L1 step is below `tol`."""
    n = A.n
    x = torch.full((n,), 1.0 / n, dtype=F64, device=A.device)
    for _ in range(maxiter):
        y = damping * A.apply(x)
        y = y + (1.0 - y.sum()) / n
        delta = float((y - x).abs().sum())
        x = y
        if delta < tol:
            return x
    raise RuntimeError(f"reference PageRank did not reach {tol} in "
                       f"{maxiter} steps")


def spmm_error(A: Operator, X: torch.Tensor, Y: torch.Tensor,
               ref: Optional[tuple] = None) -> float:
    """The largest |Y - A X| / (|A| |X|) over the entries (0 where both are
    0; inf where A X's scale is 0 but Y is not). `ref` = (A X, |A| |X|)."""
    want, scale = ref if ref is not None else (
        A.apply(X), A.apply(X, absolute=True))
    gap = (Y.to(A.device, F64) - want).abs()
    err = torch.where(scale > 0, gap / torch.where(scale > 0, scale, 1.0),
                      torch.where(gap > 0, math.inf, 0.0))
    return float(err.max()) if err.numel() else 0.0


def cg_low(A: Operator, b: torch.Tensor, *, tol: float, maxiter: int
           ) -> torch.Tensor:
    """Unpreconditioned CG from x = 0 with every vector in bfloat16 (each
    operation in float32, rounded): the control for a float32 CG."""
    bf, f32 = torch.bfloat16, torch.float32
    b = b.to(A.device).to(bf)
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rr = float(torch.dot(r.to(f32), r.to(f32)))
    stop = tol * tol * rr
    for _ in range(maxiter):
        if rr <= stop:
            break
        Ap = A.apply_low(p.to(f32))
        alpha = rr / float(torch.dot(p.to(f32), Ap.to(f32)))
        x = (x.to(f32) + alpha * p.to(f32)).to(bf)
        r = (r.to(f32) - alpha * Ap.to(f32)).to(bf)
        rr_new = float(torch.dot(r.to(f32), r.to(f32)))
        p = (r.to(f32) + (rr_new / rr) * p.to(f32)).to(bf)
        rr = rr_new
    return x.to(f32)


def pagerank_low(A: Operator, damping: float, x0: torch.Tensor, *,
                 tol: float, maxiter: int) -> torch.Tensor:
    """The PageRank iteration with x in bfloat16 (each step in float32,
    rounded): the control for a float32 PageRank."""
    bf, f32 = torch.bfloat16, torch.float32
    n = A.n
    x = x0.to(A.device).to(bf)
    for _ in range(maxiter):
        y = damping * A.apply_low(x.to(f32)).to(f32)
        y = y + (1.0 - y.sum()) / n
        delta = float((y - x.to(f32)).abs().sum())
        x = y.to(bf)
        if delta <= tol:
            break
    return x.to(f32)
