"""Synthetic sparse-matrix suite standing in for SuiteSparse + HPCG (offline env).

The paper evaluates on twenty real-world matrices (columns 1.4k..6.8M, nnz
23k..37M). The property the coalescer exploits is the *block locality spectrum*
of the column-index stream: stencil/banded matrices have high within-window
locality, graph/power-law matrices have hub-reuse, uniform-random matrices have
almost none. The generators below span that spectrum; `paper_suite()` returns a
twenty-matrix set with the paper's size range (scaled down by default so the
benchmark harness runs on CPU in minutes; pass scale="paper" for full sizes).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import numpy as np

from .formats import CSRMatrix, coo_to_csr

# Every generator returned below is callable as `gen(rng)` (explicit
# numpy Generator) or `gen(seed=7)` / `gen()` (deterministic from the seed,
# default 0) — solver/property tests need instances that are reproducible
# without threading global RNG state through the call site.
Gen = Callable[..., CSRMatrix]


def _resolve_rng(rng, seed: int) -> np.random.Generator:
    if rng is None:
        return np.random.default_rng(seed)
    if not isinstance(rng, np.random.Generator):
        raise TypeError(
            f"rng must be a numpy Generator or None, got {type(rng).__name__}"
        )
    return rng


@dataclasses.dataclass(frozen=True)
class MatrixSpec:
    name: str
    family: str  # stencil | banded | powerlaw | random | block
    gen: Gen


def hpcg_stencil(nx: int, ny: int, nz: int) -> Gen:
    """HPCG-style 27-point stencil on an nx*ny*nz grid (symmetric, diag-heavy)."""

    def build(rng: np.random.Generator | None = None, *,
              seed: int = 0) -> CSRMatrix:
        rng = _resolve_rng(rng, seed)
        n = nx * ny * nz
        ix, iy, iz = np.meshgrid(
            np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
        )
        base = (ix * ny * nz + iy * nz + iz).reshape(-1)
        rows_l, cols_l, vals_l = [], [], []
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    jx, jy, jz = ix + dx, iy + dy, iz + dz
                    ok = (
                        (jx >= 0) & (jx < nx)
                        & (jy >= 0) & (jy < ny)
                        & (jz >= 0) & (jz < nz)
                    ).reshape(-1)
                    nb = (jx * ny * nz + jy * nz + jz).reshape(-1)
                    rows_l.append(base[ok])
                    cols_l.append(nb[ok])
                    v = 26.0 if (dx == 0 and dy == 0 and dz == 0) else -1.0
                    vals_l.append(np.full(ok.sum(), v))
        rows = np.concatenate(rows_l)
        cols = np.concatenate(cols_l)
        vals = np.concatenate(vals_l)
        return coo_to_csr(n, n, rows, cols, vals)

    return build


def banded(n: int, half_bw: int, fill: float = 0.6) -> Gen:
    """Banded matrix: nonzeros within |i-j| <= half_bw, randomly filled."""

    def build(rng: np.random.Generator | None = None, *,
              seed: int = 0) -> CSRMatrix:
        rng = _resolve_rng(rng, seed)
        nnz_per_row = max(1, int((2 * half_bw + 1) * fill))
        rows = np.repeat(np.arange(n), nnz_per_row)
        offs = rng.integers(-half_bw, half_bw + 1, size=rows.size)
        cols = np.clip(rows + offs, 0, n - 1)
        vals = rng.standard_normal(rows.size)
        return coo_to_csr(n, n, rows, cols, vals)

    return build


def powerlaw(n: int, avg_deg: int, alpha: float = 1.2,
             skew: float | None = None) -> Gen:
    """Scale-free graph adjacency: column targets drawn from a Zipf-like hub
    distribution — models graph-analytics matrices with heavy column reuse.

    ``skew`` sharpens the *row-degree* tail (the axis shard balance cares
    about): larger values draw degrees from a heavier-tailed Zipf (typical
    row scaled to ``avg_deg`` by the median — renormalizing by the mean
    would flatten the tail) and order rows by degree, the crawl-style hub
    clustering real graph matrices exhibit — so contiguous row shards see
    genuinely skewed slice widths, the straggler scenario the cost
    partitioner exists for. Mild at ~1, extreme at 4+. Default (None)
    keeps the legacy draws bit-identical; the column/hub distribution is
    untouched either way."""

    def build(rng: np.random.Generator | None = None, *,
              seed: int = 0) -> CSRMatrix:
        rng = _resolve_rng(rng, seed)
        if skew is None:
            deg = np.minimum(
                rng.zipf(1.0 + 1.0 / alpha, size=n), 20 * avg_deg
            ).astype(np.int64)
            deg = np.maximum(
                1, (deg * (avg_deg / max(deg.mean(), 1e-9))).astype(np.int64)
            )
        else:
            s = float(skew)
            deg = rng.zipf(1.0 + 1.0 / s, size=n).astype(np.int64)
            scale = avg_deg / max(float(np.median(deg)), 1.0)
            deg = np.maximum(1, (deg * max(scale, 1.0)).astype(np.int64))
            # cap so one hub row cannot swallow the matrix, then cluster
            # hubs at the low rows (degree-ordered, crawl-style)
            deg = np.minimum(deg, max(2 * avg_deg, n // 8))
            deg = -np.sort(-deg)
        rows = np.repeat(np.arange(n), deg)
        # Hubby targets: permuted so hubs are scattered over the column space.
        ranks = (rng.pareto(alpha, size=rows.size) * n / 8).astype(np.int64) % n
        perm = rng.permutation(n)
        cols = perm[ranks]
        vals = rng.standard_normal(rows.size)
        return coo_to_csr(n, n, rows, cols, vals)

    return build


def random_uniform(n: int, nnz_per_row: int) -> Gen:
    """Uniform random columns — the coalescer's worst case."""

    def build(rng: np.random.Generator | None = None, *,
              seed: int = 0) -> CSRMatrix:
        rng = _resolve_rng(rng, seed)
        rows = np.repeat(np.arange(n), nnz_per_row)
        cols = rng.integers(0, n, size=rows.size)
        vals = rng.standard_normal(rows.size)
        return coo_to_csr(n, n, rows, cols, vals)

    return build


def block_diag(n: int, block: int, fill: float = 0.5) -> Gen:
    """Block-diagonal (FEM-like local coupling) — near-perfect coalescing."""

    def build(rng: np.random.Generator | None = None, *,
              seed: int = 0) -> CSRMatrix:
        rng = _resolve_rng(rng, seed)
        nnz_per_row = max(1, int(block * fill))
        rows = np.repeat(np.arange(n), nnz_per_row)
        base = (rows // block) * block
        cols = base + rng.integers(0, block, size=rows.size)
        cols = np.minimum(cols, n - 1)
        vals = rng.standard_normal(rows.size)
        return coo_to_csr(n, n, rows, cols, vals)

    return build


def make_spd(csr: CSRMatrix, shift: float = 1.0) -> CSRMatrix:
    """Symmetrize-and-shift an arbitrary square sparse matrix into a
    strictly diagonally dominant SPD matrix with the same sparsity flavor:
    B = (A + A^T)/2, then diag += |row sums of B| + shift. Gerschgorin puts
    every eigenvalue in (0, 2*max_diag), so CG/Jacobi are guaranteed to
    converge while the off-diagonal index stream keeps the source matrix's
    locality spectrum (what the coalescer actually sees)."""
    if csr.n_rows != csr.n_cols:
        raise ValueError(
            f"make_spd needs a square matrix, got {csr.n_rows}x{csr.n_cols}"
        )
    n = csr.n_rows
    row_of = np.repeat(np.arange(n), np.diff(csr.indptr))
    half = csr.data.astype(np.float64) / 2.0
    rows = np.concatenate([row_of, csr.indices.astype(np.int64)])
    cols = np.concatenate([csr.indices.astype(np.int64), row_of])
    vals = np.concatenate([half, half])
    absrow = np.zeros(n, dtype=np.float64)
    np.add.at(absrow, rows, np.abs(vals))
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    vals = np.concatenate([vals, absrow + shift])
    return coo_to_csr(n, n, rows, cols, vals)


def spd(n: int, half_bw: int, fill: float = 0.6) -> Gen:
    """Random SPD matrix (banded sparsity, symmetrized + diagonally
    dominant) — the test/benchmark input for CG and Jacobi."""

    def build(rng: np.random.Generator | None = None, *,
              seed: int = 0) -> CSRMatrix:
        return make_spd(banded(n, half_bw, fill)(_resolve_rng(rng, seed)))

    return build


def _suite(scale: str) -> List[MatrixSpec]:
    """Twenty matrices spanning the paper's regimes. `scale`:
    - "ci": tiny, for tests (seconds)
    - "bench": medium, default for the benchmark harness (CPU-minutes)
    - "paper": full published size range (columns 1.4k..6.8M) — slow on CPU.
    """
    f = {"ci": 0.03, "bench": 0.25, "paper": 1.0}[scale]

    def s(x: int, lo: int = 8) -> int:
        return max(lo, int(x * f))

    grid = {"ci": (8, 8, 8), "bench": (24, 24, 24), "paper": (104, 104, 104)}[scale]
    grid2 = {"ci": (6, 6, 6), "bench": (16, 16, 16), "paper": (64, 64, 64)}[scale]
    return [
        MatrixSpec("hpcg", "stencil", hpcg_stencil(*grid)),
        MatrixSpec("hpcg-small", "stencil", hpcg_stencil(*grid2)),
        MatrixSpec("af-shell10", "banded", banded(s(1_500_000), 20, 0.9)),
        MatrixSpec("bone010", "banded", banded(s(980_000), 32, 0.7)),
        MatrixSpec("audikw", "block", block_diag(s(940_000), 96, 0.8)),
        MatrixSpec("ldoor", "block", block_diag(s(950_000), 48, 0.7)),
        MatrixSpec("serena", "block", block_diag(s(1_390_000), 32, 0.7)),
        MatrixSpec("cant", "banded", banded(s(62_000), 24, 0.8)),
        MatrixSpec("consph", "block", block_diag(s(83_000), 64, 0.8)),
        MatrixSpec("pdb1HYS", "block", block_diag(s(36_000), 96, 0.6)),
        MatrixSpec("rma10", "banded", banded(s(46_000), 40, 0.5)),
        MatrixSpec("shipsec1", "block", block_diag(s(140_000), 64, 0.5)),
        MatrixSpec("pwtk", "banded", banded(s(217_000), 48, 0.5)),
        MatrixSpec("cop20k", "powerlaw", powerlaw(s(121_000), 21)),
        MatrixSpec("scircuit", "powerlaw", powerlaw(s(171_000), 6)),
        MatrixSpec("webbase-1M", "powerlaw", powerlaw(s(1_000_000), 3, 0.9)),
        MatrixSpec("wiki-talk", "powerlaw", powerlaw(s(2_390_000), 2, 0.8)),
        MatrixSpec("mac_econ", "random", random_uniform(s(206_000), 6)),
        MatrixSpec("rand-small", "random", random_uniform(s(40_000, lo=1_400), 16)),
        MatrixSpec("rand-dense", "random", random_uniform(s(16_000), 64)),
    ]


def paper_suite(scale: str = "bench", seed: int = 0) -> Dict[str, CSRMatrix]:
    """Build the twenty-matrix suite. Deterministic in `seed`."""
    out: Dict[str, CSRMatrix] = {}
    for i, spec in enumerate(_suite(scale)):
        rng = np.random.default_rng(seed * 1000 + i)
        mat = spec.gen(rng)
        mat.validate()
        out[spec.name] = mat
    return out


def suite_specs(scale: str = "bench") -> List[MatrixSpec]:
    return _suite(scale)
