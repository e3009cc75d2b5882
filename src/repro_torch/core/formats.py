"""Sparse matrix storage formats: CSR and sliced ELLPACK (SELL).

Mirrors the paper's data layout choices (Sec. III): 32-bit indices, 64-bit
nonzeros/metadata, 32 rows per SELL slice. Host-side construction uses numpy
(this is offline preprocessing, like the paper's format conversion); device
consumers receive plain arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

INDEX_DTYPE = np.int32
VALUE_DTYPE = np.float64  # paper uses 64 b nonzeros; kernels also support f32/bf16
SLICE_HEIGHT = 32  # paper: "32 rows per slice in SELL format"


@dataclasses.dataclass
class CSRMatrix:
    """Compressed sparse row."""

    n_rows: int
    n_cols: int
    indptr: np.ndarray  # (n_rows + 1,) int32/int64 offsets into indices/data
    indices: np.ndarray  # (nnz,) int32 column ids
    data: np.ndarray  # (nnz,) values

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def validate(self) -> None:
        assert self.indptr.shape == (self.n_rows + 1,)
        assert self.indptr[0] == 0 and self.indptr[-1] == self.nnz
        assert np.all(np.diff(self.indptr) >= 0)
        if self.nnz:
            assert self.indices.min() >= 0 and self.indices.max() < self.n_cols
        assert self.data.shape == self.indices.shape

    def todense(self) -> np.ndarray:
        out = np.zeros((self.n_rows, self.n_cols), dtype=self.data.dtype)
        for r in range(self.n_rows):
            lo, hi = self.indptr[r], self.indptr[r + 1]
            np.add.at(out[r], self.indices[lo:hi], self.data[lo:hi])
        return out


@dataclasses.dataclass
class SELLMatrix:
    """Sliced ELLPACK (SELL-C with C = slice_height, no sigma-sorting by default).

    Each slice of `slice_height` consecutive rows is padded to the slice's max
    row length (its *width*). Storage within a slice is column-major
    ``(width, slice_height)`` so that one "SELL column" is a contiguous vector
    of `slice_height` lanes — the unit the paper's VPC consumes per VMAC.
    Padded entries carry column 0 and value 0 (safe for SpMV).
    """

    n_rows: int
    n_cols: int
    slice_height: int
    slice_ptrs: np.ndarray  # (n_slices + 1,) int64 element offsets into colidx/values
    slice_widths: np.ndarray  # (n_slices,) int32 per-slice width
    colidx: np.ndarray  # (total_padded,) int32, column-major per slice
    values: np.ndarray  # (total_padded,) values

    @property
    def n_slices(self) -> int:
        return int(self.slice_widths.shape[0])

    @property
    def nnz_padded(self) -> int:
        return int(self.colidx.shape[0])

    def validate(self) -> None:
        ns = self.n_slices
        assert self.slice_ptrs.shape == (ns + 1,)
        assert self.slice_ptrs[0] == 0
        expected = self.slice_widths.astype(np.int64) * self.slice_height
        assert np.array_equal(np.diff(self.slice_ptrs), expected)
        assert self.slice_ptrs[-1] == self.nnz_padded
        if self.nnz_padded:
            assert self.colidx.min() >= 0 and self.colidx.max() < self.n_cols

    def slice_arrays(self, s: int) -> Tuple[np.ndarray, np.ndarray]:
        """Return (colidx, values) of slice s, each shaped (width, slice_height)."""
        lo, hi = int(self.slice_ptrs[s]), int(self.slice_ptrs[s + 1])
        w = int(self.slice_widths[s])
        return (
            self.colidx[lo:hi].reshape(w, self.slice_height),
            self.values[lo:hi].reshape(w, self.slice_height),
        )


def dense_to_csr(dense: np.ndarray) -> CSRMatrix:
    n_rows, n_cols = dense.shape
    rows, cols = np.nonzero(dense)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    return CSRMatrix(
        n_rows=n_rows,
        n_cols=n_cols,
        indptr=indptr,
        indices=cols.astype(INDEX_DTYPE),
        data=dense[rows, cols],
    )


def coo_to_csr(
    n_rows: int, n_cols: int, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray
) -> CSRMatrix:
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    # Deduplicate (sum) repeated coordinates.
    if rows.size:
        key_same = (rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1])
        if key_same.any():
            group = np.concatenate([[0], np.cumsum(~key_same)])
            n_groups = int(group[-1]) + 1
            new_rows = np.zeros(n_groups, dtype=rows.dtype)
            new_cols = np.zeros(n_groups, dtype=cols.dtype)
            new_vals = np.zeros(n_groups, dtype=vals.dtype)
            new_rows[group] = rows
            new_cols[group] = cols
            np.add.at(new_vals, group, vals)
            rows, cols, vals = new_rows, new_cols, new_vals
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    return CSRMatrix(
        n_rows=n_rows,
        n_cols=n_cols,
        indptr=indptr,
        indices=cols.astype(INDEX_DTYPE),
        data=vals,
    )


def csr_to_sell(
    csr: CSRMatrix, slice_height: int = SLICE_HEIGHT, width_multiple: int = 1
) -> SELLMatrix:
    """Convert CSR to SELL (vectorized; handles 10^8-nnz matrices).
    `width_multiple` rounds slice widths up (kernel tiling)."""
    H = slice_height
    n_slices = (csr.n_rows + H - 1) // H
    row_len = np.diff(csr.indptr).astype(np.int64)
    row_len_pad = np.zeros(n_slices * H, dtype=np.int64)
    row_len_pad[: csr.n_rows] = row_len
    widths64 = row_len_pad.reshape(n_slices, H).max(axis=1)
    widths64 = np.maximum(
        ((widths64 + width_multiple - 1) // width_multiple) * width_multiple,
        width_multiple,
    )
    widths = widths64.astype(INDEX_DTYPE)
    slice_ptrs = np.zeros(n_slices + 1, dtype=np.int64)
    slice_ptrs[1:] = np.cumsum(widths64 * H)
    colidx = np.zeros(int(slice_ptrs[-1]), dtype=INDEX_DTYPE)
    values = np.zeros(int(slice_ptrs[-1]), dtype=csr.data.dtype)
    if csr.nnz:
        # destination of each nnz: slice_ptr[s] + j * H + r_local, where j is
        # the nnz's rank within its row (column-major within the slice).
        row_of_nnz = np.repeat(np.arange(csr.n_rows, dtype=np.int64), row_len)
        j = np.arange(csr.nnz, dtype=np.int64) - csr.indptr[row_of_nnz]
        s = row_of_nnz // H
        r_local = row_of_nnz % H
        dst = slice_ptrs[s] + j * H + r_local
        colidx[dst] = csr.indices
        values[dst] = csr.data
    out = SELLMatrix(
        n_rows=csr.n_rows,
        n_cols=csr.n_cols,
        slice_height=slice_height,
        slice_ptrs=slice_ptrs,
        slice_widths=widths,
        colidx=colidx,
        values=values,
    )
    out.validate()
    return out


def sell_index_stream(sell: SELLMatrix) -> np.ndarray:
    """The indirect index stream the adapter sees for a SELL SpMV (paper Fig. 1 BL):
    column indices in storage order (slice-by-slice, column-major)."""
    return sell.colidx


def csr_index_stream(csr: CSRMatrix) -> np.ndarray:
    """Indirect index stream for CSR SpMV: column indices in row-major nnz order."""
    return csr.indices
