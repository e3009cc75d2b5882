"""The yardstick's arithmetic: the card's published peaks and the work a
SpMV or SpMM needs, counted from the CSR the benchmark made (not from the
program's plan, so padding shows as lost time).

Work counted (float32 values, int32 column indices):
  SpMV  bytes = nnz * (4 + 4) + n_cols * 4 (x read once) + n_rows * 4 (y
        written once); FLOPs = 2 * nnz.
  SpMM  bytes = nnz * (4 + 4) + n_cols * k * 4 + n_rows * k * 4;
        FLOPs = 2 * nnz * k.
"""
from __future__ import annotations

from typing import Optional

VALUE_BYTES = 4
INDEX_BYTES = 4
VECTOR_BYTES = 4

#: Published peaks (NVIDIA's data sheet, SXM part, dense, at 700 W):
#: HBM bytes/s and float32 FLOP/s outside the tensor cores.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "f32_flops_per_s": 67e12},
}


def peaks(device_kind: str) -> Optional[dict]:
    """The peaks of a card by `torch.cuda.get_device_name()`, or None."""
    return PEAKS.get(device_kind)


def spmv_bytes(nnz: int, n_rows: int, n_cols: int) -> int:
    return nnz * (VALUE_BYTES + INDEX_BYTES) + (n_rows + n_cols) * VECTOR_BYTES


def spmv_flops(nnz: int) -> int:
    return 2 * nnz


def spmm_bytes(nnz: int, n_rows: int, n_cols: int, k: int) -> int:
    return (nnz * (VALUE_BYTES + INDEX_BYTES)
            + (n_rows + n_cols) * k * VECTOR_BYTES)


def spmm_flops(nnz: int, k: int) -> int:
    return 2 * nnz * k


def least_seconds(nbytes: float, flops: float, device_kind: str
                  ) -> Optional[float]:
    """The least time the card could take: the larger of the bytes over
    its HBM bandwidth and the FLOPs over its float32 peak."""
    p = peaks(device_kind)
    if p is None:
        return None
    return max(nbytes / p["hbm_bytes_per_s"], flops / p["f32_flops_per_s"])


def hbm_share(nbytes: float, seconds: float, device_kind: str
              ) -> Optional[float]:
    """Percent of the card's HBM bandwidth that `nbytes` in `seconds` is."""
    p = peaks(device_kind)
    if p is None or seconds <= 0:
        return None
    return 100.0 * nbytes / seconds / p["hbm_bytes_per_s"]
