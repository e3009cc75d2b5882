"""Hand-written CUDA kernels for Hopper (sm_90a) with their plain torch
versions: `sell_spmv` (matvec) and `sell_spmm` (fused matmat) over a
coalesced `DevicePlan`. Sources live in `csrc/`, built on first use by
`_build`."""
