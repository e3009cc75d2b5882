"""Hand-written CUDA kernels for Hopper (sm_90a) with their plain torch
versions: `sell_spmv` (matvec), `sell_spmm` (fused matmat) and
`coalesced_gather` (row gather) over a coalesced `DevicePlan`. Sources live
in `csrc/`, built on first use by `_build`."""
