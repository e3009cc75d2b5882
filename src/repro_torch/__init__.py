"""PyTorch/CUDA port of `repro` (batched SpMV through a coalesced plan).

`core` holds the formats, the matrix generators, the coalescer planner, the
perf model and the plan-once `SpMVEngine`; `kernels` the hand-written
Hopper kernels and their plain torch versions; `launch.serve` the batched
SpMV server. The package imports torch and numpy, never JAX.
"""
