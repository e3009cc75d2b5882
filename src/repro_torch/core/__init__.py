"""Core library of the port: formats, generators, coalescer planner, perf
model and the batched SpMV engine."""
