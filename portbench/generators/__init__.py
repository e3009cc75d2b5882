"""Frozen copies of the public benchmarks' matrix generators, in plain torch.

Each generator's `build` takes its configuration's parameters and a device,
and returns the matrix as host CSR arrays ``(n, indptr, indices, data)``
(int64, int32, float64), which both the program and the reference are
handed. They import nothing of the port.
"""
