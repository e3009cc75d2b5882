"""Device meshes for the sharded SpMV engine (port of `repro.launch.mesh`).

A mesh is a `core.runtime.DeviceMesh`: a 2-D numpy object array of
`torch.device`s, its axes ``data`` and ``model``. On the card the grid takes
distinct ``cuda:i`` and cannot pass `torch.cuda.device_count()`, as the JAX
package's cannot pass `jax.devices()`. With ``device="cpu"`` a grid of any
size repeats the CPU: the counterpart of
``--xla_force_host_platform_device_count``, with which the JAX package
exercises its meshes on a host. The production TPU pod mesh
(`make_production_mesh`) is not ported.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.core.runtime import DeviceMesh, resolve_device

__all__ = ["auto_spmv_mesh", "make_host_mesh", "parse_mesh_spec"]


def _devices(device=None) -> List[torch.device]:
    """The visible devices of the requested kind: every card unless the
    caller asks for the CPU, then the one CPU."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _grid(devices: List[torch.device], data: int, model: int) -> DeviceMesh:
    grid = np.empty(data * model, dtype=object)
    grid[:] = devices[: data * model]
    return DeviceMesh(grid.reshape(data, model))


def make_host_mesh(model_axis: int = 1, *, device=None) -> DeviceMesh:
    """Mesh over every visible device of the requested kind, `model_axis`
    of them along ``model``."""
    devices = _devices(device)
    n = len(devices)
    if model_axis < 1 or n % model_axis:
        raise ValueError(
            f"{n} devices do not split into a model axis of {model_axis}"
        )
    return _grid(devices, n // model_axis, model_axis)


def auto_spmv_mesh(*, device=None) -> DeviceMesh:
    """Auto-factored mesh for the sharded SpMV engine: the model axis gets 2
    when the device count allows (so both axes are exercised), the data
    axis the rest (8 cards -> (data=4, model=2); 1 -> (1, 1)). The one
    source of the factoring rule — `ShardedSpMVEngine`'s default mesh and
    ``serve --mesh data,model`` both resolve here."""
    n = len(_devices(device))
    return make_host_mesh(model_axis=2 if n > 1 and n % 2 == 0 else 1,
                          device=device)


def parse_mesh_spec(spec: str, *, device=None) -> DeviceMesh:
    """Mesh from a CLI spec for the sharded SpMV path.

    Two forms:
      * ``"data,model"`` (axis *names*) — auto-factor all visible devices
        via `auto_spmv_mesh`.
      * ``"4,2"`` / ``"4x2"`` (axis *sizes*) — explicit (data, model) shape;
        on the card it raises if more cards are requested than exist (fewer
        is fine: the mesh takes a prefix of them); on the CPU any size
        repeats the CPU.
    """
    parts = [p.strip() for p in spec.replace("x", ",").split(",")
             if p.strip()]
    if parts == ["data", "model"]:
        return auto_spmv_mesh(device=device)
    try:
        sizes = [int(p) for p in parts]
    except ValueError:
        raise ValueError(
            f"--mesh expects 'data,model' or explicit sizes like '4,2', "
            f"got {spec!r}"
        )
    if len(sizes) != 2 or any(s < 1 for s in sizes):
        raise ValueError(
            f"--mesh sizes must be two positive ints (data, model), "
            f"got {spec!r}"
        )
    d, m = sizes
    devices = _devices(device)
    if devices[0].type == "cpu":
        devices = devices * (d * m)
    if d * m > len(devices):
        raise ValueError(
            f"--mesh {d},{m} needs {d * m} devices but only "
            f"{len(devices)} exist (pass device='cpu' for a grid of any "
            f"size on the CPU)"
        )
    return _grid(devices, d, m)
