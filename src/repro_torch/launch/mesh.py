"""Meshes (port of `repro.launch.mesh`).

Two kinds:

  * Device grids for the sharded SpMV engine: a `core.runtime.DeviceMesh`,
    a 2-D numpy object array of `torch.device`s, its axes ``data`` and
    ``model``, driven from one process. On the card the grid takes
    distinct ``cuda:i`` and cannot pass `torch.cuda.device_count()`, as the
    JAX package's cannot pass `jax.devices()`. With ``device="cpu"`` a grid
    of any size repeats the CPU: the counterpart of
    ``--xla_force_host_platform_device_count``, with which the JAX package
    exercises its meshes on a host.
  * Process meshes for the sharded training step: a
    ``torch.distributed`` ``DeviceMesh`` with named dims over the ranks of
    the process group, one rank per card (NCCL) or per CPU process (gloo).
    `make_process_mesh` builds the (data, model) mesh,
    `make_production_mesh` `repro`'s 256- and 512-rank shapes, and
    `run_grid` starts N ranks on this host (the CPU tests and
    ``chip_smoke.py`` hold the grid to a reference with it).
"""
from __future__ import annotations

import os
import queue
import socket
import traceback
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.runtime import DeviceMesh, resolve_device

__all__ = ["auto_spmv_mesh", "make_host_mesh", "make_process_mesh",
           "make_production_mesh", "parse_mesh_spec", "run_grid"]


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


# ---------------------------------------------------------------------------
# Process meshes (the sharded training step)
# ---------------------------------------------------------------------------


def free_port() -> int:
    """A free TCP port on 127.0.0.1 (bound to 0 and released: concurrent
    test workers each get their own)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _backend(device) -> str:
    return "gloo" if resolve_device(device).type == "cpu" else "nccl"


def init_process_group(world: int, *, device=None) -> None:
    """Initialize the default process group for `world` ranks if it is not
    yet: from the environment ``torch.distributed.run`` sets, or, for one
    rank alone, on a free port of 127.0.0.1. NCCL on the card (each rank
    takes card ``LOCAL_RANK`` as its current device), gloo with
    ``device="cpu"``.

    An NCCL group is started with asynchronous error handling off
    (``TORCH_NCCL_ASYNC_ERROR_HANDLING=0`` unless the environment sets it),
    as PyTorch's CUDA-graph notes ask where collectives are captured:
    `train` captures the sharded update, and a captured collective runs at
    each replay outside the watchdog's view, so its handler must not tear
    the communicators down under the graph. Communicators are made at each
    group's first collective (no ``device_id``): the update's eager
    warm-up makes every one its capture uses."""
    import torch.distributed as dist

    backend = _backend(device)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if dist.is_initialized():
        return
    if backend == "nccl":
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    elif world == 1:
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
            world_size=1)
    else:
        raise RuntimeError(
            f"a mesh of {world} ranks needs {world} processes: start them "
            f"with python -m torch.distributed.run --nproc-per-node "
            f"{world}, or launch.mesh.run_grid")


def _mesh(shape, names, device):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = int(np.prod(shape))
    init_process_group(world, device=device)
    if dist.get_world_size() != world:
        raise ValueError(
            f"a {'x'.join(map(str, shape))} mesh needs {world} ranks; the "
            f"process group has {dist.get_world_size()}")
    kind = "cpu" if _backend(device) == "gloo" else "cuda"
    return init_device_mesh(kind, tuple(shape), mesh_dim_names=names)


def make_process_mesh(data: int, model: int, *, device=None):
    """The named ``("data", "model")`` ``DeviceMesh`` over the process
    group (initialized here if it is not yet, see `init_process_group`):
    NCCL on the card, gloo with ``device="cpu"``. Raises when the world
    size is not ``data * model``."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh sizes must be positive, got {data}x{model}")
    return _mesh((data, model), ("data", "model"), device)


def make_production_mesh(multi_pod: bool = False, *, device=None):
    """`repro`'s production shapes as a process mesh: single pod (data=16,
    model=16) = 256 ranks; multi-pod (pod=2, data=16, model=16) = 512, the
    'pod' axis carrying cross-pod data parallelism. Raises unless the world
    has that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, names, device)


def _rank_main(rank: int, world: int, port: int, device: str,
               target: Callable, args: tuple, results) -> None:
    import torch.distributed as dist

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    try:
        if device == "cpu":
            torch.set_num_threads(1)
        init_process_group(world, device=device)
        out = target(*args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_grid(target: Callable, world: int, args: Sequence[Any] = (), *,
             device: str = "cpu", timeout: float = 600.0) -> List[Any]:
    """Start `world` ranks on this host (spawned processes, the process
    group on ``tcp://127.0.0.1:<free port>``; gloo and one thread each with
    ``device="cpu"``, NCCL on the card), call ``target(*args)`` in each and
    return the results by rank. `target` must be importable by a spawned
    process (a function of this package) and return picklable values
    (numpy arrays). A rank that raises, or a grid that runs past `timeout`
    seconds, stops every rank and raises RuntimeError with the rank's
    traceback."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, port, device, target, tuple(args),
                               results))
             for r in range(world)]
    for p in procs:
        p.start()
    out: List[Optional[Any]] = [None] * world
    try:
        for _ in range(world):
            try:
                rank, ok, value = results.get(timeout=timeout)
            except queue.Empty:
                raise RuntimeError(f"a grid of {world} ranks ran past "
                                   f"{timeout} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                   f"{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return out
