"""Fault-tolerant checkpointing in `repro`'s layout (port of
`repro.train.checkpoint`).

Layout: <dir>/step_<N>/ with one .npy per `repro` leaf + manifest.json
(names, shapes, dtypes, step, completeness marker). Writes go to a temp dir
and are atomically renamed, so a crash mid-save never corrupts the latest
checkpoint; `restore_latest` skips incomplete directories and `keep` bounds
how many stay.

Leaves are named and ordered as `repro` names its tree
(`jax.tree_util.keystr`: ``['params']['units']['pos0']['attn']['wq']``,
``['opt'].mu[...]``, ``['opt'].step``), and a stacked subtree is one leaf
with the layers restacked on its leading axes (`optim.tree.leaves`), so a
directory written by either package has the same files. A bfloat16 leaf is
written as `repro` writes it (numpy has no bfloat16: ml_dtypes' arrays save
with descr ``'<V2'``, the manifest says ``"bfloat16"``) and read back by the
manifest's dtype as bits, without ml_dtypes.

`restore_latest` copies the stored values into the tensors of the tree it
is given (in place: a full-width model is not held twice) and returns it.

On a process mesh (DTensor leaves) the files are the same, unsharded: a
save gathers every leaf on every rank (``full_tensor()`` is a collective),
rank 0 writes and the other ranks wait at a barrier until the files are
complete. Every rank restores from the files: a DTensor takes its own
shard, and `shardings` re-places the tree's module tensors first, so a
checkpoint saved on one mesh restores on any other or on one device (the
elastic re-shard).
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch.optim.tree import leaves, named_tensors
from repro_torch.sharding.dtensor import distribute_module, full, \
    is_dtensor, local_chunk

MANIFEST = "manifest.json"
BF16_DESCR = "<V2"  # what np.save writes for ml_dtypes' bfloat16


def _flatten(tree, prefix: str = "") -> List[Tuple[str, list, tuple]]:
    """(keystr, tensors, stacked axes) of every `repro` leaf of `tree`, in
    `jax.tree_util` order: dicts by sorted key, NamedTuples by field, lists
    by index, a module by `optim.tree.leaves`."""
    if tree is None:
        return []
    if torch.is_tensor(tree):
        return [(prefix, [tree], ())]
    if isinstance(tree, nn.Module):
        named = named_tensors(tree)
        return [(prefix + leaf.key, [named[n] for n in leaf.names], leaf.lead)
                for leaf in leaves(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [e for f in tree._fields
                for e in _flatten(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, dict):
        return [e for k in sorted(tree)
                for e in _flatten(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [e for i, v in enumerate(tree)
                for e in _flatten(v, f"{prefix}[{i}]")]
    raise TypeError(f"cannot checkpoint a {type(tree).__name__} leaf")


def _host(tensors: list, lead: tuple, keep: bool = True
          ) -> Tuple[np.ndarray, str]:
    """One leaf on the host, stacked, with its manifest dtype; bfloat16 as
    its bits. A DTensor is gathered (a collective); with ``keep=False``
    the gathered tensor is dropped on the device and nothing is
    returned (a rank that does not write)."""
    parts = []
    for t in tensors:
        t = full(t.detach())
        if not keep:
            continue
        t = t.cpu()
        parts.append(t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
                     else t.numpy())
    if not keep:
        return None, None
    arr = parts[0] if not lead else np.stack(parts).reshape(
        lead + parts[0].shape)
    name = "bfloat16" if tensors[0].dtype == torch.bfloat16 \
        else str(arr.dtype)
    return arr, name


def _snapshot(tree) -> Tuple[List[Tuple[str, np.ndarray, str]], bool]:
    """(name, host array, manifest dtype) of every leaf: what a save
    writes, copied off the device now (None on a rank that does not
    write); and whether the tree lies on a process mesh (its DTensors
    gathered on every rank, one leaf at a time)."""
    flat = _flatten(tree)
    grid = any(is_dtensor(t) for _, ts, _ in flat for t in ts)
    keep = _writes(grid)
    host = [(name, *_host(ts, lead, keep)) for name, ts, lead in flat]
    return (host if keep else None), grid


def _writes(grid: bool) -> bool:
    """Whether this process writes a save: every process on one device,
    rank 0 of a process mesh."""
    return not grid or dist.get_rank() == 0


def _save_leaf(path: pathlib.Path, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _write(directory: pathlib.Path, step: int, host, keep: int
           ) -> pathlib.Path:
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    entries = []
    for i, (name, arr, dtype) in enumerate(host):
        fname = f"leaf_{i:05d}.npy"
        _save_leaf(tmp / fname, arr, dtype)
        entries.append({"name": name, "file": fname,
                        "shape": list(arr.shape), "dtype": dtype})
    (tmp / MANIFEST).write_text(
        json.dumps({"step": step, "leaves": entries, "complete": True})
    )
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic on POSIX
    _gc(directory, keep)
    return final


def save_checkpoint(
    directory: str | pathlib.Path, step: int, tree: Any, *, keep: int = 3
) -> pathlib.Path:
    """Atomic synchronous save. Copies device tensors to the host. On a
    process mesh every rank calls it; rank 0 writes, and every rank returns
    once the files are complete."""
    host, grid = _snapshot(tree)
    final = pathlib.Path(directory) / f"step_{step:08d}"
    if _writes(grid):
        final = _write(pathlib.Path(directory), step, host, keep)
    if grid:
        dist.barrier()
    return final


def _gc(directory: pathlib.Path, keep: int) -> None:
    ckpts = sorted(directory.glob("step_*"))
    for old in ckpts[:-keep]:
        shutil.rmtree(old, ignore_errors=True)


def list_checkpoints(directory: str | pathlib.Path):
    directory = pathlib.Path(directory)
    out = []
    for d in sorted(directory.glob("step_*")):
        mf = d / MANIFEST
        if not mf.exists():
            continue
        try:
            manifest = json.loads(mf.read_text())
        except json.JSONDecodeError:
            continue
        if manifest.get("complete"):
            out.append((manifest["step"], d))
    return out


def _load_leaf(path: pathlib.Path, dtype: str) -> torch.Tensor:
    """One stored leaf as a CPU tensor, read by its manifest dtype."""
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(arr)


def _modules(tree):
    """The modules of a state tree (parameters, moments)."""
    if isinstance(tree, nn.Module):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _modules(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _modules(v)


@torch.no_grad()
def restore_latest(
    directory: str | pathlib.Path, tree_like: Any, *, shardings=None
) -> Optional[Tuple[int, Any]]:
    """Copy the newest complete checkpoint into `tree_like`'s tensors (same
    names, shapes and dtypes, else ValueError): a DTensor takes its own
    shard of each stored leaf. `shardings` ({port tensor name:
    `sharding.rules.Sharding`}, e.g. `fault_tolerance.remesh_shardings` on
    the current mesh) first re-places every module of `tree_like`
    (parameters, moments: they share names) onto a process mesh, each
    rank allocating only its shards (the modules' tensors may then lie on
    ``meta``: only their shapes and dtypes are read); tensors outside
    modules (the optimizer step) stay as they are. Returns (step,
    tree_like) or None."""
    ckpts = list_checkpoints(directory)
    if not ckpts:
        return None
    if shardings is not None:
        for module in _modules(tree_like):
            distribute_module(module, shardings, values=False)
    step, d = ckpts[-1]
    manifest = json.loads((d / MANIFEST).read_text())
    flat = _flatten(tree_like)
    names = [name for name, _, _ in flat]
    by_name = {e["name"]: e for e in manifest["leaves"]}
    if set(names) != set(by_name):
        raise ValueError(
            "checkpoint/model structure mismatch: "
            f"missing={sorted(set(names) - set(by_name))[:5]} "
            f"extra={sorted(set(by_name) - set(names))[:5]}"
        )
    for name, tensors, lead in flat:
        entry = by_name[name]
        src = _load_leaf(d / entry["file"], entry["dtype"])
        expect = tuple(lead) + tuple(tensors[0].shape)
        if tuple(src.shape) != expect:
            raise ValueError(
                f"shape mismatch for {name}: {tuple(src.shape)} vs {expect}")
        if src.dtype != tensors[0].dtype:
            raise ValueError(
                f"dtype mismatch for {name}: {entry['dtype']} stored, "
                f"{tensors[0].dtype} in the tree")
        parts = src.reshape((-1,) + tuple(tensors[0].shape))
        for t, part in zip(tensors, parts):
            if is_dtensor(t):
                t.to_local().copy_(local_chunk(part, t.device_mesh,
                                               t.placements))
            else:
                t.copy_(part)
    return step, tree_like


class AsyncCheckpointer:
    """Non-blocking saves on a worker thread; at most one in flight (a new
    request waits for the previous: bounded memory). On a process mesh
    every rank calls `save` and `wait`; rank 0 writes, and `wait` holds
    every rank at a barrier until the files are complete."""

    def __init__(self, directory: str | pathlib.Path, keep: int = 3):
        self.directory = pathlib.Path(directory)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._grid = False

    def save(self, step: int, tree: Any) -> None:
        self.wait()
        # Snapshot to the host NOW (the tensors are updated in place next
        # step)
        host, self._grid = _snapshot(tree)
        if not _writes(self._grid):
            return

        def work():
            try:
                _write(self.directory, step, host, self.keep)
            except BaseException as e:  # surfaced on wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._grid:
            self._grid = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err
