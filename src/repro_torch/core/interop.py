"""State carried between the JAX package and this one, as numpy arrays.

For this system the "weights" are the matrix and its coalescer plan, on
the serving side the paged KV cache, and the model stack's parameters and
optimizer state. These helpers rebuild them on the torch side from plain
arrays (and back), so a matrix, a `BlockSchedule`, a paged cache or a
model's parameters and AdamW moments produced by `repro` can be handed to the port's plan lowering, kernels, decode path and
models without either package importing the other.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .coalescer import BlockSchedule
from .formats import CSRMatrix
from .runtime import resolve_device

SCHEDULE_FIELDS = ("tags", "n_warps", "elem_warp", "elem_offset", "elem_valid")


def csr_from_arrays(
    n_rows: int, n_cols: int, indptr, indices, data
) -> CSRMatrix:
    """A validated `CSRMatrix` from its three arrays (copied to numpy)."""
    csr = CSRMatrix(
        n_rows=int(n_rows),
        n_cols=int(n_cols),
        indptr=np.array(indptr),
        indices=np.array(indices),
        data=np.array(data),
    )
    csr.validate()
    return csr


def schedule_from_arrays(
    arrays: Dict[str, np.ndarray], *, window: int, block_rows: int, device=None
) -> BlockSchedule:
    """A `BlockSchedule` on `device` (default: the card, see
    `runtime.resolve_device`) from a dict of numpy arrays keyed by
    `SCHEDULE_FIELDS` (e.g. the fields of a `repro` schedule, converted with
    ``np.asarray``). Integer fields become int32, `elem_valid` bool."""
    device = resolve_device(device)
    missing = [f for f in SCHEDULE_FIELDS if f not in arrays]
    if missing:
        raise ValueError(f"schedule arrays lack {missing}")
    fields = {}
    for name in SCHEDULE_FIELDS:
        dtype = torch.bool if name == "elem_valid" else torch.int32
        fields[name] = torch.as_tensor(
            np.array(arrays[name]), device=device
        ).to(dtype)
    n_windows = fields["tags"].shape[0]
    for name in ("elem_warp", "elem_offset", "elem_valid"):
        if tuple(fields[name].shape) != (n_windows, int(window)):
            raise ValueError(
                f"{name} has shape {tuple(fields[name].shape)}, expected "
                f"({n_windows}, {window})"
            )
    return BlockSchedule(
        **fields, window=int(window), block_rows=int(block_rows)
    )


def schedule_to_arrays(schedule: BlockSchedule) -> Dict[str, np.ndarray]:
    """The inverse of `schedule_from_arrays`: each field as a host array."""
    return {
        name: getattr(schedule, name).cpu().numpy() for name in SCHEDULE_FIELDS
    }


def paged_kv_from_arrays(k_pages, v_pages, page_table, lengths, block: int,
                         device=None):
    """A `models.paged_kv.PagedKV` on `device` (default: the card) from the
    four arrays of a paged cache (e.g. the fields of a `repro` cache,
    converted with ``np.asarray``): pools (n_pages, block, n_kv, hd) in
    their own dtype (torch reads no numpy bfloat16: carry such pools as
    float32 and cast the result's), the page table and the lengths as
    int32."""
    from repro_torch.models.paged_kv import PagedKV

    device = resolve_device(device)
    k = torch.as_tensor(np.array(k_pages), device=device)
    v = torch.as_tensor(np.array(v_pages), device=device)
    if k.shape != v.shape or k.dim() != 4 or k.shape[1] != int(block):
        raise ValueError(
            f"k/v pools must share a (n_pages, block={block}, n_kv, hd) "
            f"shape, got {tuple(k.shape)} and {tuple(v.shape)}"
        )
    table = torch.as_tensor(np.array(page_table), device=device).to(
        torch.int32)
    lens = torch.as_tensor(np.array(lengths), device=device).to(torch.int32)
    if table.dim() != 2 or tuple(lens.shape) != (table.shape[0],):
        raise ValueError(
            f"page table must be (B, max_pages) and lengths (B,), got "
            f"{tuple(table.shape)} and {tuple(lens.shape)}"
        )
    return PagedKV(k_pages=k, v_pages=v, page_table=table, lengths=lens,
                   block=int(block))


# The parameter subtrees `repro` stacks on leading axes (`_stack_init`), by
# family: the number of stacked axes of each (zamba2's and xlstm's units
# stack twice: units x layers of a unit). The decoder's are every
# ``units/pos{j}``.
_STACKED = {
    "hybrid": {"mamba_units": 2, "mamba_tail": 1},
    "ssm": {"mlstm": 2, "slstm": 1},
    "audio": {"enc": 1, "dec": 1},
    "vlm": {"self_units": 2, "cross": 1},
}


def _stacked_paths(cfg, tree) -> Dict[Tuple[str, ...], int]:
    if cfg.family in ("dense", "moe"):
        return {("units", name): 1 for name in tree["units"]}
    return {(key,): n for key, n in _STACKED[cfg.family].items()
            if tree.get(key) is not None}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return tree if tree is None or _is_row(tree) else fn(tree)


def _is_row(value) -> bool:
    from repro_torch.optim.tree import Row

    return isinstance(value, Row)


def _first_leaf(tree):
    while isinstance(tree, (dict, list)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return tree


def _unstack(tree, levels: int):
    """A tree stacked on `levels` leading axes -> nested lists of trees."""
    if levels == 0:
        return tree
    n = _first_leaf(tree).shape[0]
    return [_unstack(_tree_map(lambda a, i=i: a[i], tree), levels - 1)
            for i in range(n)]


def _stack_trees(trees):
    """Trees of one structure -> one tree of their leaves stacked (numpy)."""
    head = trees[0]
    if isinstance(head, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in head}
    if isinstance(head, list):
        return [_stack_trees([t[i] for t in trees]) for i in range(len(head))]
    return np.stack(trees)


def _restack(items, levels: int):
    """The inverse of `_unstack` (on numpy leaves)."""
    if levels == 0:
        return items
    return _stack_trees([_restack(t, levels - 1) for t in items])


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _with(tree, path, value):
    """A shallow copy of `tree` (dicts, lists) with the subtree at `path`
    replaced."""
    out = list(tree) if isinstance(tree, list) else dict(tree)
    if len(path) == 1:
        out[path[0]] = value
    else:
        out[path[0]] = _with(tree[path[0]], path[1:], value)
    return out


def _row_path(prefixes, path: tuple, i: int) -> tuple:
    """Where layer `i`'s tensor of the stacked leaf at `path` sits in the
    unstacked tree (one stacked axis after its subtree's path)."""
    for prefix in prefixes:
        if path[:len(prefix)] == prefix:
            return path[:len(prefix)] + (i,) + path[len(prefix):]
    raise ValueError(f"{path} lies in no stacked subtree")


def _tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits
        bits = torch.from_numpy(np.array(a).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.as_tensor(np.array(a), device=device)


def _tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    from repro_torch.sharding.dtensor import full

    t = full(t.detach()).cpu()  # a DTensor gathered: every rank calls this
    if t.dtype == torch.bfloat16:
        try:
            import ml_dtypes
        except ImportError:  # numpy alone has no bfloat16: widen (lossless)
            return t.float().numpy()
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def model_params_from_numpy(cfg, tree, device=None, shardings=None):
    """The port's model module for `cfg` (a `models.transformer` family,
    on `device`, default the card) holding the values of `repro`'s
    parameter pytree `tree` given as numpy (``jax.tree.map(np.asarray,
    params)``). Every subtree `repro` stacks on leading axes is unstacked
    into one module per layer: the decoder's ``units/pos{j}[u]``, zamba2's
    ``mamba_units[u][i]``, ``mamba_tail[i]`` and its one ``shared`` block,
    xlstm's ``mlstm[u][i]`` and ``slstm[u]``, whisper's ``enc[i]`` and
    ``dec[i]``, the VLM's ``self_units[u][i]`` and ``cross[u]``. numpy
    bfloat16 leaves (ml_dtypes) arrive as torch bfloat16, bit for bit.
    `shardings` ({port tensor name: `sharding.rules.Sharding`}) places the
    parameters on a process mesh as DTensors (every rank passes the same
    `tree` and keeps its shards, cut on the host: only they reach
    `device`). A leaf `shardings` names as ``stacked.<keystr>`` (FSDP's
    stacked parameter, `optim.tree.stack_leaves`) is carried across as it
    is, one tensor of `repro`'s stacked shape, each layer's entry a `Row`
    of it."""
    from repro_torch.models.transformer import FAMILY_CLASSES
    from repro_torch.optim.tree import STACKED, Row, _key_path
    from repro_torch.sharding.dtensor import distribute_module

    device = resolve_device(device)
    keep = sorted(n.split(".", 1)[1] for n in shardings or ()
                  if n.startswith(STACKED + "."))
    stacks = {key: _at(tree, _key_path(key)) for key in keep}
    prefixes = _stacked_paths(cfg, tree)
    for path, levels in prefixes.items():
        tree = _with(tree, path, _unstack(_at(tree, path), levels))
    for key, arr in stacks.items():
        for i in range(arr.shape[0]):  # the stacked leaf: one axis
            tree = _with(tree, _row_path(prefixes, _key_path(key), i),
                         Row(key, i))
    at = device if shardings is None else torch.device("cpu")
    tensors = _tree_map(lambda a: _tensor_from_numpy(a, at), tree)
    if stacks:
        tensors[STACKED] = {k: _tensor_from_numpy(a, at)
                            for k, a in stacks.items()}
    module = FAMILY_CLASSES[cfg.family](cfg, tensors)
    return module if shardings is None else distribute_module(
        module, shardings, device=device)


def model_params_to_numpy(cfg, module):
    """The inverse of `model_params_from_numpy`: `repro`'s pytree layout
    (stacked subtrees restacked) with numpy leaves; bfloat16 leaves as
    ml_dtypes' bfloat16 where it is installed, else widened to float32.
    DTensors are gathered: on a process mesh every rank calls this. A
    stacked parameter (`optim.tree.stack_leaves`) is its leaf as it is."""
    from repro_torch.optim.tree import STACKED, _key_path

    tree = _tree_map(_tensor_to_numpy, module.to_tree())
    stacks = tree.pop(STACKED, None) or {}
    prefixes = _stacked_paths(cfg, tree)
    for key, arr in stacks.items():  # each layer's row, restacked below
        for i in range(arr.shape[0]):
            tree = _with(tree, _row_path(prefixes, _key_path(key), i),
                         arr[i])
    for path, levels in prefixes.items():
        tree = _with(tree, path, _restack(_at(tree, path), levels))
    return tree


def opt_state_from_numpy(cfg, state, device=None, shardings=None):
    """The port's `optim.optimizer.OptState` for `cfg`'s model from
    `repro`'s ``OptState(mu, nu, step)`` given as numpy
    (``jax.tree.map(np.asarray, state)``): `mu` and `nu` in `repro`'s
    stacked layout become modules of the family's class (as
    `model_params_from_numpy`, placed on `shardings` when given), `step` an
    int32 scalar, on `device`."""
    from repro_torch.optim.optimizer import OptState

    device = resolve_device(device)
    mu, nu, step = state
    return OptState(
        mu=model_params_from_numpy(cfg, mu, device, shardings)
        .requires_grad_(False),
        nu=model_params_from_numpy(cfg, nu, device, shardings)
        .requires_grad_(False),
        step=torch.as_tensor(np.array(step), device=device).to(torch.int32),
    )


def opt_state_to_numpy(cfg, state):
    """The inverse of `opt_state_from_numpy`: `repro`'s OptState fields
    ``(mu, nu, step)`` as numpy, `mu` and `nu` restacked (DTensors
    gathered)."""
    return (model_params_to_numpy(cfg, state.mu),
            model_params_to_numpy(cfg, state.nu),
            state.step.detach().cpu().numpy())
