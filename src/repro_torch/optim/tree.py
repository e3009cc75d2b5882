"""Parameter trees in `repro`'s leaf order.

`repro` keeps parameters, gradients and optimizer moments as JAX pytrees:
``jax.tree_util`` flattens a dict in sorted key order, and every repeating
unit is one leaf stacked on leading axes. The port holds the same values as
a `models.transformer` family module (one module per layer) or as nested
dicts and lists of tensors. This module maps one onto the other, so the
optimizer, the compressor and the checkpoint walk the port's tensors leaf by
leaf in `repro`'s order and name each leaf as `jax.tree_util.keystr` does:

  * `named_tensors(tree)`: the port's tensors by dotted name
    (``units.pos0.3.attn.wq``);
  * `leaves(tree)`: `repro`'s leaves in flatten order, each a `Leaf` with
    its keystr (``['units']['pos0']['attn']['wq']``), the names of the port
    tensors stacked into it (row-major over the stacked axes) and the
    stacked axes' sizes;
  * `map_tree(fn, tree, *others)`: a tree of `tree`'s structure (a module
    of its class, or nested dicts and lists) whose tensors are
    ``fn(t, *others_t)``, matched by name (`map_named`: ``fn(name, t)``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Tuple

import torch
from torch import nn

from repro_torch.core.interop import _stacked_paths


class Leaf(NamedTuple):
    key: str  # jax.tree_util.keystr of the leaf's path
    names: List[str]  # the port tensors stacked into it, row-major
    lead: Tuple[int, ...]  # sizes of the stacked leading axes (() if none)


def _walk(tree, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    if tree is None:
        return
    if torch.is_tensor(tree):
        out[prefix] = tree
        return
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        raise TypeError(f"cannot walk {type(tree).__name__} in a tree")
    for key, value in items:
        _walk(value, f"{prefix}.{key}" if prefix else str(key), out)


def named_tensors(tree) -> Dict[str, torch.Tensor]:
    """The tensors of a module (its parameters) or of nested dicts and lists
    (their leaves), by dotted name."""
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    out: Dict[str, torch.Tensor] = {}
    _walk(tree, "", out)
    return out


def _component(part: str):
    return int(part) if part.isdigit() else part


def keystr(path) -> str:
    """`jax.tree_util.keystr` of a path of dict keys (str) and list indices
    (int)."""
    return "".join(f"[{c!r}]" if isinstance(c, str) else f"[{c}]"
                   for c in path)


def leaves(tree, stacked=None) -> List[Leaf]:
    """`repro`'s leaves of `tree` in `jax.tree_util` flatten order. A
    family module (one with a ``cfg``) groups each stacked subtree's
    per-layer tensors into one leaf; so does `stacked` for any other tree
    (the path of each subtree `repro` stacks -> its number of stacked axes,
    as for a decode cache); without either, each tensor is a leaf."""
    names = list(named_tensors(tree))
    if stacked is None:
        cfg = getattr(tree, "cfg", None)
        stacked = (_stacked_paths(cfg, _structure(tree)) if cfg is not None
                   else {})
    groups: Dict[tuple, list] = {}
    for name in names:
        comps = tuple(_component(c) for c in name.split("."))
        path, index = comps, ()
        for prefix, levels in stacked.items():
            if comps[:len(prefix)] == prefix:
                cut = len(prefix) + levels
                path, index = prefix + comps[cut:], comps[len(prefix):cut]
                break
        groups.setdefault(path, []).append((index, name))
    out = []
    for path in sorted(groups):
        members = sorted(groups[path])
        lead = tuple(i + 1 for i in members[-1][0])
        n = 1
        for size in lead:
            n *= size
        if len(members) != n:
            raise ValueError(f"{keystr(path)}: {len(members)} tensors do not "
                             f"fill stacked axes {lead}")
        out.append(Leaf(keystr(path), [m[1] for m in members], lead))
    return out


def _map_named(fn: Callable, tree, prefix: str, others):
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return fn(tree, *(o[prefix] for o in others))
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, f"{prefix}.{k}" if prefix else k,
                              others) for k, v in tree.items()}
    return [_map_named(fn, v, f"{prefix}.{i}" if prefix else str(i), others)
            for i, v in enumerate(tree)]


def map_tree(fn: Callable, tree, *others):
    """``fn(t, *[named_tensors(o)[name] ...])`` for every tensor ``t`` of
    `tree`, in `tree`'s structure: a module becomes a module of its class
    whose tensors do not require grad."""
    named = [named_tensors(o) for o in others]
    if isinstance(tree, nn.Module):
        return tree.like(_map_named(fn, tree.to_tree(), "", named)) \
            .requires_grad_(False)
    return _map_named(fn, tree, "", named)


def map_named(fn: Callable, tree):
    """`map_tree` with ``fn(name, t)``, each tensor's dotted name beside it;
    where `fn` returns None the tree holds None."""
    names = {n: n for n in named_tensors(tree)}

    def call(t, name):
        return fn(name, t)

    if isinstance(tree, nn.Module):
        return tree.like(_map_named(call, _structure(tree), "", [names])) \
            .requires_grad_(False)
    return _map_named(call, tree, "", [names])


def _structure(module):
    """A parameter module's nested dicts and lists holding its parameters
    themselves (``to_tree`` without ``.data``: no op runs on them, so a
    module on ``meta`` maps under a fake mode)."""
    if module is None or torch.is_tensor(module):
        return module
    if hasattr(module, "keys"):
        return {k: _structure(module[k]) for k in module.keys()}
    return [_structure(m) for m in module]
