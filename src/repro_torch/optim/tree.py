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
    ``fn(t, *others_t)``, matched by name (`map_named`: ``fn(name, t)``);
  * `stack_leaves(module, keys)`: a family module with some of `repro`'s
    leaves held as `repro` holds them, one stacked tensor a leaf under
    ``stacked[keystr]`` (named ``stacked.<keystr>``), each layer's entry a
    `Row` of it (FSDP where no per-layer placement holds `repro`'s bytes,
    ROADMAP C27). Such a leaf is one tensor with no stacked axes here.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch
from torch import nn

from repro_torch.core.interop import _stacked_paths


STACKED = "stacked"  # a family's entry of stacked parameters, by keystr


@dataclasses.dataclass(frozen=True)
class Row:
    """A layer's entry that is row `index` of the family's stacked
    parameter ``stacked[key]``: the layer reads it through
    `sharding.dtensor.stack_row` (`models.transformer.ParamDict`)."""

    key: str
    index: int


def _key_path(key: str) -> tuple:
    """The path of a keystr of dict keys and list indices."""
    from repro_torch.sharding.rules import key_tokens

    return tuple(_component(t) for t in key_tokens(key))


class Leaf(NamedTuple):
    key: str  # jax.tree_util.keystr of the leaf's path
    names: List[str]  # the port tensors stacked into it, row-major
    lead: Tuple[int, ...]  # sizes of the stacked leading axes (() if none)


def _walk(tree, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    if tree is None or isinstance(tree, Row):
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
    as for a decode cache); without either, each tensor is a leaf. A
    stacked parameter (``stacked.<keystr>``, `stack_leaves`) is its leaf
    whole, with no stacked axes."""
    names = list(named_tensors(tree))
    if stacked is None:
        cfg = getattr(tree, "cfg", None)
        stacked = (_stacked_paths(cfg, _structure(tree)) if cfg is not None
                   else {})
    groups: Dict[tuple, list] = {}
    for name in names:
        comps = tuple(_component(c) for c in name.split("."))
        path, index = comps, ()
        if len(comps) == 2 and comps[0] == STACKED:
            groups.setdefault(_key_path(comps[1]), []).append(((), name))
            continue
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
    if tree is None or isinstance(tree, Row):
        return tree
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
    if module is None or torch.is_tensor(module) or isinstance(module, Row):
        return module
    if hasattr(module, "keys"):
        return {k: _structure(module.entry(k)) for k in module.keys()}
    return [_structure(m) for m in module]


def _set(tree, comps, value) -> None:
    for c in comps[:-1]:
        tree = tree[_component(c)]
    tree[_component(comps[-1])] = value


def stack_leaves(module, keys):
    """A module of `module`'s class (a family's parameters, on any device,
    ``meta`` too) in which each `repro` leaf named in `keys` is held
    stacked as `repro` holds it: one tensor of the leaf's shape (its layers
    stacked on its one stacked axis) under ``stacked[key]``, each layer's
    entry a `Row` of it. Parameters already stacked stay so."""
    named = named_tensors(module)
    by_key = {leaf.key: leaf for leaf in leaves(module)}
    tree = module.to_tree()
    stacks = dict(tree.get(STACKED) or {})
    for key in keys:
        leaf = by_key[key]
        if len(leaf.lead) != 1:
            raise ValueError(f"{key}: a stacked parameter holds one stacked "
                             f"axis, this leaf has {leaf.lead}")
        stacks[key] = torch.stack([named[n].detach() for n in leaf.names])
        for i, name in enumerate(leaf.names):
            _set(tree, name.split("."), Row(key, i))
    tree[STACKED] = stacks
    return module.like(tree)
