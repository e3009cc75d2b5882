"""The port's sharding rules (`repro_torch.sharding.rules`) against
`repro.sharding.rules`, shapes only: every arch at full size, `repro`'s
trees from `jax.eval_shape`, the port's on the ``meta`` device (nothing
allocated). Each port spec, its stacked prefix put back, equals
``tuple(repro_spec)`` exactly for `param_pspecs` (with and without
``expert_2d``), `zero1_pspecs`, `batch_pspecs` and `cache_pspecs` on a
(16, 16) mesh, a (2, 16, 16) pod mesh and (2, 4); `repro`'s three rule
checks run on the port's specs; and `to_placements` maps specs to DTensor
placements."""
import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCHS as J_ARCHS
from repro.models import Runtime as JRuntime
from repro.models import build_model as j_build_model
from repro.models import input_specs as j_input_specs
from repro.sharding import rules as jrules
from repro_torch.configs import ARCHS
from repro_torch.models import Runtime, build_model, cache_shapes, \
    input_specs, param_shapes
from repro_torch.optim.tree import leaves, named_tensors
from repro_torch.sharding import rules

NAMES = sorted(ARCHS)


class FakeMesh:
    """A mesh without devices, as `repro`'s tests fake one (``axis_names``
    and ``devices.shape``)."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = SimpleNamespace(shape=shape)


MESHES = {
    "16x16": FakeMesh((16, 16), ("data", "model")),
    "pod2x16x16": FakeMesh((2, 16, 16), ("pod", "data", "model")),
    "2x4": FakeMesh((2, 4), ("data", "model")),
}


@functools.lru_cache(maxsize=None)
def _repro_shapes(name):
    model = j_build_model(J_ARCHS[name])
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    cache = jax.eval_shape(lambda: model.init_cache(128, 256, JRuntime()))
    return params, cache


@functools.lru_cache(maxsize=None)
def _port_shapes(name):
    cfg = ARCHS[name]
    return param_shapes(cfg), cache_shapes(cfg, 128, 256, Runtime())


def _repro_specs(specs):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))
    return {jax.tree_util.keystr(path): tuple(spec) for path, spec in flat}


def _with_prefix(tree, leaf_specs, stacked=None):
    """The port's per-tensor specs (`tensor_pspecs`) with each leaf's
    stacked prefix put back, by keystr (every tensor of a stacked leaf has
    the same spec), and the leaves left out: those whose spec shards a
    stacked layer axis, which no per-layer tensor can hold (`repro`'s MLA
    latent cache under its KV rule)."""
    lead = {leaf.key: len(leaf.lead) for leaf in leaves(tree, stacked)}
    out_of_layer = {k for k, s in leaf_specs.items()
                    if any(e is not None for e in s[:lead[k]])}
    per_tensor = rules.tensor_pspecs(
        tree, {k: (None,) * len(s) if k in out_of_layer else s
               for k, s in leaf_specs.items()}, stacked)
    out = {}
    for leaf in leaves(tree, stacked):
        specs = {per_tensor[n] for n in leaf.names}
        assert len(specs) == 1, (leaf.key, specs)
        if leaf.key not in out_of_layer:
            out[leaf.key] = (None,) * len(leaf.lead) + specs.pop()
    return out, out_of_layer


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("expert_2d", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_param_pspecs_equal_repro(name, expert_2d, mesh):
    jparams, _ = _repro_shapes(name)
    params, _ = _port_shapes(name)
    want = _repro_specs(jrules.param_pspecs(jparams, MESHES[mesh],
                                            expert_2d=expert_2d))
    got = rules.param_pspecs(params, MESHES[mesh], expert_2d=expert_2d)
    assert list(got) == list(want)  # repro's leaves, in its order
    assert got == want
    per_layer, out_of_layer = _with_prefix(params, got)
    assert not out_of_layer
    assert per_layer == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_leaf_spec_is_each_tensors_param_spec(name, mesh):
    """`leaf_spec` of a tensor's own name and shape, which places a layer
    as it is drawn (`sharding.dtensor.place_tree`), is the spec
    `param_pspecs` gives it in the whole model."""
    params, _ = _port_shapes(name)
    want = rules.tensor_pspecs(params, rules.param_pspecs(params,
                                                          MESHES[mesh]))
    got = {n: rules.leaf_spec(n.rsplit(".", 1)[-1], tuple(t.shape),
                              MESHES[mesh])
           for n, t in named_tensors(params).items()}
    assert got == want


@pytest.mark.parametrize("name", NAMES)
def test_init_places_each_layer_as_it_is_drawn(name):
    """A family's ``init(place=...)`` hands each layer to `place` as soon
    as it is drawn and then the whole tree, in which only the tensors
    outside the layers are new; the values are those of an ``init``
    without `place`."""
    cfg = ARCHS[name].reduced()
    seen, calls = set(), []

    def place(tree):
        fresh = [0]

        def walk(v):
            if torch.is_tensor(v):
                if id(v) in seen:
                    return v
                fresh[0] += 1
                v = v.clone()
                seen.add(id(v))
                return v
            if isinstance(v, dict):
                return {k: walk(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return type(v)(walk(x) for x in v)
            return v

        out = walk(tree)
        calls.append(fresh[0])
        return out

    model = build_model(cfg)
    placed = model.init(torch.Generator().manual_seed(3), device="cpu",
                        place=place)
    plain = model.init(torch.Generator().manual_seed(3), device="cpu")
    got, want = named_tensors(placed), named_tensors(plain)
    assert list(got) == list(want)
    assert all(torch.equal(got[n], want[n]) for n in want)
    # every tensor went through `place` once; the last call (the whole
    # tree) met only the few outside the layers, the others (a stack of
    # stacks) none new
    layers, rest = calls[:-1], calls[-1]
    assert sum(layers) + rest == len(want)
    assert len(layers) >= 2 and max(layers) < len(want) / 2
    assert rest < min(len(want) / 2, 12)  # embeddings, heads, norms, convs


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_zero1_pspecs_equal_repro(name, mesh):
    jparams, _ = _repro_shapes(name)
    params, _ = _port_shapes(name)
    want = _repro_specs(jrules.zero1_pspecs(jparams, MESHES[mesh]))
    got = rules.zero1_pspecs(params, MESHES[mesh])
    assert list(got) == list(want)
    assert got == want


def test_tensor_pspecs_refuse_a_sharded_layer_axis():
    """ZeRO-1 folds data onto llama3-8b's stacked layer axis (32 layers on a
    data axis of 16); one tensor per layer cannot hold that spec."""
    params, _ = _port_shapes("llama3-8b")
    specs = rules.zero1_pspecs(params, MESHES["16x16"])
    key = "['units']['pos0']['attn']['wq']"
    assert specs[key] == ("data", None, "model")
    with pytest.raises(ValueError, match="stacked layer axis"):
        rules.tensor_pspecs(params, specs)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("batch", [256, 1])
@pytest.mark.parametrize("name", NAMES)
def test_batch_pspecs_equal_repro(name, batch, mesh):
    want = jrules.batch_pspecs(j_input_specs(J_ARCHS[name], batch, 128),
                               MESHES[mesh])
    got = rules.batch_pspecs(input_specs(ARCHS[name], batch, 128),
                             MESHES[mesh])
    assert got == {k: tuple(v) for k, v in want.items()}


def test_batch_specs():
    """`repro`'s own case: the batch over ('data',), a batch of one
    replicated; over ('pod', 'data') on the pod mesh."""
    cfg = ARCHS["tinyllama-1.1b"]
    assert rules.batch_pspecs(input_specs(cfg, 256, 128),
                              MESHES["16x16"])["tokens"] == ("data", None)
    assert rules.batch_pspecs(input_specs(cfg, 1, 128),
                              MESHES["16x16"])["tokens"] == ()
    assert rules.batch_pspecs(input_specs(cfg, 256, 128),
                              MESHES["pod2x16x16"])["tokens"] == (
        ("pod", "data"), None)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_cache_pspecs_equal_repro(name, mesh):
    _, jcache = _repro_shapes(name)
    _, cache = _port_shapes(name)
    cfg = ARCHS[name]
    want = _repro_specs(jrules.cache_pspecs(J_ARCHS[name], jcache,
                                            MESHES[mesh]))
    assert want["['index']"] == ()  # the 0-d int32 leaf, replicated
    got = rules.cache_pspecs(cfg, cache, MESHES[mesh])
    assert list(got) == list(want)
    assert got == want
    stacked = rules.cache_stacked(cfg, cache)
    per_layer, out_of_layer = _with_prefix(cache, got, stacked)
    assert per_layer == {k: v for k, v in want.items()
                         if k not in out_of_layer}
    # only an MLA latent's stacked units axis, which `repro`'s KV rule
    # takes for the batch, is sharded outside a layer
    assert cfg.mla is not None or not out_of_layer


def _bytes(tree, stacked=None):
    named = named_tensors(tree)
    return {leaf.key: int(np.prod(leaf.lead)) * named[leaf.names[0]].numel()
            * named[leaf.names[0]].element_size()
            for leaf in leaves(tree, stacked)}


@pytest.mark.parametrize("name", ["llama3-8b", "deepseek-v2-lite-16b",
                                  "llama4-maverick-400b-a17b"])
def test_param_rules_cover_big_tensors(name):
    """Nothing above 256 MB replicated (`repro`'s check on the port's
    specs)."""
    params, _ = _port_shapes(name)
    specs = rules.param_pspecs(params, MESHES["16x16"])
    for key, nbytes in _bytes(params).items():
        if nbytes > 256 * 2**20:
            assert "model" in specs[key], (key, nbytes)


def test_param_rules_respect_divisibility():
    """smollm-360m (15 heads, d=960): 'model' only where 16 divides."""
    params, _ = _port_shapes("smollm-360m")
    named = named_tensors(params)
    specs = rules.tensor_pspecs(params, rules.param_pspecs(
        params, MESHES["16x16"]))
    for name, spec in specs.items():
        for dim, axis in enumerate(spec):
            if axis == "model":
                assert named[name].shape[dim] % 16 == 0, (name, spec)


@pytest.mark.parametrize("name", NAMES)
def test_cache_specs_divide(name):
    _, cache = _port_shapes(name)
    cfg = ARCHS[name]
    stacked = rules.cache_stacked(cfg, cache)
    specs = rules.cache_pspecs(cfg, cache, MESHES["pod2x16x16"])
    named = named_tensors(cache)
    sizes = {"data": 16, "model": 16, "pod": 2}
    for leaf in leaves(cache, stacked):
        shape = tuple(leaf.lead) + tuple(named[leaf.names[0]].shape)
        for dim, ax in enumerate(specs[leaf.key]):
            if ax is None:
                continue
            axes = (ax,) if isinstance(ax, str) else ax
            assert shape[dim] % int(np.prod([sizes[a] for a in axes])) == 0


def test_to_placements():
    pod = SimpleNamespace(mesh_dim_names=("pod", "data", "model"), ndim=3)
    grid = SimpleNamespace(mesh_dim_names=("data", "model"), ndim=2)
    R = Replicate()
    assert rules.to_placements(("model", None), grid) == (R, Shard(0))
    assert rules.to_placements((None, "model"), grid) == (R, Shard(1))
    assert rules.to_placements((), grid) == (R, R)
    assert rules.to_placements(("data", None), grid) == (Shard(0), R)
    assert rules.to_placements((("pod", "data"), None, "model"), pod) == (
        Shard(0), Shard(0), Shard(2))
    assert rules.to_placements(("model", None, "data"), grid) == (
        Shard(2), Shard(0))
    with pytest.raises(ValueError, match="order"):
        rules.to_placements((("data", "pod"),), pod)
    with pytest.raises(ValueError, match="not axes"):
        rules.to_placements(("pod", None), grid)
    with pytest.raises(ValueError, match="twice"):
        rules.to_placements(("model", "model"), grid)


def test_axis_sizes_of_every_mesh_kind():
    assert rules.axis_sizes(MESHES["pod2x16x16"]) == {
        "pod": 2, "data": 16, "model": 16}
    torch_like = SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(2, 2))
    assert rules.axis_sizes(torch_like) == {"data": 2, "model": 2}
    spmv_like = SimpleNamespace(axis_names=("data", "model"),
                                shape={"data": 4, "model": 1})
    assert rules.axis_sizes(spmv_like) == {"data": 4, "model": 1}
