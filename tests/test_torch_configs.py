"""The port's copy of the architecture configs equals `repro`'s, field for
field, in full and reduced form."""
import dataclasses

import pytest

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro_torch.configs import ARCHS, SHAPES, applicable_shapes, get_arch
from repro_torch.core.engine import clear_engine_cache, clear_schedule_cache
from repro_torch.core.gather_engine import clear_gather_engine_cache


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    clear_engine_cache()
    clear_schedule_cache()
    clear_gather_engine_cache()
    yield


def test_registry_names_match():
    assert list(ARCHS) == list(J_ARCHS)


@pytest.mark.parametrize("name", sorted(J_ARCHS))
def test_arch_and_reduced_equal_repro(name):
    ours, theirs = get_arch(name), J_ARCHS[name]
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(ours.reduced()) == dataclasses.asdict(
        theirs.reduced())
    assert ours.resolved_head_dim == theirs.resolved_head_dim
    assert [s.name for s in applicable_shapes(ours)] == [
        s.name for s in applicable_shapes(theirs)]


def test_llama3_8b_widths_and_shapes():
    cfg = get_arch("llama3-8b")
    assert (cfg.n_layers, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim) == (32, 32, 8, 128)
    assert [dataclasses.asdict(s) for s in SHAPES] == [
        dataclasses.asdict(s) for s in J_SHAPES]
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")
