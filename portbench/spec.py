"""`BENCHMARK.json` and the files a cell is made of, found by name.

A cell (an entry of ``workloads``) names a configuration, whose entry in
``configs`` gives its file; a traffic mix, `traffic/<traffic>.json`, whose
``kind`` names the module that drives and checks it, `kinds/<kind>.py`;
and the limits its answers are held to, `cells/<cell>.json`. Its
per-layer metrics are the ``per_layer`` entries that list it, each read by
`metrics/<metric>.py`. Nothing here knows a cell, a kind or a metric by
name.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import re
from types import ModuleType
from typing import Callable, List

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict          # the cell's entry in ``workloads``
    config: dict         # configs/<config>.json
    traffic: dict        # traffic/<traffic>.json
    kind: ModuleType     # kinds/<traffic["kind"]>.py
    limits: dict         # cells/<cell>.json
    end_to_end: List[dict]
    per_layer: List[dict]


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: str) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(spec: dict, root: str, name: str) -> Cell:
    """The cell `name` with its configuration, traffic, limits and metrics."""
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(entries)})")
    entry = entries[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(os.path.join(root, configs[entry["config"]]["file"]))
    traffic = load_json(os.path.join(HERE, "traffic",
                                     entry["traffic"] + ".json"))
    limits = load_json(os.path.join(HERE, "cells", name + ".json"))
    return Cell(
        name=name, entry=entry, config=config, traffic=traffic,
        kind=kind(traffic["kind"]), limits=limits,
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
    )


def reader(metric: str) -> Callable:
    """`read(record)` of `metrics/<metric>.py`."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    mod_name = "portbench_metric_" + re.sub(r"\W", "_", metric)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def kind(name: str) -> ModuleType:
    """The traffic kind `kinds/<name>.py`; an unknown kind raises."""
    if not re.fullmatch(r"[A-Za-z0-9_]+", name) or not os.path.exists(
            os.path.join(HERE, "kinds", name + ".py")):
        have = sorted(f[:-3] for f in os.listdir(os.path.join(HERE, "kinds"))
                      if f.endswith(".py") and f != "__init__.py")
        raise KeyError(f"no traffic kind {name!r} (have {have})")
    return importlib.import_module(f"portbench.kinds.{name}")


def generator(name: str):
    """The generator module `generators/<name>.py`."""
    return importlib.import_module(f"portbench.generators.{name}")

