"""Everything of a cell is found by the names in BENCHMARK.json:

    benchmark/configs/<config>.json    the configuration as it runs
    benchmark/traffic/<traffic>.json   the traffic mix's parameters
    benchmark/limits/<cell>.json       the correctness limits of the cell
    benchmark/metrics/<metric>.py      a per-layer metric's reader

A later cell, mix, configuration or metric is a new file and a new entry
in BENCHMARK.json; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json("configs", f"{name}.json")


def traffic(name: str) -> dict:
    return _json("traffic", f"{name}.json")


def limits(cell_name: str) -> dict:
    return _json("limits", f"{cell_name}.json")


def reader(metric: str) -> Callable:
    """The `read(ctx)` function of benchmark/metrics/<metric>.py."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, cell_name: str, kind: str) -> List[dict]:
    """The cell's metrics of `kind` ("end_to_end" or "per_layer"): those
    that list it, or that list no cells."""
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]
