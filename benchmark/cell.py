"""A cell of the benchmark, found by name: its entry in BENCHMARK.json, its
configuration (``configs/<config>.json``), its traffic
(``traffic/<traffic>.json``), its limits (``workloads/<cell>.json``) and the
metrics it reports, each read by ``metrics/<metric>.py``."""
from __future__ import annotations

import importlib.util
import json
import os.path as osp
from dataclasses import dataclass, field
from typing import Dict, List

HERE = osp.dirname(osp.abspath(__file__))
ROOT = osp.dirname(HERE)


def _json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = _json(osp.join(root, "BENCHMARK.json"))
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (it has "
                       f"{[w['name'] for w in bench['workloads']]})")
    w = found[0]
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=_json(osp.join(HERE, "configs", f"{w['config']}.json")),
        traffic_name=w["traffic"],
        traffic=_json(osp.join(HERE, "traffic", f"{w['traffic']}.json")),
        limits=_json(osp.join(HERE, "workloads", f"{name}.json"))["limits"],
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)])


def metric_module(metric: str):
    """``metrics/<metric>.py``: its ``read(run)`` and, where the metric needs
    a measurement of its own after the traced steps, ``measure(session)``."""
    path = osp.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
