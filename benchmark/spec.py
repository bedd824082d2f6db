"""Finds a cell's parts by name.

BENCHMARK.json at the checkout's root lists the cells (`workloads`) and
the metrics.  Everything that belongs to one configuration, traffic mix,
cell or metric is a file of its own under this folder, found by its name:

  configs/<config>.json     the configuration's sizes, its entry, its
                            work and reference modules, its peaks
  traffic/<traffic>.json    the traffic mix's parameters
  limits/<cell>.json        the numbers `correct` compares, each limit,
                            and the control that set the upper readings
  entries/<entry>.py        drives the program's served path
  work/<name>.py            operations and bytes, from the widths
  reference/<name>.py       the plain float32 PyTorch reference
  metrics/<metric>.py       one reader a metric; a metric named
                            `<stem>.<suffix>` falls back to
                            metrics/<stem>.py

A later cell or metric is added by adding files and entries, never by
editing one of these files.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module (names may hold dots)."""
    module_name = f"benchmark.{kind}.{name.replace('.', '_')}"
    if module_name in sys.modules:
        return sys.modules[module_name]
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[module_name]
        raise
    return module


def metric_reader(name: str):
    """The reader of a metric: metrics/<name>.py, else metrics/<stem>.py
    for a name `<stem>.<suffix>`."""
    try:
        return load_module("metrics", name)
    except FileNotFoundError:
        return load_module("metrics", name.split(".")[0])


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list       # the metric entries this cell reports, trace 0
    per_layer: list        # the metric entries this cell reports, trace 1

    @property
    def devices(self) -> int:
        return self.chips

    @property
    def compute_dtype(self) -> str:
        return self.traffic["compute_dtype"]


def _reports(metric: dict, cell: str, fallback: set | None = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return True if fallback is None else metric["moves"] in fallback


def load_cell(name: str) -> Cell:
    bench = _json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = _json(os.path.join(HERE, "configs", cell["config"] + ".json"))
    traffic = _json(os.path.join(HERE, "traffic", cell["traffic"] + ".json"))
    limits = _json(os.path.join(HERE, "limits", name + ".json"))
    end_to_end = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, config, traffic, limits, int(cell["chips"]),
                end_to_end, per_layer)
