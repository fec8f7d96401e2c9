"""Finds every piece of a cell by name: the ``BENCHMARK.json`` entry, the
cell's file under ``cells/``, its configuration's file under
``configs/``, each metric's reader under ``metrics/`` and the chip's
peaks. A new cell, configuration or metric is a new file and an entry in
``BENCHMARK.json``; nothing here names one."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> Dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(name: str, bench: Dict = None) -> Dict:
    bench = bench or benchmark()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell(name: str) -> Dict:
    """The cell's file ``cells/<workload>.json``."""
    return json.loads((HERE / "cells" / f"{name}.json").read_text())


def config(name: str, bench: Dict = None) -> Dict:
    """The configuration's file, as ``BENCHMARK.json`` names it."""
    bench = bench or benchmark()
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def peaks() -> Dict:
    return json.loads((HERE / "peaks.json").read_text())


def reader(metric: str) -> ModuleType:
    """The module ``metrics/<metric>.py``; its ``read(run)`` gives the
    metric's value, or None where the run holds nothing to read."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"superbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(name: str, trace: bool, bench: Dict = None) -> List[Dict]:
    """The metrics a run of cell ``name`` reports: its end-to-end ones
    untraced, its per-layer ones traced (a metric with ``workloads``
    only in the cells it lists)."""
    bench = bench or benchmark()
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def traffic(kind: str) -> ModuleType:
    """The generator ``traffic/<kind>.py``."""
    return importlib.import_module(f"superbench.traffic.{kind}")

