"""Finds a cell's files by the names in ``BENCHMARK.json``: the cell's
entry, its configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), its own parameters (``workloads/<cell>.json``:
the check's sample sizes and limits) and the reader of each metric it
reports (``metrics/<metric>.py``). Adding a cell, a configuration, a mix
or a metric adds files and entries; nothing here names one."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    entry: dict          # the cell's BENCHMARK.json entry
    config: dict
    traffic: dict
    params: dict         # workloads/<cell>.json
    end_to_end: List[dict]
    per_layer: List[dict]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in e2e_names


def find_cell(name: str, bench: dict = None, base: Path = HERE) -> Cell:
    """The cell ``name`` with everything it runs and reports, from the
    files under ``base``."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name, e2e_names)]
    return Cell(name=name, entry=entry,
                config=load_json(base / "configs" / f"{entry['config']}.json"),
                traffic=load_json(base / "traffic" / f"{entry['traffic']}.json"),
                params=load_json(base / "workloads" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)


def reader(metric: str, base: Path = HERE) -> Callable:
    """``read(run)`` of ``metrics/<metric>.py``: the metric's value, or
    None where the run holds nothing for it to read."""
    path = base / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "castorbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metric_values(run, metrics: List[dict]) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` of every metric whose reader found
    something to read."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
