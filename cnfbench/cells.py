"""What a cell is made of, found by name: its entry in ``BENCHMARK.json``,
its configuration (``configs/<name>.json``), its traffic mix
(``traffic/<name>.json``), its limits (``limits/<cell>.json``) and the
readers of its per-layer metrics (``metrics/<metric>.py``).

A later cell, configuration, mix or metric is added as files and entries
alone: nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, List, Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file
    traffic: dict  # the traffic mix's file
    limits: dict  # compared number -> its limit
    end_to_end: List[dict]  # the benchmark's end-to-end metrics this cell reports
    per_layer: List[dict]  # the per-layer metrics this cell reports

    @property
    def model(self) -> dict:
        """The ``ConvFlowConfig`` fields."""
        return self.config["model"]


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _read(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    """A metric with no ``workloads`` is every cell's (``setup_s``)."""
    return cell in metric.get("workloads", (cell,))


def load(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``."""
    bench = benchmark(root)
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    conf = [c for c in bench["configs"] if c["name"] == entry["config"]][0]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    per_layer = [m for m in bench["per_layer"] if _reports(m, name)]
    return Cell(
        name=name, chips=int(entry["chips"]), config=_read(root / conf["file"]),
        traffic=_read(HERE / "traffic" / f"{entry['traffic']}.json"),
        limits=_read(HERE / "limits" / f"{name}.json")["limits"],
        end_to_end=e2e, per_layer=per_layer)


def reader(metric: str) -> Callable[[dict], Optional[float]]:
    """``read(record)`` of ``metrics/<metric>.py``: the metric's value from
    a traced run's record, or None where the record holds nothing for it."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "cnfbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
