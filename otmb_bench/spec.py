"""Finds a cell's files by name.

`BENCHMARK.json` at the root of the checkout names each cell with its
configuration and traffic mix, and each metric with the cells that report
it. Beside it, under `otmb_bench/`:

  * `configs/<config>.json`: the grid, topology, dtype and source of a
    configuration;
  * `traffic/<traffic>.json`: a traffic mix's parameters, among them
    `entry`, the module of `entries/` that sends its requests to one public
    entry point of the program;
  * `workloads/<cell>.json`: the cell's check (its limits, how many
    requests it samples and where from);
  * `metrics/<metric>.py`: each metric's reader, a function `read(run)`
    that returns a number, or None where the run gives it nothing to read.

A cell, configuration, traffic mix or metric is added by adding its files
and its entry in `BENCHMARK.json`; no file is edited.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclasses.dataclass
class Spec:
    cell: dict  # the BENCHMARK.json entry of the cell
    config: dict
    traffic: dict
    workload: dict  # workloads/<cell>.json
    end_to_end: list  # the BENCHMARK.json metrics this cell reports
    per_layer: list


def _name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json in {root}")
    return _json(path)


def reports(metric: dict, cell: str) -> bool:
    """Whether the cell reports the metric: it is listed, or the metric
    lists no cells."""
    return cell in metric.get("workloads", [cell])


def load(cell: str, root: Path = ROOT, home: Path = HERE) -> Spec:
    """The cell's spec from `root`'s BENCHMARK.json and `home`'s files."""
    bench = benchmark(root)
    found = [w for w in bench["workloads"] if w["name"] == _name(cell)]
    if not found:
        raise KeyError(f"no cell {cell!r} in BENCHMARK.json; cells: "
                       f"{[w['name'] for w in bench['workloads']]}")
    w = found[0]
    return Spec(
        cell=w,
        config=_json(home / "configs" / f"{_name(w['config'])}.json"),
        traffic=_json(home / "traffic" / f"{_name(w['traffic'])}.json"),
        workload=_json(home / "workloads" / f"{cell}.json"),
        end_to_end=[m for m in bench["end_to_end"] if reports(m, cell)],
        per_layer=[m for m in bench["per_layer"] if reports(m, cell)],
    )


def entry(traffic: dict):
    """The module of `entries/` that the traffic mix names."""
    return importlib.import_module(f"otmb_bench.entries.{_name(traffic['entry'])}")


def reader(metric: str, home: Path = HERE):
    """The `read` function of `metrics/<metric>.py`."""
    path = home / "metrics" / f"{_name(metric)}.py"
    spec = importlib.util.spec_from_file_location(
        "otmb_bench.metrics." + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
