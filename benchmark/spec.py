"""Finding the benchmark's pieces by name.

BENCHMARK.json (at the root of the checkout) names the cells and the
metrics. A cell `C` is `workloads/C.json` (its configuration, its traffic
mix and the limits of its comparison); a configuration `X` is
`configs/X.json`; a traffic mix `T` is the data file `traffic/T.json`,
whose `kind` names the generator module `traffic/<kind>.py`; a per-layer
metric `m` or `m.variant` is the reader `metrics/m.py`. Adding any of them
is adding files and entries: nothing here changes."""

from __future__ import annotations

import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    return _json(HERE / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def mix(name: str) -> dict:
    return _json(HERE / "traffic" / f"{name}.json")


def kind(name: str):
    """The traffic generator module of a mix's `kind`."""
    return importlib.import_module(f"benchmark.traffic.{name}")


def metric_reader(name: str):
    """The module whose `read(view, entry)` gives per-layer metric `name`
    (`m` or `m.variant`: one reader serves every variant of `m`)."""
    return importlib.import_module(f"benchmark.metrics.{name.split('.')[0]}")


def applies(entry: dict, cell: str) -> bool:
    """A metric without `workloads` is reported in every cell."""
    return "workloads" not in entry or cell in entry["workloads"]


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """(end-to-end entries, per-layer entries) that `cell` reports."""
    return ([m for m in bench["end_to_end"] if applies(m, cell)],
            [m for m in bench["per_layer"] if applies(m, cell)])
