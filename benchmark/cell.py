"""Find a cell's parts by name.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``.  It names a
configuration, found as ``configs/<name>.json``, and a traffic mix, found as
``traffic/<name>.json``; each metric of ``per_layer`` is read by the reader
``metrics/<name>.py`` (its ``read(run)`` returns a number or None).  Adding
a configuration, a mix, a metric or a cell adds files and entries; no file
here needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["HERE", "Cell", "load_cell", "load_metric_reader"]

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    """One workload with its configuration, traffic and metric entries."""

    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, spec_path: Path | None = None,
              root: Path = HERE) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (beside the benchmark's
    folder unless given) with its configuration and traffic files from
    ``root``."""
    spec = _read_json(spec_path or root.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have: {', '.join(sorted(cells))})")
    w = cells[name]
    return Cell(
        name=name,
        config=_read_json(root / "configs" / f"{w['config']}.json"),
        traffic=_read_json(root / "traffic" / f"{w['traffic']}.json"),
        chips=int(w["chips"]),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
    )


def load_metric_reader(name: str, root: Path = HERE):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
