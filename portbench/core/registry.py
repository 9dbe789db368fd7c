"""Finding what a cell is made of, by name.

``BENCHMARK.json`` names each cell's configuration and traffic; the cell's
own settings are ``cells/<cell>.json``, the traffic's parameters
``traffic/<traffic>.json``, the configuration its ``file``. A metric is read
by ``metrics/<metric>.py`` (``read(run) -> float | None``) and a kernel's
work is ``kernels/<kernel>.py``. A new cell, mix, metric or kernel is a new
file: nothing here names one.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, NamedTuple, Optional

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


class Cell(NamedTuple):
    """One entry of ``workloads`` and what it names."""
    name: str
    entry: dict          # the ``workloads`` entry
    spec: dict           # cells/<name>.json
    config: dict         # the configuration's file
    traffic: dict        # traffic/<traffic>.json

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def reference(self) -> ModuleType:
        return importlib.import_module(f"portbench.reference.{self.config['reference']}")


def cell(bench: dict, name: str, root: Path = ROOT, pkg: Path = PKG) -> Cell:
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r}; BENCHMARK.json has {sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(Path(root) / configs[entry["config"]]["file"])
    return Cell(name, entry, load_json(pkg / "cells" / f"{name}.json"), config,
                load_json(pkg / "traffic" / f"{entry['traffic']}.json"))


def load_file(path: Path) -> ModuleType:
    """A module from a file whose name need not be an identifier
    (``metrics/train.mfu.py``)."""
    spec = importlib.util.spec_from_file_location(f"portbench_{path.parent.name}_{path.stem}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric(name: str, pkg: Path = PKG) -> ModuleType:
    return load_file(pkg / "metrics" / f"{name}.py")


def kernels(pkg: Path = PKG) -> Dict[str, ModuleType]:
    """Every kernel file, by name."""
    return {p.stem: load_file(p) for p in sorted((pkg / "kernels").glob("*.py"))}


def reports(entry: dict, cell_name: str, reported_e2e: Optional[List[str]] = None) -> bool:
    """Whether the metric ``entry`` is reported in ``cell_name``: listed in
    its ``workloads``, or, without that key, an end-to-end metric of every
    cell or a per-layer metric of every cell that reports what it moves."""
    if "workloads" in entry:
        return cell_name in entry["workloads"]
    return reported_e2e is None or entry["moves"] in reported_e2e


def metrics_of(bench: dict, cell_name: str, trace: bool) -> List[dict]:
    """The metric entries a run of ``cell_name`` prints: its end-to-end
    metrics, or with ``trace`` its per-layer ones."""
    e2e = [m for m in bench["end_to_end"] if reports(m, cell_name)]
    if not trace:
        return e2e
    names = [m["name"] for m in e2e]
    return [m for m in bench["per_layer"] if reports(m, cell_name, names)]
