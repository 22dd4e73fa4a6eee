"""Find a cell's parts by name.

`BENCHMARK.json` at the checkout's root lists the cells (`workloads`), the
configurations and the metrics.  Everything that belongs to one of them is
a file of its own, found by its name:

    configs/<config>.json     the deployment's sizes, settings and guarantees
    traffic/<traffic>.json    the traffic mix's parameters (generator.py reads it)
    systems/<system>.py       the system under test a configuration names
    appends/<dist>.py         an append distribution the traffic files name
    faults/<kind>.py          a fault kind the traffic files name
    confchanges/<kind>.py     a conf-change kind the traffic files name
    metrics/<metric>.py       a per-layer metric's reader, `read(ctx)`

A later change adds a configuration, a traffic mix, a cell or a metric by
adding such files and entries; no file here needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                   f"have {[w['name'] for w in bench['workloads']]}")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration `name`: its BENCHMARK.json entry's file, parsed."""
    for c in bench["configs"]:
        if c["name"] == name:
            with open(Path(root) / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, package: Path = PACKAGE) -> dict:
    with open(Path(package) / "traffic" / f"{name}.json") as f:
        return json.load(f)


def metrics_of(bench: dict, workload: str, kind: str) -> List[dict]:
    """The `kind` ('end_to_end' or 'per_layer') metrics that the cell
    `workload` reports: those without a `workloads` list, and those whose
    list names it."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def module(package: Path, kind: str, name: str):
    """The module <kind>/<name>.py under `package`, loaded from its file."""
    path = Path(package) / kind / f"{name}.py"
    mod_name = f"portbench_{kind}_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def readers(names: List[str], package: Path = PACKAGE) -> Dict[str, Callable]:
    """Each per-layer metric's `read(ctx)`, from metrics/<name>.py."""
    return {n: module(package, "metrics", n).read for n in names}
