"""Find a cell's parts by name: its entry in BENCHMARK.json, its
configuration, traffic mix and workload files, its metrics' readers,
its flop formula and operand class, and its entry's adapter and plain
reference.

Everything here is data or a file found by name, so a later change adds
a cell, a configuration, a traffic mix, a metric, a flop formula or an
operand class by adding files and entries, never by editing one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_json() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


@dataclass
class Cell:
    """One cell: a configuration under a traffic mix on `chips` cards,
    with the metrics BENCHMARK.json asks of it and its limits."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def entry(self) -> str:
        return self.config["entry"]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str) -> Cell:
    """The cell `name` of BENCHMARK.json with its files loaded. Raises
    KeyError for a name BENCHMARK.json does not list and ValueError when
    the workload file disagrees with it."""
    bench = benchmark_json()
    check_name(name)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = entries[name]
    work = load_json(HERE / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if work[key] != w[key]:
            raise ValueError(f"{name}: {key} is {work[key]!r} in its file and "
                             f"{w[key]!r} in BENCHMARK.json")
    config = load_json(HERE / "configs" / f"{check_name(w['config'])}.json")
    traffic = load_json(HERE / "traffic" / f"{check_name(w['traffic'])}.json")
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=dict(work["limits"]),
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])


def load(folder: str, name: str):
    """The module of <folder>/<name>.py, loaded from its file (a name may
    hold '.' and '-'): a metric's reader, a flop formula, an operand
    class. Raises FileNotFoundError for a name that has no file."""
    path = HERE / folder / f"{check_name(name)}.py"
    mod_name = f"benchmark.{folder}." + name.replace(".", "_").replace(
        "-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The `read(run)` function of metrics/<metric>.py."""
    return load("metrics", metric).read


def entry_module(entry: str):
    """entries/<entry>.py: the adapter that calls the program."""
    return importlib.import_module(f"benchmark.entries.{check_name(entry)}")


def reference_module(entry: str):
    """reference/<entry>.py: the plain reference, which imports nothing
    of the program."""
    return importlib.import_module(f"benchmark.reference.{check_name(entry)}")
