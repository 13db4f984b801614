"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (``vqabench/configs/<config>.json``), its traffic mix
(``vqabench/traffic/<traffic>.json``, which names the driver in
``vqabench/drivers/`` that reads it) and each per-layer metric's reader
(``vqabench/metrics/<metric>.py``, a function ``read(readings)`` that
returns the value or None when the run has nothing to read; a metric
``<quantity>.<kind>`` without a file of its own is read by
``<quantity>.py``)."""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _checked(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"({', '.join(w['name'] for w in bench['workloads'])})")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, here: Path = HERE) -> dict:
    with open(here / "traffic" / f"{_checked(name)}.json") as f:
        return json.load(f)


def driver(name: str):
    if not re.match(r"^[a-z_]+$", name):
        raise ValueError(f"not a driver name: {name!r}")
    return importlib.import_module(f"vqabench.drivers.{name}")


def reader_file(name: str, here: Path = HERE) -> Path:
    """The file that reads a per-layer metric: its own, or else that of
    the quantity before its last dot."""
    path = here / "metrics" / f"{_checked(name)}.py"
    if not path.is_file() and "." in name:
        path = here / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    return path


def reader(name: str, here: Path = HERE):
    """The ``read`` function of a per-layer metric's file."""
    path = reader_file(name, here)
    spec = importlib.util.spec_from_file_location(
        "vqabench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def applies(metric: dict, cell_name: str) -> bool:
    """Whether a metric is the cell's: listed for it, or listed for none."""
    return "workloads" not in metric or cell_name in metric["workloads"]
