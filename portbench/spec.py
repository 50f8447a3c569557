"""The benchmark's data: `BENCHMARK.json` and the files it names.

A cell names a configuration and a traffic mix. The configuration's file is
the `file` of its entry; the traffic mix is `traffic/<traffic>.json`, whose
`driver` names the generator in `drivers/<driver>.py`; the correctness
limits of a cell are `limits/<cell>.json`. An end-to-end metric is read by
`end_to_end/<name>.py`, a per-layer metric by `layer_metrics/<name>.py`,
and a kernel's roofline count is `roofline/<kernel>.py`. Adding a cell or a
metric is adding files and entries; no file here lists them.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Optional

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
BENCHMARK = REPO / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict[str, Any]
    traffic: dict[str, Any]
    limits: dict[str, float]
    end_to_end: list[dict[str, Any]]
    per_layer: list[dict[str, Any]]


def load_benchmark(path: Path = BENCHMARK) -> dict[str, Any]:
    with open(path) as fh:
        return json.load(fh)


def _read_json(path: Path) -> dict[str, Any]:
    with open(path) as fh:
        return json.load(fh)


def applies(metric: dict[str, Any], cell: str) -> bool:
    """A metric without `workloads` belongs to every cell."""
    return cell in metric.get("workloads", [cell])


def cell(bench: dict[str, Any], name: str, root: Path = REPO) -> Cell:
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have: {', '.join(entries)})")
    w = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=_read_json(root / cfg_entry["file"]),
        traffic=_read_json(root / "portbench" / "traffic" / f"{w['traffic']}.json"),
        limits=_read_json(root / "portbench" / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)],
    )


_modules: dict[Path, ModuleType] = {}


def load_module(kind: str, name: str, root: Path = HERE) -> ModuleType:
    """The module `<kind>/<name>.py` under this folder. Metric names hold
    dots, so the file is loaded by path, not imported by name."""
    path = root / kind / f"{name}.py"
    if path in _modules:
        return _modules[path]
    if not path.exists():
        raise FileNotFoundError(f"{kind} reader {name!r} not found at {path}")
    mod_name = f"portbench_{kind}_" + "".join(
        ch if ch.isalnum() else "_" for ch in name
    )
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    _modules[path] = module
    return module


def driver(name: str) -> ModuleType:
    return load_module("drivers", name)


def read_metric(kind: str, entry: dict[str, Any], run,
                root: Path = HERE) -> Optional[float]:
    """One metric's value for a finished run, or None where the run gave
    the reader nothing to read."""
    value = load_module(kind, entry["name"], root).read(run)
    return None if value is None else float(value)
