"""``BENCHMARK.json`` and the files it names.

Every piece of a cell is found by a name the manifest gives it, so a later
change adds a configuration, a traffic mix, a driver loop, a cell's limits, a
metric or a kernel's counts as new files and edits none:

* a configuration ``c``: its ``file`` (the sizes, JSON) and, beside it with
  the suffix ``.py``, its plain reference and frozen simulator;
* a traffic mix ``m``: ``traffic/<m>.json``, whose ``driver`` names
  ``drivers/<driver>.py``;
* a cell ``w``: ``workloads/<w>.json``, the limits of its comparison;
* a metric ``x``: ``metrics/<x>.py``, whose ``read(run)`` gives its value or
  None where the run has nothing to read;
* a kernel: ``kernels/<kernel>.py``, every file of that folder, each naming
  the kernel, its layer and its work a launch.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def load(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, root: Path = ROOT) -> ModuleType:
    """The Python file at ``path`` as a module named after its place under
    ``root`` (a checkout other than this one gets names of its own)."""
    rel = path.resolve().relative_to(root.resolve()).with_suffix("")
    name = ".".join(rel.parts)
    if root.resolve() != ROOT:
        name = f"_checkout_{abs(hash(str(root.resolve())))}.{name}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload with everything it names, resolved."""

    name: str
    root: Path
    entry: dict
    config: dict  # the configuration's file
    reference: ModuleType  # the plain reference beside it
    traffic: dict
    driver: ModuleType
    limits: dict
    end_to_end: list  # this cell's end-to-end metric entries
    per_layer: list  # this cell's per-layer metric entries


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def resolve(workload: str, manifest: dict | None = None, root: Path = ROOT) -> Cell:
    m = load(root / "BENCHMARK.json") if manifest is None else manifest
    here = root / HERE.name
    entry = next((w for w in m["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in m["configs"] if c["name"] == entry["config"])
    cfg_path = root / conf["file"]
    traffic = _json(here / "traffic" / f"{entry['traffic']}.json")
    return Cell(
        name=workload,
        root=root,
        entry=entry,
        config=_json(cfg_path),
        reference=_module(cfg_path.with_suffix(".py"), root),
        traffic=traffic,
        driver=_module(here / "drivers" / f"{traffic['driver']}.py", root),
        limits=_json(here / "workloads" / f"{workload}.json")["limits"],
        end_to_end=[x for x in m["end_to_end"] if _applies(x, workload)],
        per_layer=[x for x in m["per_layer"] if _applies(x, workload)],
    )


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    return _module(root / HERE.name / "metrics" / f"{name}.py", root)


def kernels(root: Path = ROOT) -> list:
    """Every kernel's counts module, in name order."""
    return [_module(p, root) for p in sorted((root / HERE.name / "kernels").glob("*.py"))
            if p.name != "__init__.py"]


def peaks() -> dict:
    return _json(HERE / "peaks.json")


def check(m: dict) -> list:
    """What in the manifest breaks the benchmark's contract; empty if nothing."""
    errs = []
    if set(m) != TOP_KEYS:
        errs.append(f"top-level keys {sorted(m)}")
    if not (isinstance(m.get("run_seconds"), int) and 1 <= m["run_seconds"] <= 51):
        errs.append("run_seconds")
    for p in m.get("paths", []):
        if not PATH.match(p) or p.startswith("/") or ".." in p.split("/"):
            errs.append(f"path {p!r}")
    names = {}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in m.get(group, []):
            n = e.get("name", "")
            if not NAME.match(n):
                errs.append(f"{group} name {n!r}")
            kind = "metric" if group in ("end_to_end", "per_layer") else group
            if (kind, n) in names:
                errs.append(f"duplicate {kind} {n!r}")
            names[(kind, n)] = e
    for e in m.get("end_to_end", []) + m.get("per_layer", []):
        if not UNIT.match(e.get("unit", "")):
            errs.append(f"unit {e.get('unit')!r} of {e.get('name')}")
        if e.get("better") not in ("lower", "higher"):
            errs.append(f"better of {e.get('name')}")
        if e.get("source") not in SOURCES:
            errs.append(f"source of {e.get('name')}")
    for e in m.get("end_to_end", []):
        if e.get("source") not in SOURCES_E2E or not 0.01 <= e.get("bound", -1) <= 0.25:
            errs.append(f"end-to-end metric {e.get('name')}")
    e2e = {e["name"] for e in m.get("end_to_end", [])}
    for e in m.get("per_layer", []):
        if e.get("moves") not in e2e:
            errs.append(f"{e.get('name')} moves {e.get('moves')!r}")
    for w in m.get("workloads", []):
        for key in ("config", "traffic"):
            if not NAME.match(w.get(key, "")):
                errs.append(f"{key} of {w.get('name')}")
        if ("configs", w.get("config")) not in names:
            errs.append(f"config of {w.get('name')}")
        if w.get("chips") not in (1, 4):
            errs.append(f"chips of {w.get('name')}")
        if not 1 <= len(w.get("why", "")) <= 200:
            errs.append(f"why of {w.get('name')}")
    for c in m.get("configs", []):
        if any(not NAME.match(k) for k in c.get("reduced", [])) or len(c.get("reduced", [])) > 16:
            errs.append(f"reduced of {c.get('name')}")
    return errs
