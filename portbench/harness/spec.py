"""Find a cell's parts by name: its entry in ``BENCHMARK.json``, its
configuration (``configs/<config>.json`` and its program file
``configs/<config>.py``), its traffic (``traffic/<traffic>.json``), its
limits (``limits/<workload>.json``), its plain reference
(``reference/<config>.py``) and the readers of its per-layer metrics
(``metrics/<metric>.py``).  Nothing here names a cell: a cell added to
``BENCHMARK.json`` with its files is found the same way."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


class SpecError(RuntimeError):
    """A cell, or one of its files, is missing or malformed."""


def load_module(path: Path) -> ModuleType:
    """A Python file of the benchmark as a module (file names may hold
    ``-`` and ``.``, so they are loaded by path, not imported by name),
    loaded once a process."""
    if not path.is_file():
        raise SpecError(f"no file {path}")
    mod_name = "portbench_" + "".join(
        c if c.isalnum() else "_" for c in path.relative_to(BENCH_DIR)
        .with_suffix("").as_posix())
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    if not path.is_file():
        raise SpecError(f"no file {path}")
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` and everything it names."""
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict            # configs/<config>.json
    traffic: dict           # traffic/<traffic>.json
    limits: dict            # limits/<workload>.json
    end_to_end: list        # the end_to_end entries this cell reports
    per_layer: list         # the per_layer entries this cell reports

    def program(self) -> ModuleType:
        return load_module(BENCH_DIR / "configs" / f"{self.config_name}.py")

    def reference(self) -> ModuleType:
        return load_module(BENCH_DIR / "reference"
                           / f"{self.config_name}.py")

    def reader(self, metric: str) -> ModuleType:
        return load_module(BENCH_DIR / "metrics" / f"{metric}.py")


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_bench(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def find_cell(workload: str, root: Path = ROOT) -> Cell:
    bench = load_bench(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SpecError(f"no workload {workload!r} in BENCHMARK.json "
                        f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise SpecError(f"workload {workload!r} names config "
                        f"{w['config']!r}, which BENCHMARK.json lacks")
    config = read_json(root / configs[w["config"]]["file"])
    traffic = read_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    limits = read_json(BENCH_DIR / "limits" / f"{workload}.json")
    return Cell(name=workload, chips=int(w["chips"]),
                config_name=w["config"], traffic_name=w["traffic"],
                config=config, traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, workload)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, workload)])
