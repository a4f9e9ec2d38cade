"""The benchmark's manifest and the files it names.

``BENCHMARK.json`` (at the checkout's root) lists configurations, cells,
end-to-end and per-layer metrics. Everything else is found by name:
``configs/<config>.json`` (through the configuration's ``file``),
``traffic/<mix>.json`` (its ``kind`` names ``drivers/<kind>.py``),
``metrics/<metric>.py`` and ``rooflines/<kernel>.py``. A later change adds a
configuration, a mix or a metric as new files and entries alone.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

_MODULES: Dict[Path, ModuleType] = {}


def load_module(path: Path) -> ModuleType:
    """The module at ``path``, loaded once per process. File names may hold
    dots (``metrics/host_ms.render.py``), so they load by path."""
    path = Path(path).resolve()
    mod = _MODULES.get(path)
    if mod is None:
        if not path.is_file():
            raise FileNotFoundError(f"no module {path}")
        spec = importlib.util.spec_from_file_location(
            "bench_" + re.sub(r"\W", "_", str(path)), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return mod


class Manifest:
    def __init__(self, root: Path = ROOT, bench_dir: Path = BENCH_DIR):
        self.root, self.dir = Path(root), Path(bench_dir)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.configs = {c["name"]: c for c in self.data["configs"]}
        self.cells = {w["name"]: w for w in self.data["workloads"]}
        self.end_to_end = {m["name"]: m for m in self.data["end_to_end"]}
        self.per_layer = {m["name"]: m for m in self.data["per_layer"]}

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r}; the manifest has {sorted(self.cells)}")
        return self.cells[name]

    def config(self, cell: dict) -> dict:
        return json.loads((self.root / self.configs[cell["config"]]["file"]).read_text())

    def traffic(self, cell: dict) -> dict:
        return json.loads((self.dir / "traffic" / f"{cell['traffic']}.json").read_text())

    def driver(self, traffic: dict) -> ModuleType:
        return load_module(self.dir / "drivers" / f"{traffic['kind']}.py")

    def metric_reader(self, name: str) -> ModuleType:
        return load_module(self.dir / "metrics" / f"{name}.py")

    def roofline(self, kernel: str) -> ModuleType:
        return load_module(self.dir / "rooflines" / f"{kernel}.py")

    @staticmethod
    def _in(metric: dict, cell: str, reported: Optional[set] = None) -> bool:
        if "workloads" in metric:
            return cell in metric["workloads"]
        return reported is None or metric.get("moves") in reported

    def end_to_end_for(self, cell: str) -> List[dict]:
        return [m for m in self.data["end_to_end"] if self._in(m, cell)]

    def per_layer_for(self, cell: str) -> List[dict]:
        reported = {m["name"] for m in self.end_to_end_for(cell)}
        return [m for m in self.data["per_layer"] if self._in(m, cell, reported)]
