"""``BENCHMARK.json`` and the files it names, found by name.

A workload names a configuration (its ``file``) and a traffic mix
(``traffic/<traffic>.json``); its limits are ``limits/<workload>.json``;
each metric is read by ``metrics/<metric>.py``. A later change adds a
configuration, a mix or a metric by adding files and entries, without
editing a file that is there.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

#: the benchmark's folder and the checkout it lies in
ROOT = Path(__file__).resolve().parents[1]
REPO = ROOT.parent


def load_json(path: Path) -> Dict:
    with open(path) as fh:
        return json.load(fh)


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, name: str, repo: Path = REPO, root: Optional[Path] = None):
        root = ROOT if root is None else root
        self.bench = load_json(repo / "BENCHMARK.json")
        found = [w for w in self.bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in {repo / 'BENCHMARK.json'}")
        self.workload = found[0]
        self.name = name
        self.root = root
        entry = [c for c in self.bench["configs"] if c["name"] == self.workload["config"]][0]
        self.config = load_json(repo / entry["file"])
        self.traffic = load_json(root / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = load_json(root / "limits" / f"{name}.json")

    def metrics(self, per_layer: bool) -> List[Dict]:
        """The metrics this cell reports: its end-to-end ones, or with
        ``per_layer`` its per-layer ones (a metric with a ``workloads``
        key only in the cells it lists)."""
        entries = self.bench["per_layer" if per_layer else "end_to_end"]
        return [m for m in entries if self.name in m.get("workloads", [self.name])]

    def reader(self, metric: str) -> ModuleType:
        """The module of ``metrics/<metric>.py``."""
        return load_module(self.root / "metrics" / f"{metric}.py", f"benchmark_metric_{metric}")


def load_module(path: Path, name: str) -> ModuleType:
    """Import the Python file at ``path`` under the module name ``name``."""
    if name in sys.modules and getattr(sys.modules[name], "__file__", None) == str(path):
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module
