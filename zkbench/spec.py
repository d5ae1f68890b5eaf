"""Find a cell and what belongs to it by name, from BENCHMARK.json.

A cell names its configuration (the `file` that `configs` gives it) and
its traffic mix (`zkbench/traffic/<traffic>.json`); a per-layer metric
is read by `zkbench/metrics/<name>.py`, or, for one quantity split by the
end-to-end metric it moves (`device_idle_pct.open`), by the file of its
name's first part (`device_idle_pct.py`). Nothing here knows a cell by
name: a later cell, mix or metric is a new file and a new entry.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

METRICS_DIR = Path(__file__).resolve().parent / "metrics"


class Spec:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        for c in self.data["configs"]:
            if c["name"] == cell["config"]:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration named {cell['config']!r}")

    def traffic(self, cell: dict) -> dict:
        return json.loads((self.root / "zkbench" / "traffic" / f"{cell['traffic']}.json").read_text())

    def metrics(self, cell: dict, trace: bool) -> list[dict]:
        """The metrics a run of `cell` reports: its end-to-end ones, or with
        a trace its per-layer ones. A metric without `workloads` is
        reported in every cell."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.data[kind] if cell["name"] in m.get("workloads", [cell["name"]])]


def reader_path(name: str) -> Path:
    """The file that reads the per-layer metric `name`."""
    path = METRICS_DIR / f"{name}.py"
    return path if path.is_file() else METRICS_DIR / f"{name.split('.')[0]}.py"


def reader(name: str):
    """The `read(obs)` function of the per-layer metric `name`."""
    path = reader_path(name)
    mod_spec = importlib.util.spec_from_file_location(f"zkbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
