"""Cells, configurations, traffic mixes and metric readers are found by
name from data files, and BENCHMARK.json keeps the contract's shape."""

import json
import re
from pathlib import Path

import pytest

from zkbench.spec import METRICS_DIR, Spec, reader, reader_path

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def spec():
    return Spec(ROOT)


def test_every_cell_finds_its_files(spec):
    for cell in spec.data["workloads"]:
        config, traffic = spec.config(cell), spec.traffic(cell)
        assert config["name"] == cell["config"]
        assert traffic["loop"] in ("open", "closed")
        assert cell["chips"] == 1
        assert spec.metrics(cell, trace=False) and spec.metrics(cell, trace=True)


def test_unknown_cell_is_refused(spec):
    with pytest.raises(KeyError):
        spec.cell("no-such.cell")


def test_every_per_layer_metric_has_a_reader(spec):
    for m in spec.data["per_layer"]:
        assert reader_path(m["name"]).parent == METRICS_DIR and reader_path(m["name"]).is_file()
        assert callable(reader(m["name"]))
    assert reader_path("device_idle_pct.open") == reader_path("device_idle_pct.backlog") == \
        METRICS_DIR / "device_idle_pct.py"


def test_names_units_bounds(spec):
    d = spec.data
    assert set(d) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= d["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in d[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in d["end_to_end"]}
    assert set(e2e) == {"request_p90_ms", "proofs_per_s", "setup_s"}
    for m in d["end_to_end"] + d["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in d["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in d["workloads"]}
    for m in d["per_layer"]:
        assert m["moves"] in e2e
        for c in m.get("workloads", cells):
            assert c in cells and c in e2e[m["moves"]].get("workloads", cells)
    for c in cells:
        assert any(c in m.get("workloads", cells) for m in d["end_to_end"] if m["name"] != "setup_s")
    lines = [x["why"] for k in ("configs", "workloads") for x in d[k]] + [c["source"] for c in d["configs"]] \
        + [m["layer"] for m in d["per_layer"]] + d["command"]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in lines)
    for c in d["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("zkbench/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
