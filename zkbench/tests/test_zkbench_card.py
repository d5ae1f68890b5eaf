"""One short run of each cell on the card, as the benchmark's command
runs it: one JSON line last, `correct` true, every number compared
within its limit. `python -m pytest zkbench/tests -m card` on a machine
with an H100 (each run starts the service: minutes the first time)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.card
@pytest.mark.parametrize("workload", ["keyless-serial.open", "keyless-batched.backlog"])
def test_a_short_run_on_the_card_is_correct(card, workload):
    out = subprocess.run([sys.executable, "-m", "zkbench", "--workload", workload, "--seed", "4242424242",
                          "--seconds", "8", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks" and all(c["value"] <= c["limit"] for c in line["checks"].values())
