"""The port's bench (keyless_zk_tpu_torch/bench.py) and its runners on the CPU.

No metric runs here: the bench measures the card only. What runs: the
whole bench without a card (it refuses as bench.py does, exit 0, and
writes nothing outside build/bench/), the watchdog, the point cache, every
output check on correct and corrupted results at tiny sizes on the CPU,
and the record format against bench.py's names and units.
"""

import dataclasses
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from keyless_zk_tpu_torch import bench
from keyless_zk_tpu_torch.curves.jacobian import G1_CURVE, G2_CURVE, JacPoint
from keyless_zk_tpu_torch.fields.limbs import ints_to_limbs
from keyless_zk_tpu_torch.fields.torch_field import FR
from keyless_zk_tpu_torch.fields import torch_field as tf
from keyless_zk_tpu_torch.ops.cuda_ntt import get_cuda_plan
from keyless_zk_tpu_torch.ops.msm import msm
from keyless_zk_tpu_torch.ops.testgen import random_dlogs, random_points, random_scalars
from keyless_zk_tpu_torch.service.types import success_response
from keyless_zk_tpu_torch.tools import bench_batch, full_prove

from torch_io_fixtures import scalar_proof

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def _jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flip(t: torch.Tensor, row: int) -> torch.Tensor:
    """A copy of t with one limb of `row` changed."""
    out = t.clone()
    out.reshape(out.shape[0], -1)[row, 0] ^= 1
    return out


def test_refuses_without_a_card(tmp_path):
    """`python -m keyless_zk_tpu_torch.bench` with no card: exit 0 within
    seconds, bench.py's "device backend unavailable" record last, nothing
    written to BENCH_LOCAL.json or the home directory."""
    local = ROOT / "BENCH_LOCAL.json"
    before = local.read_bytes()
    home = tmp_path / "home"
    home.mkdir()
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["HOME"] = str(home)
    out = subprocess.run([sys.executable, "-m", "keyless_zk_tpu_torch.bench"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last == {"metric": "msm_g1_2^16", "error": "device backend unavailable", "value": None,
                    "unit": None, "vs_baseline": None}
    assert "no CUDA device" in json.loads(out.stdout.strip().splitlines()[0])["error"]
    assert local.read_bytes() == before
    assert list(home.iterdir()) == []


def test_watchdog_kills_the_child_process_group(tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "BENCH_DIR", tmp_path)
    procs = []
    real = subprocess.Popen

    def spy(*a, **k):
        procs.append(real(*a, **k))
        return procs[-1]

    monkeypatch.setattr(bench.subprocess, "Popen", spy)
    results = []
    rec = bench._run_child("devices", 0.2, results)  # below torch's import time
    assert json.loads((tmp_path / "results.json").read_text()) == results == [rec]
    assert rec.pop("child_s") < 30
    assert rec == bench._error_rec("devices", "watchdog timeout after 0s (child killed)")
    (proc,) = procs
    assert proc.returncode == -9
    with pytest.raises(ProcessLookupError):
        os.killpg(proc.pid, 0)


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_point_cache_under_build(tmp_path, monkeypatch, g2):
    home = tmp_path / "home"
    home.mkdir()
    monkeypatch.setenv("HOME", str(home))
    cache = tmp_path / "build" / "bench" / "points"
    monkeypatch.setattr(bench, "POINT_CACHE", cache)
    first = bench.cached_points(8, 42, g2, device="cpu")
    assert [p.name for p in cache.iterdir()] == [f"points_{'g2' if g2 else 'g1'}_8_s42.npz"]
    again = bench.cached_points(8, 42, g2, device="cpu")
    direct = random_points(8, seed=42, curve=G2_CURVE if g2 else G1_CURVE, device="cpu")
    for a, b, c in zip(first, again, direct):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert list(home.iterdir()) == []


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_check_msm(g2):
    """(sum s_i k_i) * G from the seed's discrete logs; scalars below 2^12
    keep the CPU's double-and-add short."""
    curve = G2_CURVE if g2 else G1_CURVE
    px, py, pinf = random_points(8, seed=44, curve=curve, device="cpu")
    ss = [int(v) for v in np.random.default_rng(0).integers(1, 1 << 12, 8)]
    scalars = torch.from_numpy(ints_to_limbs(ss).astype(np.int32))
    out = msm(px, py, pinf, scalars, curve=curve)
    bench.check_msm(out, curve, random_dlogs(8, 44), scalars)
    with pytest.raises(bench.WrongResult):
        bench.check_msm(JacPoint(_flip(out.x[None], 0)[0], out.y, out.z), curve, random_dlogs(8, 44), scalars)
    with pytest.raises(bench.WrongResult):
        bench.check_msm(out, curve, random_dlogs(8, 45), scalars)


def test_check_mont_mul():
    a = random_scalars(8, seed=1, device="cpu")
    b = random_scalars(8, seed=2, device="cpu")
    out = tf.mont_mul(a, b, FR)
    bench.check_mont_mul(out, a, b, FR)
    with pytest.raises(bench.WrongResult, match=r"rows \[0\]"):
        bench.check_mont_mul(_flip(out, 0), a, b, FR)


def test_check_madd():
    px, py, pinf = random_points(8, seed=42, device="cpu")
    out = G1_CURVE.add_mixed(G1_CURVE.from_affine(px, py, pinf), px, py, pinf)
    bench.check_madd(out, random_dlogs(8, 42))
    with pytest.raises(bench.WrongResult, match=r"rows \[7\]"):
        bench.check_madd(JacPoint(out.x, _flip(out.y, 7), out.z), random_dlogs(8, 42))


def test_check_ntt():
    plan = get_cuda_plan(5, CPU)
    x = random_scalars(32, seed=3, device="cpu")
    y = plan.ntt(x)
    bench.check_ntt(plan, x, y, n_rows=32)
    with pytest.raises(bench.WrongResult, match="intt"):
        bench.check_ntt(plan, x, _flip(y, 0))

    class Inverse:  # an intt that hides a wrong forward transform
        domain_pow, n = plan.domain_pow, plan.n

        def intt(self, z):
            return x

    with pytest.raises(bench.WrongResult, match="direct evaluation"):
        bench.check_ntt(Inverse(), x, _flip(y, 0))


def test_check_response_and_proof():
    """The full proof's check (a 200 with the JWT's public-inputs hash and
    a proof that verifies) and the batches' (the proof verifies)."""
    public = 123456789
    vk, proof = scalar_proof(public)
    payload = success_response(proof, public, "00")
    full_prove.check_response(vk, 200, payload, public, "request")
    bench.check_proof(vk, [public], proof, "batch")
    assert full_prove.response_proof_json(payload) == proof

    with pytest.raises(bench.WrongResult, match="answered 500"):
        full_prove.check_response(vk, 500, {"error": "x"}, public, "request")
    with pytest.raises(bench.WrongResult, match="public-inputs hash"):
        full_prove.check_response(vk, 200, payload, public + 1, "request")
    bad = json.loads(json.dumps(payload))
    bad["proof"]["c"][0] ^= 1
    with pytest.raises(bench.WrongResult):
        full_prove.check_response(vk, 200, bad, public, "request")
    tampered = json.loads(json.dumps(proof))
    tampered["pi_c"][0] = str(int(tampered["pi_c"][0]) + 1)
    with pytest.raises(bench.WrongResult, match="does not verify"):
        bench.check_proof(vk, [public], tampered, "batch")


def test_result_record_turns_a_failed_check_into_an_error_record(capsys):
    def measure():
        raise bench.WrongResult("the MSM differs")

    rec = bench.result_record("msm_g1_2^16", measure)
    assert rec == {"metric": "msm_g1_2^16", "error": "wrong result: the MSM differs", "value": None,
                   "unit": None, "vs_baseline": None, "correct": False}
    assert json.loads(capsys.readouterr().out.strip()) == rec
    ok = bench.result_record("ntt_2^16", lambda: bench.emit("ntt_2^16", 1.23456, 4.0, samples_ms=[1.2]))
    assert ok == {"metric": "ntt_2^16", "value": 1.235, "unit": "ms", "vs_baseline": 3.24, "correct": True,
                  "samples_ms": [1.2]}


def test_records_carry_bench_py_names_and_units():
    jb = _jax_bench()
    # bench.py's list, proofs_per_sec's budget raised for its cold procure
    assert bench.METRICS == [(m, 600 if m == "proofs_per_sec" else b, h) for m, b, h in jb.METRICS]
    assert list(bench.RUNNERS) == [m for m, _, _ in jb.METRICS]
    src = (ROOT / "bench.py").read_text()
    units = {}
    for metric, block in re.findall(r'if metric == "([^"]+)":(.*?)(?=\n    \S)', src, re.S):
        if metric != "devices":
            units[metric] = re.search(r'emit\(\s*metric,\s*[^,]+,\s*"([^"]+)"', block, re.S).group(1)
    assert bench.UNITS == units
    assert bench._error_rec("x", "e") == jb._error_rec("x", "e")


def test_mont_mul_sol_basis_is_k1s_bound():
    bound, by = bench.mont_mul_bound_s(1 << 22)
    assert by == "bytes" and round(bound * 1e3, 3) == 0.240


def test_runners_keep_the_jax_configurations():
    from test_keyless_circuit import SMALL
    from keyless_zk_tpu.circuits.keyless_circuit import KeylessConfig

    assert dataclasses.asdict(full_prove.SMALL) == dataclasses.asdict(SMALL)
    assert dataclasses.asdict(full_prove.CONFIGS["full"]) == dataclasses.asdict(KeylessConfig())
    assert bench_batch.CONFIGS is full_prove.CONFIGS
    assert full_prove.SETUP_ROOT == bench.BENCH_DIR / "setups"
