"""A run of each cell with the timed path broken underneath comes out not
correct, and a sound run and its control come out as they must.

The runs skip the look for a card and drive the rest of a run on the
CPU: the service of the cell's configuration, started from its setup
store, with a stand-in circuit whose one public wire is the keyless
public-inputs hash (the pipeline runs unchanged on it), under a
shortened traffic mix; then the reference judges every answer. The
faults: an answer altered where it is produced (the public-inputs hash,
consistently, so the service's own re-verify passes); a step that returns
its state unchanged (the prover answering its first proof again); half
of a batch left out (its proofs repeated for the other half)."""

import dataclasses
import json
import shutil
from pathlib import Path

import pytest

from zkbench import run
from zkbench.reference.bn254 import R_SCALAR
from zkbench.spec import Spec

ROOT = Path(__file__).resolve().parents[2]
SMALL_TRAFFIC = {
    "open-serial": {"rate_per_s": 2.0, "warmup": [1, 0]},
    "backlog": {"clients": 4, "witnesses": 4, "witness_threads": 2, "warmup_batches": 1},
}


def stand_in_circuit(*_):
    from keyless_zk_tpu_torch.circuits import ConstraintSystem

    cs = ConstraintSystem()
    x = cs.public_wire()
    cs.set_input_hint([x], "public_inputs_hash")
    cs.mul(cs.lc(x), cs.lc(x))
    return cs


@pytest.fixture(scope="session")
def bench_root(tmp_path_factory):
    """A checkout's BENCHMARK.json and data files, with the traffic cut
    to what the CPU proves in seconds; its setup store fills on first use."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(ROOT / "zkbench" / "configs", root / "zkbench" / "configs")
    (root / "zkbench" / "traffic").mkdir()
    for name, cut in SMALL_TRAFFIC.items():
        t = json.loads((ROOT / "zkbench" / "traffic" / f"{name}.json").read_text())
        (root / "zkbench" / "traffic" / f"{name}.json").write_text(json.dumps({**t, **cut}))
    return root


def run_cell(root, workload, monkeypatch, seed=20261017):
    """One window of `workload` on the CPU: (the window, its counts as the
    program gave them, the control's counts)."""
    from keyless_zk_tpu_torch.service import prover_state

    monkeypatch.setattr(prover_state, "build_keyless_circuit", stand_in_circuit)
    monkeypatch.setattr(run, "ANSWER_GRACE_S", 900.0)  # a CPU proof takes tens of seconds
    spec = Spec(root)
    session = run.Session(root, spec, spec.cell(workload), device="cpu")
    m = session.measure(seed, 1.0)
    vk, n, facts = session.vk, session.gen.key.n, run.circuit_facts(session.config)
    vk_bad = run.vk_check(vk, session.zkey)
    session.close()
    program = run.counted(m, run.judge_all(*run.judge_tasks(m, vk, n, facts), 2), vk_bad)
    control = run.counted(m, run.judge_all(*run.judge_tasks(m, vk, n, facts, shift=1), 2), vk_bad)
    return m, program, control


@pytest.mark.parametrize("workload", ["keyless-serial.open", "keyless-batched.backlog"])
def test_a_sound_run_is_correct_and_its_control_is_not(bench_root, monkeypatch, workload):
    m, program, control = run_cell(bench_root, workload, monkeypatch, seed=7)
    assert m["attempted"] >= 2 and m["failed"] == 0
    assert run.judge.verdict(program) and program["vk_mismatch"] == 0, program
    assert not run.judge.verdict(control) and control["bad_proof"] >= 1, control
    if workload == "keyless-serial.open":
        assert program["tamper_accepted"] == 0
        assert control["bad_hash"] >= 1 and control["bad_signature"] >= 1


def test_an_answer_altered_where_it_is_produced(bench_root, monkeypatch):
    from keyless_zk_tpu_torch.service import prover_state

    real = prover_state.derive_circuit_input_signals

    def altered(*a, **k):
        signals, pih = real(*a, **k)
        wrong = (pih + 1) % R_SCALAR
        signals.signals["public_inputs_hash"] = dataclasses.replace(signals.signals["public_inputs_hash"], value=wrong)
        return signals, wrong

    monkeypatch.setattr(prover_state, "derive_circuit_input_signals", altered)
    m, counts, _ = run_cell(bench_root, "keyless-serial.open", monkeypatch)
    assert not run.judge.verdict(counts)
    assert counts["bad_hash"] == counts["bad_proof"] == m["attempted"] - counts["unanswered"] >= 1, counts


def test_a_step_that_returns_its_state_unchanged(bench_root, monkeypatch):
    from keyless_zk_tpu_torch.groth16.prover import Groth16Prover

    real, first = Groth16Prover.prove, []

    def stale(self, *a, **k):
        if not first:
            first.append(real(self, *a, **k))
        return first[0]

    monkeypatch.setattr(Groth16Prover, "prove", stale)
    _, counts, _ = run_cell(bench_root, "keyless-serial.open", monkeypatch)
    assert not run.judge.verdict(counts) and counts["unanswered"] + counts["bad_proof"] >= 1, counts


def test_half_of_a_batch_left_out(bench_root, monkeypatch):
    from keyless_zk_tpu_torch.parallel.batch_prover import BatchProver

    real = BatchProver.prove_batch

    def half(self, witnesses):
        kept = real(self, witnesses[: (len(witnesses) + 1) // 2])
        return (kept * 2)[: len(witnesses)]

    monkeypatch.setattr(BatchProver, "prove_batch", half)
    m, counts, _ = run_cell(bench_root, "keyless-batched.backlog", monkeypatch)
    sizes = [b["size"] for b in m["batches"]]
    assert not run.judge.verdict(counts) and counts["bad_proof"] >= 1, (counts, sizes)
