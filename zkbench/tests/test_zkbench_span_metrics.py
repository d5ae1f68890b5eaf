"""The readers of the program's own spans (zkbench/metrics/lock_wait_ms,
proof_ms, witness_cpu_ms, blind_ms) on hand-made observations: the
service's breakdowns carry `spans`, each [name, t0, t1, cpu_ms] on
time.perf_counter, and the BatchProver's `phase_ms` carries `blind`. A
program without them (the parent of the change that added them) leaves
each reader nothing to read: it returns None."""

import pytest

from zkbench.readings import Observations
from zkbench.spec import reader

NINE = ("deserialize_request", "validate_request", "derive_circuit_input_signals", "generate_witness",
        "generate_proof", "deserialize_proof", "verify_proof", "training_wheels_sign", "build_response")


def breakdown(witness=(0.9, 0.6), waits=((0.1, 0.7),), t=100.0):
    """A request's breakdown: the witness (wall s, CPU s), then for each
    proof (one, or two where it was retried) its lock wait and proof in
    seconds, laid end to end from `t`."""
    spans, phases = [], {}
    for name in NINE:
        t0 = t
        if name == "generate_witness":
            t += witness[0]
            spans.append([name, t0, t, witness[1] * 1e3])
        elif name in ("generate_proof", "verify_proof"):
            for wait, proof in waits[:1] if name == "generate_proof" else waits[1:]:
                spans.append(["prove_lock_wait", t, t + wait, 0.01])
                spans.append(["prove", t + wait, t + wait + proof, proof * 1e3])
                t += wait + proof
            spans.append([name, t0, t, 1.0])
        else:
            t += 0.001
            spans.append([name, t0, t, 1.0])
        phases[name] = (t - t0) * 1e3
    return {"request_id": 1, "phases_ms": phases, "spans": spans, "prover_phase_ms": {}, "batch_size": 1}


def served(*breakdowns) -> Observations:
    return Observations(device_kind="NVIDIA H100 80GB HBM3", startup_s={}, breakdowns=list(breakdowns))


def test_lock_wait_is_the_mean_and_proof_the_median_of_each_requests_spans():
    obs = served(breakdown(waits=((0.1, 0.7),)), breakdown(waits=((0.3, 0.72),)), breakdown(waits=((0.0, 0.74),)))
    assert reader("lock_wait_ms")(obs) == pytest.approx(400.0 / 3)
    assert reader("proof_ms")(obs) == pytest.approx(720.0)
    for b in obs.breakdowns:  # the two make up the generate_proof phase
        gp = b["phases_ms"]["generate_proof"]
        waits = sum(t1 - t0 for n, t0, t1, _ in b["spans"] if n in ("prove_lock_wait", "prove")) * 1e3
        assert waits == pytest.approx(gp)


def test_a_retried_request_sums_its_two_pairs():
    obs = served(breakdown(waits=((0.2, 0.7), (0.05, 0.71))))
    assert reader("lock_wait_ms")(obs) == pytest.approx(250.0)
    assert reader("proof_ms")(obs) == pytest.approx(1410.0)


def test_witness_cpu_is_the_median_cpu_of_the_witness_span():
    obs = served(breakdown(witness=(0.94, 0.61)), breakdown(witness=(0.9, 0.65)), breakdown(witness=(1.2, 0.70)))
    assert reader("witness_cpu_ms")(obs) == pytest.approx(650.0)
    assert reader("witness_cpu_ms")(obs) <= reader("witness_ms")(obs)


def test_blind_is_per_proof_over_the_windows_batches():
    obs = Observations(device_kind="NVIDIA H100 80GB HBM3", startup_s={}, batches=[
        {"size": 8, "phase_ms": {"h_scalars": 3200.0, "blind": 700.0}},
        {"size": 8, "phase_ms": {"h_scalars": 3200.0, "blind": 740.0}},
        {"size": 4, "phase_ms": {"h_scalars": 1600.0, "blind": 360.0}},
    ])
    assert reader("blind_ms")(obs) == pytest.approx(1800.0 / 20)


@pytest.mark.parametrize("name", ["lock_wait_ms", "proof_ms", "witness_cpu_ms", "blind_ms"])
def test_a_window_without_the_spans_reads_none(name):
    old = breakdown()
    del old["spans"], old["request_id"]
    for obs in (served(), served(old),
                Observations(device_kind="x", startup_s={}, batches=[{"size": 8, "phase_ms": {"h_scalars": 1.0}}])):
        assert reader(name)(obs) is None


def test_the_batched_service_has_no_lock_wait():
    b = breakdown()
    b["spans"] = [s for s in b["spans"] if s[0] not in ("prove_lock_wait", "prove")] + [
        ["batch_queue_wait", 100.0, 100.2, 0.0]]
    obs = served(b)
    assert reader("lock_wait_ms")(obs) is None and reader("proof_ms")(obs) is None
    assert reader("witness_cpu_ms")(obs) == pytest.approx(600.0)
