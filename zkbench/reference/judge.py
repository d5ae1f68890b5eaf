"""The comparison that decides `correct`.

Every answer is judged by what it says, against the statement worked out
here from the request alone:

- a served answer (POST /v0/prove) has status 200, carries the request's
  public-inputs hash, a proof that passes the Groth16 pairing check under
  the setup's verification key against that hash, and a training-wheels
  signature over (proof, hash) that verifies under the key's public half;
- a bare proof (BatchProver.prove) passes the same pairing check against
  the hash of the request its witness was made from;
- the verification key that the pairing check uses is the one that the
  proving key the service loaded carries (`vk_mismatch`).

Each of these is an exact check, so each number compared counts answers
that fail it, and its limit is 0. The functions take and return plain
data so that a pool of processes can run them.
"""

from __future__ import annotations

from . import ed25519
from .encoding import decompress_g1, decompress_g2, proof_json, signature_from_bcs, signing_message
from .keyless import public_inputs_hash
from .pairing import verify_groth16

# The numbers compared, in the order they are printed; each limit is 0.
CHECKS = ("unanswered", "bad_hash", "bad_proof", "bad_signature", "tamper_accepted", "vk_mismatch")
LIMITS = {name: 0 for name in CHECKS}


def statement(request: dict, modulus: int, circuit: dict) -> int:
    return public_inputs_hash(request, modulus, circuit["max_lengths"], circuit["max_committed_epk_bytes"])


def judge_served(task: dict) -> dict:
    """task: request, modulus, circuit, vk, tw_pk (bytes), status,
    payload -> {check name: 0 or 1}."""
    bad = dict.fromkeys(CHECKS[:4], 0)
    payload = task["payload"]
    if task["status"] != 200 or not isinstance(payload, dict):
        bad["unanswered"] = 1
        return bad
    want = statement(task["request"], task["modulus"], task["circuit"])
    try:
        got = int.from_bytes(bytes.fromhex(payload["public_inputs_hash"]), "little")
        a_b, b_b, c_b = (bytes(payload["proof"][k]) for k in ("a", "b", "c"))
        pts = decompress_g1(a_b), decompress_g2(b_b), decompress_g1(c_b)
        sig = signature_from_bcs(bytes.fromhex(payload["training_wheels_signature"]))
    except (KeyError, TypeError, ValueError):
        return {**bad, "bad_hash": 1, "bad_proof": 1, "bad_signature": 1}
    bad["bad_hash"] = int(got != want)
    bad["bad_proof"] = int(None in pts or not verify_groth16(task["vk"], [want], proof_json(*pts)))
    bad["bad_signature"] = int(not ed25519.verify(task["tw_pk"], signing_message(a_b, b_b, c_b, want), sig))
    return bad


def judge_proof(task: dict) -> dict:
    """task: request, modulus, circuit, vk, proof ((a, b, c) affine points
    as plain ints, or None when no proof came) -> {check name: 0 or 1}."""
    bad = dict.fromkeys(CHECKS[:4], 0)
    if task["proof"] is None:
        bad["unanswered"] = 1
        return bad
    want = statement(task["request"], task["modulus"], task["circuit"])
    a, b, c = task["proof"]
    bad["bad_proof"] = int(None in (a, b, c) or not verify_groth16(task["vk"], [want], proof_json(a, b, c)))
    return bad


def vk_mismatch(vk: dict, key_vk: dict) -> int:
    """1 where the snarkjs verification-key JSON `vk` differs from the
    points that the proving key carries (`key_vk`: alpha1, beta2, gamma2,
    delta2 and, where the key keeps them, the IC points, in standard form,
    None at infinity), else 0."""

    def g1(v):
        return None if int(v[-1]) == 0 else (int(v[0]), int(v[1]))

    def g2(v):
        return None if (int(v[2][0]), int(v[2][1])) == (0, 0) else \
            ((int(v[0][0]), int(v[0][1])), (int(v[1][0]), int(v[1][1])))

    same = (g1(vk["vk_alpha_1"]) == key_vk["alpha1"] and g2(vk["vk_beta_2"]) == key_vk["beta2"]
            and g2(vk["vk_gamma_2"]) == key_vk["gamma2"] and g2(vk["vk_delta_2"]) == key_vk["delta2"])
    if key_vk["ic"]:
        same = same and [g1(p) for p in vk["IC"]] == key_vk["ic"]
    return int(not same)


def tally(results: list[dict], tamper_accepted: int | None = None, vk_bad: int | None = None) -> dict:
    """Sum the per-answer flags into the numbers compared."""
    counts = {name: sum(r.get(name, 0) for r in results) for name in CHECKS[:4]}
    if tamper_accepted is not None:
        counts["tamper_accepted"] = tamper_accepted
    if vk_bad is not None:
        counts["vk_mismatch"] = vk_bad
    return counts


def verdict(counts: dict) -> bool:
    return all(counts[name] <= LIMITS[name] for name in counts)
