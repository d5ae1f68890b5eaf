"""Shared inputs for the port's file, CLI, setup-tool and service tests:
a small chain-circuit setup made by the port (a == b^m, domain 2^3, pinned
toxic values, host-side tables: well under a second), and Groth16 proofs
built from chosen discrete logs, which verify without a prover run."""

import dataclasses

from keyless_zk_tpu.curves import ref_curve
from keyless_zk_tpu_torch.circuits import ConstraintSystem, groth16_setup, r1cs_from_cs
from keyless_zk_tpu_torch.fields import bn254

TOXIC = {"tau": 999, "alpha": 3, "beta": 4, "gamma": 5, "delta": 6}
R = bn254.R_SCALAR


def chain_circuit(m: int = 4):
    """a == b^m with a public and b = 3: (cs, witness ints, public wire)."""
    cs = ConstraintSystem()
    a = cs.public_wire()
    cs.set_input_hint([a], "a")
    b = cs.new_wire()
    cs.set_input_hint([b], "b")
    x = b
    for _ in range(m - 1):
        x = cs.mul(cs.lc(x), cs.lc(b))
    cs.constrain_eq(cs.lc(x), cs.lc(a))
    return cs, cs.compute_witness(a=pow(3, m, R), b=3), a


def small_setup(with_ic: bool = True):
    """(cs, witness, public wire, SetupResult) of the chain circuit; with
    `with_ic` the key carries the vk's IC points in zkey section 3, as a
    snarkjs zkey does."""
    cs, w, a = chain_circuit()
    res = groth16_setup(r1cs_from_cs(cs), toxic=TOXIC, device="cpu")
    if with_ic:
        ic = tuple((int(p[0]), int(p[1])) for p in res.vk["IC"])
        res = dataclasses.replace(res, pk=dataclasses.replace(res.pk, vk_ic=ic))
    return cs, w, a, res


def scalar_proof(public: int, seed: int = 1):
    """(vk, proof JSON) of a Groth16 statement built from discrete logs:
    alpha, beta, gamma, delta, two IC points and a, b chosen; c solves
    a b = alpha beta + (ic0 + public ic1) gamma + c delta, so the pairing
    check holds for `public` and for no other input."""
    g1, g2 = ref_curve.G1, ref_curve.G2
    alpha, beta, gamma, delta, ic0, ic1, a, b = (pow(7 + seed, k + 3, R) for k in range(8))
    c = (a * b - alpha * beta - (ic0 + public * ic1) * gamma) * pow(delta, -1, R) % R

    def p1(k):
        x, y = g1.mul(ref_curve.G1_GEN, k)
        return [str(x), str(y), "1"]

    def p2(k):
        (x0, x1), (y0, y1) = g2.mul(ref_curve.G2_GEN, k)
        return [[str(x0), str(x1)], [str(y0), str(y1)], ["1", "0"]]

    vk = {"protocol": "groth16", "curve": "bn128", "nPublic": 1, "vk_alpha_1": p1(alpha), "vk_beta_2": p2(beta),
          "vk_gamma_2": p2(gamma), "vk_delta_2": p2(delta), "IC": [p1(ic0), p1(ic1)]}
    proof = {"pi_a": p1(a), "pi_b": p2(b), "pi_c": p1(c), "protocol": "groth16"}
    return vk, proof
