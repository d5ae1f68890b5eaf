"""The port's keyless circuit and its Python witness against the JAX
package's, at the scaled-down configuration SMALL of
tests/test_keyless_circuit.py (484,306 wires, 493,011 constraints), with
exact equality:

- `build_keyless_circuit(SMALL)` gives the same wires, public inputs and
  constraints (A, B, C term for term), and the same witness program op for
  op (the keyless circuit registers no closure);
- the Python `compute_witness` of both packages on one JWT from the port's
  seeded generator is equal wire for wire, for a `sub` and an `email` uid;
  the witness satisfies, its public wire is the public-inputs hash, and the
  port's compiled witness engine gives the same wires;
- a wrong nonce or a flipped signature bit gives equal witnesses in both
  packages that violate a constraint.

Each package's circuit is built once per module (~23 s each on a CPU)."""

import numpy as np
import pytest

from keyless_zk_tpu.circuits.keyless_circuit import build_keyless_circuit as jax_build
from keyless_zk_tpu.circuits.keyless_circuit import to_circuit_config as jax_to_circuit_config
from keyless_zk_tpu.circuits.keyless_circuit import witness_kwargs as jax_witness_kwargs
from keyless_zk_tpu.input_processing.input_signals import derive_circuit_input_signals as jax_derive
from keyless_zk_tpu_torch.circuits.keyless_circuit import build_keyless_circuit, to_circuit_config, witness_kwargs
from keyless_zk_tpu_torch.circuits.witness_engine import CompiledWitnessProgram
from keyless_zk_tpu_torch.input_processing.input_signals import derive_circuit_input_signals
from keyless_zk_tpu_torch.input_processing.testjwt import make_test_jwt
from torch_keyless_fixtures import JAX_SMALL, SMALL, jax_verified_input

UIDS = {"sub": ("sub", "user-1"), "email": ("email", "a@b.io")}


@pytest.fixture(scope="module")
def circuits():
    return build_keyless_circuit(SMALL), jax_build(JAX_SMALL)


def _kwargs(uid: str):
    """The port's and the JAX package's witness inputs for one test JWT,
    and its public-inputs hash (equal in both, else the test fails)."""
    key, val = UIDS[uid]
    tj = make_test_jwt(seed=1, uid_key=key, uid_val=val)
    signals, pub = derive_circuit_input_signals(to_circuit_config(SMALL), tj.vi)
    jsignals, jpub = jax_derive(jax_to_circuit_config(JAX_SMALL), jax_verified_input(tj.vi))
    assert pub == jpub
    return witness_kwargs(signals), jax_witness_kwargs(jsignals), pub


def test_constraint_system_matches_jax(circuits):
    cs, jcs = circuits
    assert (cs.n_wires, cs.n_public, len(cs.constraints)) == (jcs.n_wires, jcs.n_public, len(jcs.constraints))
    assert (cs.n_wires, len(cs.constraints)) == (484_306, 493_011)
    for side in ("a", "b", "c"):
        assert [dict(getattr(q, side)) for q in cs.constraints] == [dict(getattr(q, side)) for q in jcs.constraints]


def test_witness_program_matches_jax(circuits):
    cs, jcs = circuits
    assert [op[0] for op in cs.ops] == [op[0] for op in jcs.ops]
    assert "call" not in {op[0] for op in cs.ops}
    assert [(op[1], op[2], [dict(lc) for lc in op[3]]) for op in cs.ops] == [
        (op[1], op[2], [dict(lc) for lc in op[3]]) for op in jcs.ops
    ]


@pytest.mark.parametrize("uid", sorted(UIDS))
def test_witness_matches_jax_and_satisfies(circuits, uid):
    cs, jcs = circuits
    kw, jkw, pub = _kwargs(uid)
    assert kw == jkw
    w = cs.compute_witness(**kw)
    assert w == jcs.compute_witness(**jkw)
    assert cs.check_witness(w) is None
    assert w[1] == pub
    if uid == "sub":
        prog = CompiledWitnessProgram(cs)
        wires = prog.compute_witness(**kw)
        assert prog.witness_ints(wires) == w
        assert np.array_equal(prog.witness_limbs(wires), cs.witness_np(w))


@pytest.mark.parametrize("tamper", ["wrong nonce", "flipped signature"])
def test_tampered_inputs_fail_in_both(circuits, tamper):
    cs, jcs = circuits
    kw, jkw, _ = _kwargs("sub")
    for k in (kw, jkw):
        if tamper == "wrong nonce":
            k["epk_blinder"] = k["epk_blinder"] + 1
        else:
            k["signature"] = [k["signature"][0] ^ 1] + k["signature"][1:]
    w = cs.compute_witness(**kw)
    assert w == jcs.compute_witness(**jkw)
    assert cs.check_witness(w) is not None
