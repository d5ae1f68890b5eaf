"""The port's compiled witness engine (circuits/witness_engine.py, its own
copy of the C engine) against its Python `compute_witness` and the JAX
package's engine, on the gadget circuit of keyless_gadget_circuit.py: every
witness opcode, the Python callbacks (bigdiv, bigcarry and a closure)
included, with and without one SHA-256 compression.

Exact equality throughout: the wires, the compiled tables, the index of the
first violated constraint of a tampered witness, a program saved and loaded
again."""

from pathlib import Path

import numpy as np
import pytest

import keyless_gadget_circuit as kg
import keyless_zk_tpu_torch
from keyless_zk_tpu.circuits.witness_engine import CompiledWitnessProgram as JaxProgram
from keyless_zk_tpu.hashes import poseidon_hash as jax_poseidon_hash
from keyless_zk_tpu_torch.circuits import ConstraintSystem
from keyless_zk_tpu_torch.circuits.rsa_gadget import fp_mul
from keyless_zk_tpu_torch.circuits.witness_engine import CompiledWitnessProgram, _build_lib
from keyless_zk_tpu_torch.hashes import poseidon_hash

TABLES = ("op_table", "out_wires", "lc_offsets", "lc_wires", "lc_coefs")


@pytest.fixture(scope="module", params=[False, True], ids=["gadgets", "gadgets+sha256"])
def programs(request):
    sha = request.param
    cs, outs = kg.build("keyless_zk_tpu_torch", "engine", sha)
    jcs, _ = kg.build("keyless_zk_tpu", "engine", sha)
    kw = kg.inputs(poseidon_hash, "engine", sha)
    assert kw == kg.inputs(jax_poseidon_hash, "engine", sha)
    return sha, cs, outs, CompiledWitnessProgram(cs), jcs, JaxProgram(jcs), kw


def test_engine_runs_every_opcode(programs):
    _, cs, _, _, _, _, _ = programs
    assert {op[0] for op in cs.ops} == {"input", "lc", "mul", "bits", "iszero", "onehot", "quorem", "bigdiv",
                                        "bigcarry", "call"}


def test_engine_matches_python_and_jax(programs):
    sha, cs, outs, prog, jcs, jprog, kw = programs
    wires = prog.compute_witness(**kw)
    w = cs.compute_witness(**kw)
    assert prog.witness_ints(wires) == w
    assert np.array_equal(wires, jprog.compute_witness(**kw))
    assert w == jcs.compute_witness(**kw)
    assert prog.check_witness(wires) is None
    assert np.array_equal(prog.witness_limbs(wires), cs.witness_np(w))
    for name, want in kg.expected("engine", sha).items():
        got = [w[o] for o in outs[name]] if isinstance(outs[name], list) else w[outs[name]]
        assert got == want, name


def test_compiled_tables_match_jax(programs):
    _, _, _, prog, _, jprog, _ = programs
    for name in TABLES:
        assert np.array_equal(getattr(prog, name), getattr(jprog, name)), name
    assert prog._input_slots == jprog._input_slots
    assert [(i, op) for i, (op, _) in sorted(prog._py_ops.items())] == [
        (i, op) for i, (op, _) in sorted(jprog._py_ops.items())]


@pytest.mark.parametrize("wire", [1, "inverse", "fp_mul"])
def test_tampered_witness_fails_at_the_same_constraint(programs, wire):
    _, cs, outs, prog, _, jprog, kw = programs
    wires = prog.compute_witness(**kw)
    w = wire if isinstance(wire, int) else (outs[wire][0] if isinstance(outs[wire], list) else outs[wire])
    wires[w, 0] ^= 1
    bad = prog.check_witness(wires)
    assert bad is not None
    assert bad == jprog.check_witness(wires) == cs.check_witness(prog.witness_ints(wires))


def test_wrong_input_length_is_refused(programs):
    _, _, _, prog, _, _, kw = programs
    with pytest.raises(ValueError, match="digits"):
        prog.compute_witness(**dict(kw, digits=kw["digits"][:-1]))


def test_save_load_roundtrip(tmp_path):
    """A program without closures saves and loads to the same witness; a
    loaded program has no circuit to check against; a closure refuses to
    be saved."""
    k = 4
    cs = ConstraintSystem()
    limbs = {name: cs.new_wires(k) for name in ("a", "b", "p")}
    for name, ws in limbs.items():
        cs.set_input_hint(ws, name)
        for w in ws:
            cs.to_bits(cs.lc(w), kg.FP_BITS)
    fp_mul(cs, limbs["a"], limbs["b"], limbs["p"], kg.FP_BITS, k)
    kw = {"a": kg._limbs(kg.FP_A, k), "b": kg._limbs(kg.FP_B, k), "p": kg._limbs(kg.FP_MOD[k], k)}
    prog = CompiledWitnessProgram(cs)
    want = prog.compute_witness(**kw)
    path = str(tmp_path / "program.npz")
    prog.save(path)
    loaded = CompiledWitnessProgram.load(path)
    assert loaded.cs is None
    assert np.array_equal(loaded.compute_witness(**kw), want)
    with pytest.raises(RuntimeError, match="ConstraintSystem"):
        loaded.check_witness(want)
    gadgets, _ = kg.build("keyless_zk_tpu_torch", "setup")
    with pytest.raises(ValueError, match="not serializable"):
        CompiledWitnessProgram(gadgets).save(str(tmp_path / "closure.npz"))


def test_engine_builds_beside_the_package():
    """Into build/witness_engine/<hash>/ of the checkout, once."""
    lib = _build_lib()
    assert lib.parents[2] == Path(keyless_zk_tpu_torch.__file__).resolve().parent.parent / "build"
    assert lib.parts[-3] == "witness_engine" and lib.exists()
    assert _build_lib() == lib
