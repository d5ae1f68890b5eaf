"""The port's circom witness compiler (keyless_zk_tpu_torch/circuits/
circom_witness.py) against the JAX package's, on the same R1CS instances:

- the hand-built instances of tests/test_circom_witness.py (Num2Bits,
  IsZero, a runtime division, a violated constraint): equal op lists, equal
  witnesses, the same verdict of `check`;
- R1CS the compiler refuses (x * x = y beyond the inputs, a square-root
  hint): ValueError in both, "underdetermined";
- a circom-order chain (a == b^m, an is_zero of a chain value, a circom-form
  Num2Bits(254) appended): the same op list in both, with the `fms`,
  `iszero` and `bits` ops; the witness equal to the native witness under the
  circom permutation, its bits those of the value, `check` satisfied;
- the native `to_bits` rows, which are not circom's form: ValueError in
  both compilers;
- a program saved and loaded again computes the same witness.

Exact equality throughout (field elements)."""

import numpy as np
import pytest

import torch_circom_fixtures as cf
from keyless_zk_tpu.circuits import circom_witness as jax_cw
from keyless_zk_tpu.circuits.r1cs_file import r1cs_circom_order as jax_circom_order
from keyless_zk_tpu_torch.circuits import circom_witness
from keyless_zk_tpu_torch.circuits.r1cs_file import r1cs_circom_order

PORT, JAX = "keyless_zk_tpu_torch", "keyless_zk_tpu"
M = 760  # 759 products, the equality, 2 is_zero rows and 255 Num2Bits rows: domain 2^10


def ops_of(program_cs) -> list:
    return [(op, tuple(params), list(outs), [dict(lc) for lc in lcs]) for op, params, outs, lcs in program_cs.ops]


def compile_both(spec):
    r, jr = cf.make_r1cs(PORT, *spec), cf.make_r1cs(JAX, *spec)
    got = circom_witness.CircomWitnessCompiler(r).compile()
    want = jax_cw.CircomWitnessCompiler(jr).compile()
    return r, jr, got, want


@pytest.mark.parametrize("name", sorted(cf.HAND_BUILT))
def test_hand_built_instances_match_jax(name):
    spec, assignments = cf.HAND_BUILT[name]
    r, jr, got, want = compile_both(spec)
    assert ops_of(got) == ops_of(want)
    assert got.n_wires == want.n_wires
    prog, jprog = circom_witness.CircomWitnessProgram(r), jax_cw.CircomWitnessProgram(jr)
    for known in assignments:
        w = prog.compute(known)
        assert prog.compute_ints(known) == jprog.compute_ints(known)
        assert prog.check(w) is None
    if name == "num2bits":
        for x in (0, 1, 19, 31):
            assert prog.compute_ints({1: x})[2:7] == [(x >> i) & 1 for i in range(5)]
    if name == "iszero":
        assert prog.compute_ints({2: 0})[1::2] == [1, 0]
        assert prog.compute_ints({2: 7})[1::2] == [0, pow(7, -1, cf.R)]
    if name == "divsub":
        assert prog.compute_ints({1: 6, 2: 42})[3] == 7
    if name == "violation":
        bad = prog.compute({1: 3, 2: 5})
        bad[3, 0] ^= 1
        assert prog.check(bad) == jprog.check(bad) == 0


@pytest.mark.parametrize("name", sorted(cf.UNSOLVABLE))
def test_unrecognised_hints_raise_in_both(name):
    spec = cf.UNSOLVABLE[name]
    for compiler, r in ((circom_witness.CircomWitnessProgram, cf.make_r1cs(PORT, *spec)),
                        (jax_cw.CircomWitnessProgram, cf.make_r1cs(JAX, *spec))):
        with pytest.raises(ValueError, match="underdetermined"):
            compiler(r)


@pytest.fixture(scope="module")
def chains():
    return cf.circom_chain(PORT, M), cf.circom_chain(JAX, M)


def test_circom_order_chain_matches_jax_and_the_native_witness(chains):
    (cs, r, perm, bits, x), (_, jr, jperm, jbits, jx) = chains
    assert (r.A, r.B, r.C, r.n_wires, r.n_pub_in, r.n_prv_in) == (jr.A, jr.B, jr.C, jr.n_wires, jr.n_pub_in,
                                                                   jr.n_prv_in)
    assert (perm, bits, x) == (jperm, jbits, jx)
    assert (r.n_constraints + r.n_public).bit_length() == 10  # the setup's domain: 2^10
    got = circom_witness.CircomWitnessCompiler(r).compile()
    assert ops_of(got) == ops_of(jax_cw.CircomWitnessCompiler(jr).compile())
    assert {op for op, *_ in got.ops} == {"input", "fms", "iszero", "mul", "bits"}

    prog = circom_witness.CircomWitnessProgram(r)
    inputs = {k: int(v) for k, v in cf.chain_inputs(M).items()}
    known = {1: inputs["a"], 2: inputs["b"]}
    w = prog.compute_ints(known)
    native = cs.compute_witness(**inputs)
    assert [w[perm[i]] for i in range(cs.n_wires)] == native
    assert [w[b] for b in bits] == [(w[x] >> i) & 1 for i in range(len(bits))]
    assert prog.check(prog.compute(known)) is None
    assert w == jax_cw.CircomWitnessProgram(jr).compute_ints(known)


def test_native_to_bits_is_refused_by_both():
    """`to_bits` writes its sum as (sum - x) * 1 = 0, not circom's 0 * 0 =
    sum - x, so the bits lowering does not read it: the JAX compiler's
    behaviour, which the port keeps."""
    for pkg, order, compiler in ((PORT, r1cs_circom_order, circom_witness.CircomWitnessProgram),
                                 (JAX, jax_circom_order, jax_cw.CircomWitnessProgram)):
        cs, *_ = cf.chain(pkg, 16, iszero=False, to_bits=True)
        r, _ = order(cs)
        with pytest.raises(ValueError, match="8 wires underdetermined"):
            compiler(r)


def test_save_load_round_trip(chains, tmp_path):
    (_, r, _, _, _), _ = chains
    prog = circom_witness.CircomWitnessProgram(r)
    path = str(tmp_path / "prog.npz")
    prog.save(path)
    loaded = circom_witness.CircomWitnessProgram.load(r, path)
    known = {1: pow(cf.B, M, cf.R), 2: cf.B}
    assert np.array_equal(loaded.compute(known), prog.compute(known))
    assert loaded.compute_ints(known) == prog.compute_ints(known)
    with pytest.raises(RuntimeError, match="needs the ConstraintSystem"):
        loaded.check(loaded.compute(known))


def test_witness_program_from_files(chains, tmp_path):
    (_, r, _, _, _), _ = chains
    paths = cf.write_circom_files(tmp_path, r, M)
    prog = circom_witness.witness_program_from_files(paths["circuit.r1cs"])
    known = {1: pow(cf.B, M, cf.R), 2: cf.B}
    assert prog.compute_ints(known) == circom_witness.CircomWitnessProgram(r).compute_ints(known)
