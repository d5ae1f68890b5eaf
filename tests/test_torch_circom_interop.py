"""The port's circom interop (keyless_zk_tpu_torch/circuits/circom_interop.py)
against the JAX package's, on the same in-repo files (the port's save_r1cs of
a circom-order chain with an is_zero and a circom-form Num2Bits, a
hand-written .sym and input.json):

- `load_sym` (a signal optimised out as wire -1, a blank line) and
  `input_assignments` by name and by position, arrays included: equal maps,
  and the same KeyError for a signal the table lacks;
- `solve_witness` on the chain alone (the solver has no Num2Bits or IsZero
  lowering): equal witnesses, the native one under the permutation, and
  "violated" from both when the inputs break a constraint;
- `witness_from_input_json`: equal witnesses, through the compiled program,
  kept in a temporary cache root: compiled once, then loaded from
  `<root>/<digest>.npz`; a compile that fails is remembered for the process
  (no second compile, nothing written), and the Python solver serves the
  witness: from a .sym that maps a hint wire the compiler cannot solve, and
  when the compiled program fails at run time (a zero divisor)."""

import json

import numpy as np
import pytest

import torch_circom_fixtures as cf
from keyless_zk_tpu.circuits import circom_interop as jax_ci
from keyless_zk_tpu_torch.circuits import circom_interop, circom_witness
from keyless_zk_tpu_torch.circuits.r1cs_file import save_r1cs

PORT = "keyless_zk_tpu_torch"
M = 100


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("circom")
    cs, r, perm, bits, x = cf.circom_chain(PORT, M)
    paths = cf.write_circom_files(d, r, M)
    return cs, r, perm, paths


@pytest.fixture(scope="module")
def plain(tmp_path_factory):
    """The chain alone, without is_zero or Num2Bits: every constraint is a
    propagation step, which the Python solver completes."""
    from keyless_zk_tpu_torch.circuits.r1cs_file import r1cs_circom_order

    d = tmp_path_factory.mktemp("plain")
    cs, *_ = cf.chain(PORT, M, iszero=False)
    r, perm = r1cs_circom_order(cs)
    return cs, r, perm, cf.write_circom_files(d, r, M)


@pytest.fixture
def cache_root(tmp_path, monkeypatch):
    """The port's program cache in a temporary root, the negative cache
    empty, and the JAX package's program cache under a temporary HOME."""
    root = tmp_path / "circom_witness"
    monkeypatch.setattr(circom_interop, "CACHE_ROOT", root)
    monkeypatch.setattr(circom_interop, "_FAILED_COMPILES", set())
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    return root


def count_compiles(monkeypatch) -> list:
    compiles = []
    real = circom_witness.CircomWitnessProgram.__init__

    def counted(self, r1cs):
        compiles.append(r1cs.n_constraints)
        real(self, r1cs)

    monkeypatch.setattr(circom_witness.CircomWitnessProgram, "__init__", counted)
    return compiles


def test_load_sym_matches_jax(tmp_path):
    sym = tmp_path / "t.sym"
    sym.write_text("1,1,0,main.a\n\n2,2,0,main.b\n3,-1,0,main.c\n4,5,1,main.sub.x\nbad line\n")
    assert circom_interop.load_sym(str(sym)) == jax_ci.load_sym(str(sym)) == {"main.a": 1, "main.b": 2,
                                                                               "main.sub.x": 5}


def test_input_assignments_by_name_and_position(files):
    _, r, _, paths = files
    jr = jax_ci.load_r1cs(paths["circuit.r1cs"])
    table = circom_interop.load_sym(paths["circuit.sym"])
    with open(paths["input.json"]) as f:
        inputs = json.load(f)
    reordered = {"b": inputs["b"], "a": inputs["a"]}
    by_name = circom_interop.input_assignments(r, reordered, sym=table)
    assert by_name == jax_ci.input_assignments(jr, reordered, sym=table) == {1: int(inputs["a"]), 2: cf.B}
    positional = circom_interop.input_assignments(r, inputs)
    assert positional == jax_ci.input_assignments(jr, inputs) == by_name
    # arrays: by name through v[i], by position flattened; a value past p reduced
    arr_table = {"main.v[0]": 4, "main.v[1]": 6, "main.s": 3}
    arr = {"v": [[cf.R + 5], ["7"]], "s": 9}
    assert circom_interop.input_assignments(r, arr, sym=arr_table) == jax_ci.input_assignments(
        jr, arr, sym=arr_table) == {4: 5, 6: 7, 3: 9}
    assert circom_interop.input_assignments(r, arr) == jax_ci.input_assignments(jr, arr) == {1: 5, 2: 7, 3: 9}
    for fn, rr in ((circom_interop.input_assignments, r), (jax_ci.input_assignments, jr)):
        with pytest.raises(KeyError, match=r"main.w\[1\]"):
            fn(rr, {"w": [1, 2]}, sym={"main.w[0]": 1})


def test_solve_witness_matches_jax_and_detects_violation(plain):
    cs, r, perm, paths = plain
    jr = jax_ci.load_r1cs(paths["circuit.r1cs"])
    inputs = {k: int(v) for k, v in cf.chain_inputs(M).items()}
    known = {1: inputs["a"], 2: inputs["b"]}
    w = circom_interop.solve_witness(r, known)
    assert w.dtype == object
    assert list(w) == list(jax_ci.solve_witness(jr, known))
    native = cs.compute_witness(**inputs)
    assert [w[perm[i]] for i in range(cs.n_wires)] == native
    bad = {1: inputs["a"] + 1, 2: inputs["b"]}
    for solve, rr in ((circom_interop.solve_witness, r), (jax_ci.solve_witness, jr)):
        with pytest.raises(ValueError, match="violated"):
            solve(rr, bad)


def test_witness_from_input_json_compiles_once_and_matches_jax(files, cache_root, monkeypatch):
    cs, r, perm, paths = files
    compiles = count_compiles(monkeypatch)
    args = (paths["circuit.r1cs"], paths["input.json"], paths["circuit.sym"])
    w = circom_interop.witness_from_input_json(*args)
    cached = cache_root / f"{circom_interop.r1cs_digest(paths['circuit.r1cs'])}.npz"
    assert compiles == [r.n_constraints] and cached.exists()
    assert list(circom_interop.witness_from_input_json(*args)) == list(w)
    assert list(circom_interop.witness_from_input_json(*args[:2])) == list(w)
    assert compiles == [r.n_constraints], "the cached program was compiled again"
    assert list(w) == list(jax_ci.witness_from_input_json(*args))
    native = cs.compute_witness(**{k: int(v) for k, v in cf.chain_inputs(M).items()})
    assert [w[perm[i]] for i in range(cs.n_wires)] == native


def test_failed_compile_is_remembered_and_the_solver_serves(tmp_path, cache_root, monkeypatch):
    """h * h = x has no lowering, so the compile fails; the .sym maps main.h
    to the hint wire, and the solver completes y = h x from x and h."""
    r = cf.make_r1cs(PORT, 4, 0, 0, 1, [({2: 1}, {2: 1}, {1: 1}), ({2: 1}, {1: 1}, {3: 1})])
    paths = {k: str(tmp_path / k) for k in ("h.r1cs", "h.json", "h.sym")}
    save_r1cs(paths["h.r1cs"], r)
    with open(paths["h.json"], "w") as f:
        json.dump({"x": 49, "h": 7}, f)
    with open(paths["h.sym"], "w") as f:
        f.write("1,1,0,main.x\n2,2,0,main.h\n3,3,0,main.y\n")
    compiles = count_compiles(monkeypatch)
    args = (paths["h.r1cs"], paths["h.json"], paths["h.sym"])
    w = circom_interop.witness_from_input_json(*args)
    assert list(w) == [1, 49, 7, 343]
    assert circom_interop.r1cs_digest(paths["h.r1cs"]) in circom_interop._FAILED_COMPILES
    assert list(circom_interop.witness_from_input_json(*args)) == list(w)
    assert len(compiles) == 1, "a failed compile was tried again"
    assert not cache_root.exists() or not list(cache_root.iterdir())
    assert list(jax_ci.witness_from_input_json(*args)) == list(w)
    with pytest.raises(ValueError, match="previously failed"):
        circom_interop._cached_program(r, paths["h.r1cs"])


def test_runtime_failure_falls_back_to_the_solver(tmp_path, cache_root):
    """x * b = c and x * e = f: the compiler divides by b, which is 0 here,
    so the program raises and the solver divides by e instead."""
    r = cf.make_r1cs(PORT, 6, 0, 0, 4, [({5: 1}, {1: 1}, {2: 1}), ({5: 1}, {3: 1}, {4: 1})])
    known = {1: 0, 2: 0, 3: 2, 4: 6}
    with pytest.raises(RuntimeError, match="witness engine failed"):
        circom_witness.CircomWitnessProgram(r).compute(known)
    paths = {k: str(tmp_path / k) for k in ("d.r1cs", "d.json")}
    save_r1cs(paths["d.r1cs"], r)
    with open(paths["d.json"], "w") as f:
        json.dump({"b": 0, "c": 0, "e": 2, "f": 6}, f)
    w = circom_interop.witness_from_input_json(*paths.values())
    assert list(w) == list(circom_interop.solve_witness(r, known)) == [1, 0, 0, 2, 6, 3]
    assert list(jax_ci.witness_from_input_json(*paths.values())) == list(w)


def test_corrupt_cache_entry_is_recompiled(files, cache_root, monkeypatch):
    _, r, _, paths = files
    cache_root.mkdir(parents=True)
    entry = cache_root / f"{circom_interop.r1cs_digest(paths['circuit.r1cs'])}.npz"
    entry.write_bytes(b"not an npz")
    compiles = count_compiles(monkeypatch)
    w = circom_interop.witness_from_input_json(paths["circuit.r1cs"], paths["input.json"])
    assert compiles == [r.n_constraints]
    assert np.load(entry)["op_table"].shape[0] > 0
    assert list(w) == circom_witness.CircomWitnessProgram(r).compute_ints({1: int(cf.chain_inputs(M)["a"]), 2: cf.B})
