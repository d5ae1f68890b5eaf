"""Circom-order circuits for the port's circom tests, built the same way in
either package: the chain a == b^m (a public, b private; one product per
constraint), an `is_zero` of a chain value, exported with
`r1cs_circom_order`, and, appended to the exported R1CS, a circom-form
Num2Bits of a chain wire (booleanity rows b (b - 1) = 0 and one linear row
0 * 0 = sum 2^i b_i - x), the form the compiler's `bits` lowering reads and
the native `to_bits` does not write. Also the hand-built instances of the
JAX package's tests/test_circom_witness.py and the files of a circom route:
.r1cs, input.json and a .sym table naming main.a and main.b."""

import importlib
import json

from keyless_zk_tpu_torch.fields.bn254 import R_SCALAR as R

B = 3


def chain(pkg: str, m: int, iszero: bool = True, to_bits: bool = False):
    """(cs, a, b, x) in package `pkg`: the chain a == b^m, x the wire of
    b^(m // 2); with `iszero` an is_zero of x, with `to_bits` the native
    `to_bits(x, 8)` (compiled only: x does not fit 8 bits)."""
    circuits = importlib.import_module(f"{pkg}.circuits")
    gadgets = importlib.import_module(f"{pkg}.circuits.gadgets")
    cs = circuits.ConstraintSystem()
    a = cs.public_wire()
    cs.set_input_hint([a], "a")
    b = cs.new_wire()
    cs.set_input_hint([b], "b")
    y, mid = b, b
    for k in range(2, m + 1):
        y = cs.mul(cs.lc(y), cs.lc(b))
        if k == m // 2:
            mid = y
    cs.constrain_eq(cs.lc(y), cs.lc(a))
    if iszero:
        gadgets.is_zero(cs, cs.lc(mid))
    if to_bits:
        cs.to_bits(cs.lc(mid), 8)
    return cs, a, b, mid


def append_num2bits(r1cs, x: int, n: int) -> list[int]:
    """Append a circom-form Num2Bits(n) of wire x to `r1cs` in place; returns
    the n new bit wires (LSB first)."""
    p = r1cs.prime
    bits = list(range(r1cs.n_wires, r1cs.n_wires + n))
    for w in bits:
        r1cs.A.append({w: 1})
        r1cs.B.append({w: 1, 0: p - 1})
        r1cs.C.append({})
    r1cs.A.append({})
    r1cs.B.append({})
    r1cs.C.append({w: pow(2, i, p) for i, w in enumerate(bits)} | {x: p - 1})
    r1cs.n_wires += n
    r1cs.n_constraints += n + 1
    return bits


def circom_chain(pkg: str, m: int, n_bits: int = 254):
    """(cs, r1cs, perm, bits, x) of the circom-order chain of package `pkg`
    with a Num2Bits(n_bits) of the chain wire x (in circom order) appended."""
    r1cs_file = importlib.import_module(f"{pkg}.circuits.r1cs_file")
    cs, _, _, mid = chain(pkg, m)
    r1cs, perm = r1cs_file.r1cs_circom_order(cs)
    bits = append_num2bits(r1cs, perm[mid], n_bits)
    return cs, r1cs, perm, bits, perm[mid]


def chain_inputs(m: int) -> dict:
    """The chain's input.json: b = 3 and a = 3^m, as circom's decimal strings."""
    return {"a": str(pow(B, m, R)), "b": str(B)}


def write_circom_files(d, r1cs, m: int) -> dict:
    """circuit.r1cs (the port's save_r1cs), input.json and circuit.sym in
    directory d: {name: path}."""
    from keyless_zk_tpu_torch.circuits.r1cs_file import save_r1cs

    paths = {k: str(d / k) for k in ("circuit.r1cs", "input.json", "circuit.sym")}
    save_r1cs(paths["circuit.r1cs"], r1cs)
    with open(paths["input.json"], "w") as f:
        json.dump(chain_inputs(m), f)
    # circom's .sym lines: #signal, #wire, #component, name; a is the one
    # public input (wire 1), b the one private input (wire 2)
    with open(paths["circuit.sym"], "w") as f:
        f.write("1,1,0,main.a\n2,2,0,main.b\n3,-1,0,main.unused\n")
    return paths


def make_r1cs(pkg: str, n_wires, n_pub_out, n_pub_in, n_prv_in, rows):
    r1cs_file = importlib.import_module(f"{pkg}.circuits.r1cs_file")
    a, b, c = zip(*rows) if rows else ([], [], [])
    return r1cs_file.R1CS(prime=R, n_wires=n_wires, n_pub_out=n_pub_out, n_pub_in=n_pub_in, n_prv_in=n_prv_in,
                          n_constraints=len(rows), A=list(a), B=list(b), C=list(c))


def num2bits_rows(m: int = 5):
    """wires: 0 = 1, 1 = x (private input), 2.. = m bits."""
    rows = [({w: 1}, {w: 1, 0: R - 1}, {}) for w in range(2, 2 + m)]
    rows.append(({}, {}, {2 + i: pow(2, i, R) for i in range(m)} | {1: R - 1}))
    return (2 + m, 0, 0, 1, rows)


# The hand-built instances of tests/test_circom_witness.py, as (n_wires,
# n_pub_out, n_pub_in, n_prv_in, rows), with the input assignments run.
HAND_BUILT = {
    "num2bits": (num2bits_rows(), [{1: x} for x in (0, 1, 19, 31)]),
    # wires: 0 = 1, 1 = out (public output), 2 = in (private input), 3 = inv
    "iszero": ((4, 1, 0, 1, [({2: R - 1}, {3: 1}, {1: 1, 0: R - 1}), ({2: 1}, {1: 1}, {})]), [{2: 0}, {2: 7}]),
    # x * b = c with b, c known: a runtime division
    "divsub": ((4, 0, 0, 2, [({3: 1}, {1: 1}, {2: 1})]), [{1: 6, 2: 42}]),
    # a * b = c, all of a, b inputs
    "violation": ((4, 0, 0, 2, [({1: 1}, {2: 1}, {3: 1})]), [{1: 3, 2: 5}]),
}
# R1CS the compiler refuses: x * x = y beyond the inputs, and a square root
# (h * h = x with x an input), a hint no lowering recognises
UNSOLVABLE = {
    "underdetermined": (4, 0, 0, 1, [({2: 1}, {2: 1}, {3: 1})]),
    "sqrt_hint": (4, 0, 0, 1, [({2: 1}, {2: 1}, {1: 1}), ({2: 1}, {1: 1}, {3: 1})]),
}
