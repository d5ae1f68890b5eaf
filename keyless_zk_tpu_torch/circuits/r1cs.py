"""R1CS constraint-system builder with an integrated witness program.

A jax-free copy of keyless_zk_tpu/circuits/r1cs.py, cut to what the port's
setup path and its tests use: wires, linear combinations, constraints, the
`input`, `mul` and `lc` witness ops, witness evaluation and checking. The
keyless gadgets (bits, big-integer and hash ops) are not in the port.

Wire layout follows circom/snarkjs: wire 0 is the constant one, wires
1..n_public are public, the rest private. Constraints are a*b = c with each
side a sparse linear combination over wires.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..fields import bn254
from ..fields.limbs import ints_to_limbs

P = bn254.R_SCALAR


class LinComb(dict):
    """Sparse linear combination {wire: coef mod p}; immutable by convention."""

    def __add__(self, other: "LinComb") -> "LinComb":
        out = LinComb(self)
        for w, c in other.items():
            v = (out.get(w, 0) + c) % P
            if v:
                out[w] = v
            else:
                out.pop(w, None)
        return out

    def __sub__(self, other: "LinComb") -> "LinComb":
        return self + other.scale(P - 1)

    def scale(self, k: int) -> "LinComb":
        k %= P
        if k == 0:
            return LinComb()
        return LinComb({w: (c * k) % P for w, c in self.items()})


@dataclass
class Constraint:
    a: LinComb
    b: LinComb
    c: LinComb


class ConstraintSystem:
    """Builder for an R1CS instance + its witness-generation program, an
    ordered list of (opcode, params, out_wires, in_lcs) that
    `compute_witness` runs in insertion order."""

    def __init__(self):
        self.n_wires = 1  # wire 0 == 1
        self.n_public = 0  # public wires are 1..n_public (allocated first)
        self.constraints: list[Constraint] = []
        self.ops: list[tuple] = []

    # ---- wires -----------------------------------------------------------

    def new_wire(self) -> int:
        w = self.n_wires
        self.n_wires += 1
        return w

    def new_wires(self, n: int) -> list[int]:
        ws = list(range(self.n_wires, self.n_wires + n))
        self.n_wires += n
        return ws

    def public_wire(self) -> int:
        if self.n_wires != self.n_public + 1:
            raise ValueError("public wires must be allocated before any private wire")
        self.n_public += 1
        return self.new_wire()

    # ---- linear combinations ----------------------------------------------

    def lc(self, *terms) -> LinComb:
        """lc((wire, coef), ...) or lc(wire) for coefficient 1."""
        out = LinComb()
        for t in terms:
            w, c = t if isinstance(t, tuple) else (t, 1)
            v = (out.get(w, 0) + c) % P
            if v:
                out[w] = v
            else:
                out.pop(w, None)
        return out

    def const(self, k: int) -> LinComb:
        return self.lc((0, k % P))

    # ---- constraints -------------------------------------------------------

    def constrain(self, a: LinComb, b: LinComb, c: LinComb) -> None:
        """a * b = c."""
        self.constraints.append(Constraint(a, b, c))

    def constrain_eq(self, a: LinComb, b: LinComb) -> None:
        """a = b   (encoded as a * 1 = b, with linear a)."""
        self.constrain(a - b, self.const(1), LinComb())

    # ---- witness program ---------------------------------------------------

    def op(self, opcode: str, params: tuple, out_wires: list[int], in_lcs) -> None:
        """Register a witness op (see compute_witness)."""
        self.ops.append((opcode, tuple(params), list(out_wires), list(in_lcs)))

    def set_input_hint(self, wires: list[int], name: str) -> None:
        """Wires filled directly from compute_witness(**{name: values})."""
        self.ops.append(("input", (name,), list(wires), []))

    def compute_witness(self, **inputs) -> list[int]:
        """Run the witness program; returns the full wire vector (ints)."""
        w = [0] * self.n_wires
        w[0] = 1

        def ev(lc: LinComb) -> int:
            return sum(c * w[i] for i, c in lc.items()) % P

        for opcode, params, outs, in_lcs in self.ops:
            if opcode == "input":
                vals = inputs[params[0]]
                if isinstance(vals, int):
                    vals = [vals]
                if len(vals) != len(outs):
                    raise ValueError(f"input '{params[0]}': expected {len(outs)} values, got {len(vals)}")
                for o, v in zip(outs, vals):
                    w[o] = v % P
            elif opcode == "mul":
                w[outs[0]] = ev(in_lcs[0]) * ev(in_lcs[1]) % P
            elif opcode == "lc":
                w[outs[0]] = ev(in_lcs[0])
            else:
                raise ValueError(f"unknown witness op {opcode}")
        return w

    def eval_lc(self, lc: LinComb, w: list[int]) -> int:
        return sum(c * w[i] for i, c in lc.items()) % P

    def check_witness(self, w: list[int]) -> int | None:
        """Index of the first violated constraint, or None if satisfied."""
        for q, cn in enumerate(self.constraints):
            if self.eval_lc(cn.a, w) * self.eval_lc(cn.b, w) % P != self.eval_lc(cn.c, w):
                return q
        return None

    # ---- export -------------------------------------------------------------

    def matrices(self) -> tuple[list[dict], list[dict], list[dict]]:
        """(A, B, C) as per-constraint sparse rows {wire: coef}."""
        return (
            [cn.a for cn in self.constraints],
            [cn.b for cn in self.constraints],
            [cn.c for cn in self.constraints],
        )

    # ---- gadget primitives ---------------------------------------------------

    def mul(self, a: LinComb, b: LinComb) -> int:
        """New wire z with constraint a*b = z and hint z = eval(a)*eval(b)."""
        z = self.new_wire()
        self.constrain(a, b, self.lc(z))
        self.op("mul", (), [z], [a, b])
        return z

    def witness_np(self, w: list[int]) -> np.ndarray:
        """Wire vector -> (n, 16) uint32 limb rows for the prover."""
        return ints_to_limbs(w)
