"""R1CS constraint-system builder with an integrated witness program.

Replaces the circom front end (reference circuit/templates/*.circom compiled
by the external `circom` binary) with native construction: a gadget both adds
constraints and registers the computation that fills in its wires, so a
single definition yields the relation *and* its witness generator — the
role circom's `<==`/`<--` dual plays (e.g. FpMul's long-division hints,
circuit/templates/helpers/rsa/FpMul.circom:55-66).

Wire layout follows circom/snarkjs conventions (zkey_utils.hpp:72-74):
wire 0 is the constant one, wires 1..n_public are public (outputs then
public inputs), the rest private.  Constraints are a*b = c with each side a
sparse linear combination over wires.

A jax-free copy of keyless_zk_tpu/circuits/r1cs.py: the port imports nothing
of the JAX package.
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
    """Builder for an R1CS instance + its witness-generation program.

    The witness program is an ordered list of (fn, out_wires, in_wires)
    hints; `compute_witness` runs them in insertion order.  Gadgets that
    batch their computation (SHA-256 rounds, bigint limbs, ...) register a
    single hint producing many wires at once, which keeps witness
    generation vectorizable.
    """

    def __init__(self):
        self.n_wires = 1  # wire 0 == 1
        self.n_public = 0  # public wires are 1..n_public (must be allocated first)
        self.constraints: list[Constraint] = []
        self._hints: list[tuple] = []  # (fn, out_wires, in_wires)
        self.ops: list[tuple] = []  # structured witness ops (op, params, outs, in_lcs)
        self._labels: dict[str, int | list[int]] = {}

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

    def label(self, name: str, wires) -> None:
        self._labels[name] = wires

    def wires_of(self, name: str):
        return self._labels[name]

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

    def constrain_zero(self, a: LinComb) -> None:
        self.constrain_eq(a, LinComb())

    # ---- witness hints -----------------------------------------------------

    def hint(self, fn, out_wires: list[int], in_wires: list[int]) -> None:
        """Register fn(*in_values) -> sequence of out values (ints mod p).

        Legacy closure form; prefer :meth:`op` — structured ops compile to
        the native witness engine, closures stay on the Python path.
        """
        self.ops.append(("call", (fn,), list(out_wires), [self.lc(w) for w in in_wires]))

    def op(self, opcode: str, params: tuple, out_wires: list[int], in_lcs) -> None:
        """Register a structured witness op (see compute_witness dispatch)."""
        self.ops.append((opcode, tuple(params), list(out_wires), list(in_lcs)))

    def set_input_hint(self, wires: list[int], name: str) -> None:
        """Wires filled directly from compute_witness(**{name: values})."""
        self.ops.append(("input", (name,), list(wires), []))

    # ---- evaluation ---------------------------------------------------------

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
                    raise ValueError(
                        f"input '{params[0]}': expected {len(outs)} values, got {len(vals)}"
                    )
                for o, v in zip(outs, vals):
                    w[o] = v % P
            elif opcode == "mul":
                w[outs[0]] = ev(in_lcs[0]) * ev(in_lcs[1]) % P
            elif opcode == "lc":
                w[outs[0]] = ev(in_lcs[0])
            elif opcode == "bits":
                v = ev(in_lcs[0])
                for j, o in enumerate(outs):
                    w[o] = (v >> j) & 1
            elif opcode == "iszero":
                v = ev(in_lcs[0])
                w[outs[0]] = pow(v, -1, P) if v else 0
                w[outs[1]] = 0 if v else 1
            elif opcode == "onehot":
                v = ev(in_lcs[0])
                offset = params[0]
                for j, o in enumerate(outs):
                    w[o] = 1 if v == j + offset else 0
            elif opcode == "quorem":
                q, r = divmod(ev(in_lcs[0]), params[0])
                w[outs[0]], w[outs[1]] = q % P, r % P
            elif opcode == "bigdiv":
                n_bits, k = params
                mask = (1 << n_bits) - 1
                a, b, m = (
                    sum(ev(in_lcs[j + off]) << (n_bits * j) for j in range(k))
                    for off in (0, k, 2 * k)
                )
                q, r = divmod(a * b, m)
                for j in range(k):
                    w[outs[j]] = (q >> (n_bits * j)) & mask
                    w[outs[k + j]] = (r >> (n_bits * j)) & mask
            elif opcode == "bigcarry":
                n_bits, k = params
                vals = [ev(lc) for lc in in_lcs]
                av, bv, pv, qv, rv = (vals[i * k : (i + 1) * k] for i in range(5))
                L = 2 * k - 1
                conv = [0] * L
                for i in range(k):
                    for j in range(k):
                        conv[i + j] += av[i] * bv[j] - pv[i] * qv[j]
                c = 0
                for j in range(L - 1):
                    c = (conv[j] - (rv[j] if j < k else 0) + c) >> n_bits
                    w[outs[j]] = c % P
            elif opcode == "call":
                vals = params[0](*(ev(lc) for lc in in_lcs))
                if isinstance(vals, int):
                    vals = [vals]
                for o, v in zip(outs, vals):
                    w[o] = v % P
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

    # ---- common gadget primitives -------------------------------------------

    def mul(self, a: LinComb, b: LinComb) -> int:
        """New wire z with constraint a*b = z and hint z = eval(a)*eval(b)."""
        z = self.new_wire()
        self.constrain(a, b, self.lc(z))
        self.op("mul", (), [z], [a, b])
        return z

    def assert_bit(self, w: int) -> None:
        """w * (w - 1) = 0."""
        self.constrain(self.lc(w), self.lc(w) - self.const(1), LinComb())

    def to_bits(self, x: LinComb, n: int) -> list[int]:
        """n new bit wires (LSB first) with sum(2^i b_i) = x and bit checks."""
        bits = self.new_wires(n)
        self.op("bits", (), bits, [x])
        for b in bits:
            self.assert_bit(b)
        acc = LinComb()
        for i, b in enumerate(bits):
            acc = acc + self.lc((b, 1 << i))
        self.constrain_eq(acc, x)
        return bits

    def witness_np(self, w: list[int]) -> np.ndarray:
        """Wire vector -> (n, 16) uint32 limb rows for the device prover."""
        return ints_to_limbs(w)
