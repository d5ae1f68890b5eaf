"""Compile a foreign circom R1CS into a native witness program.

The reference computes circom-wire-order witnesses by forking the
circom-generated C binary per request (prover-service/src/request_handler/
prover_handler.rs:541-572, wire layout per rust-rapidsnark/rapidsnark/src/
wtns_utils.hpp:11-48). Round 2's interop path (`circom_interop.solve_witness`)
solved the R1CS by *value* propagation in Python — correct, but O(passes x
constraints) bigint work per request, hopeless at 1.4M constraints.

This module does the propagation ONCE, symbolically, at compile time: it
discovers a dependency order in which every wire is computable from already-
known wires, and emits a straight-line program in the native witness-engine
bytecode (native/witness_engine.c). Executing the program per request is
then pure C (4x64 Montgomery arithmetic), independent of Python.

Solve forms (x the single unknown of a constraint A.w * B.w = C.w):
  x in C:      x = eval(A*cc^-1) * eval(B) - eval(C_rest*cc^-1)   [OP_FMS]
  x in A:      x = eval(C*ac^-1) / eval(B) - eval(A_rest*ac^-1)   [OP_DIVSUB]
  x in B:      symmetric                                           [OP_DIVSUB]

Constraint patterns that propagation alone cannot solve (hinted `<--`
assignments in circom) are recognized structurally and lowered to dedicated
engine ops:
  * bit decomposition (circom Num2Bits: booleanity rows b(b-1)=0 plus one
    linear row sum(2^i b_i) = v)                                   [OP_BITS]
  * zero test (circom IsZero: in*inv = 1-out, in*out = 0)          [OP_ISZERO]

Anything still unsolved raises with diagnostics — extend the pattern set
rather than silently producing a partial witness.

A jax-free copy of keyless_zk_tpu/circuits/circom_witness.py: the compiler
emits the same op list, op for op, and the program runs in the port's own
witness engine (keyless_zk_tpu_torch/native/witness_engine.c).
"""

from __future__ import annotations

import numpy as np

from .r1cs import Constraint, LinComb
from .r1cs_file import R1CS, load_r1cs
from .witness_engine import CompiledWitnessProgram

INPUT_SLOT = "circom_inputs"


class _ProgramCS:
    """Minimal ConstraintSystem stand-in for CompiledWitnessProgram."""

    def __init__(self, ops, n_wires, constraints):
        self.ops = ops
        self.n_wires = n_wires
        self.constraints = constraints


def _scale_row(row: dict, k: int, p: int, skip=None) -> dict:
    return {w: (c * k) % p for w, c in row.items() if w != skip}


def _is_pow2_ratio(r: int, p: int, max_bits: int = 254):
    """If r == 2^e mod p with e < max_bits, return e, else None."""
    if r and (r & (r - 1)) == 0 and r.bit_length() <= max_bits:
        return r.bit_length() - 1
    return None


def _booleanity_wire(a: dict, b: dict, c: dict, p: int):
    """If the constraint forces wire w in {0,1} and involves nothing else,
    return w. Checked by evaluating the constraint at w=0,1 (must hold) and
    w=2 (must not): exactly the b(b-1)=0 family in any coefficient dress."""
    vs = (set(a) | set(b) | set(c)) - {0}
    if len(vs) != 1:
        return None
    (w,) = vs

    def ev(row, t):
        return (row.get(0, 0) + row.get(w, 0) * t) % p

    f = lambda t: (ev(a, t) * ev(b, t) - ev(c, t)) % p  # noqa: E731
    if f(0) == 0 and f(1) == 0 and f(2) != 0:
        return w
    return None


class CircomWitnessCompiler:
    def __init__(self, r1cs: R1CS):
        self.r1cs = r1cs
        self.p = r1cs.prime
        self.ops: list = []
        self.n_total = r1cs.n_wires  # grows with temp wires
        self.known = np.zeros(r1cs.n_wires, dtype=bool)
        self.consumed = np.zeros(r1cs.n_constraints, dtype=bool)

    def _temp(self) -> int:
        t = self.n_total
        self.n_total += 1
        return t

    def compile(self) -> "_ProgramCS":
        r = self.r1cs
        p = self.p
        input_wires = list(
            range(1 + r.n_pub_out, 1 + r.n_pub_out + r.n_pub_in + r.n_prv_in)
        )
        self.ops.append(("input", (INPUT_SLOT,), list(input_wires), []))
        self.known[0] = True
        self.known[input_wires] = True

        # booleanity rows never drive the solve loop (their unknown is in two
        # rows); index them for the bits pattern.
        bool_by_wire: dict[int, int] = {}
        for ci in range(r.n_constraints):
            w = _booleanity_wire(r.A[ci], r.B[ci], r.C[ci], p)
            if w is not None and not self.known[w]:
                bool_by_wire[w] = ci

        # per-constraint unknown counts per side + wire adjacency
        ua = [None] * r.n_constraints
        ub = [None] * r.n_constraints
        uc = [None] * r.n_constraints
        adj: dict[int, list[int]] = {}
        for ci in range(r.n_constraints):
            ua[ci] = {w for w in r.A[ci] if not self.known[w]}
            ub[ci] = {w for w in r.B[ci] if not self.known[w]}
            uc[ci] = {w for w in r.C[ci] if not self.known[w]}
            for w in ua[ci] | ub[ci] | uc[ci]:
                adj.setdefault(w, []).append(ci)

        ready = [
            ci
            for ci in range(r.n_constraints)
            if len(ua[ci] | ub[ci] | uc[ci]) == 1
        ]

        def mark_known(w: int):
            if w >= len(self.known) or self.known[w]:
                return
            self.known[w] = True
            for cj in adj.get(w, ()):
                ua[cj].discard(w)
                ub[cj].discard(w)
                uc[cj].discard(w)
                if len(ua[cj] | ub[cj] | uc[cj]) == 1 and not self.consumed[cj]:
                    ready.append(cj)

        deferred: list[int] = []  # single-unknown A/B-side (division) solves

        def try_solve_fms(ci: int) -> bool:
            """Emit the C-side solve (no runtime division — the form circom's
            `<==` assignments always take); defer A/B-side candidates."""
            unk = ua[ci] | ub[ci] | uc[ci]
            if len(unk) != 1:
                return False
            (x,) = unk
            in_a, in_b, in_c = x in ua[ci], x in ub[ci], x in uc[ci]
            A, B, C = r.A[ci], r.B[ci], r.C[ci]
            if in_c and not in_a and not in_b:
                cc_inv = pow(C[x], -1, p)
                self.ops.append(
                    (
                        "fms",
                        (),
                        [x],
                        [
                            _scale_row(A, cc_inv, p),
                            dict(B),
                            _scale_row(C, cc_inv, p, skip=x),
                        ],
                    )
                )
                self.consumed[ci] = True
                mark_known(x)
                return True
            if (in_a ^ in_b) and not in_c:
                deferred.append(ci)
            return False

        def try_solve_div(ci: int) -> bool:
            """Last-resort A/B-side solve x = C/other - rest (runtime division;
            underdetermined if the divisor evaluates to zero)."""
            unk = ua[ci] | ub[ci] | uc[ci]
            if len(unk) != 1:
                return False
            (x,) = unk
            A, B, C = r.A[ci], r.B[ci], r.C[ci]
            if x in ua[ci] and not (x in ub[ci] or x in uc[ci]) and B:
                row, other = A, B
            elif x in ub[ci] and not (x in ua[ci] or x in uc[ci]) and A:
                row, other = B, A
            else:
                return False
            k_inv = pow(row[x], -1, p)
            self.ops.append(
                (
                    "divsub",
                    (),
                    [x],
                    [
                        _scale_row(C, k_inv, p),
                        dict(other),
                        _scale_row(row, k_inv, p, skip=x),
                    ],
                )
            )
            self.consumed[ci] = True
            mark_known(x)
            return True

        def try_bits(ci: int) -> bool:
            """Linear row sum(c0*2^e_j * b_j) + known = 0 with every b_j
            booleanity-constrained and exponents dense 0..m-1 -> OP_BITS."""
            if r.A[ci] or r.B[ci]:
                return False
            C = r.C[ci]
            unk = [w for w in C if not self.known[w]]
            if not unk or any(w not in bool_by_wire for w in unk):
                return False
            # try each unknown's coef as the exponent-0 base
            for base_w in unk:
                c0 = C[base_w]
                c0_inv = pow(c0, -1, p)
                exps = {}
                ok = True
                for w in unk:
                    e = _is_pow2_ratio(C[w] * c0_inv % p, p)
                    if e is None or e in exps.values():
                        ok = False
                        break
                    exps[w] = e
                if ok and sorted(exps.values()) == list(range(len(unk))):
                    break
            else:
                return False
            # sum(2^e b) = eval(known part * -c0^-1)
            lc = _scale_row(
                {w: c for w, c in C.items() if self.known[w]}, p - c0_inv, p
            )
            outs = [w for w, _ in sorted(exps.items(), key=lambda kv: kv[1])]
            self.ops.append(("bits", (), outs, [lc]))
            self.consumed[ci] = True
            for w in outs:
                self.consumed[bool_by_wire[w]] = True
                mark_known(w)
            return True

        def try_iszero(ci: int) -> bool:
            """in*inv = K - cz*z  paired with  in*z' = 0 (same `in` row,
            z' == z): circom IsZero -> OP_ISZERO + two muls."""
            A, B, C = r.A[ci], r.B[ci], r.C[ci]
            if ua[ci] or len(ub[ci]) != 1 or len(uc[ci]) != 1 or len(B) != 1:
                return False
            (inv_w,) = ub[ci]
            (z_w,) = uc[ci]
            if inv_w == z_w:
                return False
            # partner: proportional A row (sign/scale may differ, e.g.
            # -in*inv = out-1 vs in*out = 0), B == {z_w: *}, C empty
            def proportional(row):
                if row.keys() != A.keys() or not A:
                    return False
                w0 = next(iter(A))
                k = row[w0] * pow(A[w0], -1, p) % p
                return all(row[w] == A[w] * k % p for w in A)

            partner = None
            for cj in adj.get(z_w, ()):
                if cj == ci or self.consumed[cj]:
                    continue
                if (
                    r.B[cj].keys() == {z_w}
                    and not r.C[cj]
                    and not ua[cj]
                    and proportional(r.A[cj])
                ):
                    partner = cj
                    break
            if partner is None:
                return False
            cb = B[inv_w]
            cz = C[z_w]
            k_lc = {w: c for w, c in C.items() if w != z_w}  # known part
            t_inv, t_flag = self._temp(), self._temp()
            self.ops.append(("iszero", (), [t_inv, t_flag], [dict(A)]))
            # z = flag * eval(K * -cz^-1)   (A==0 branch of the pair)
            self.ops.append(
                (
                    "mul",
                    (),
                    [z_w],
                    [{t_flag: 1}, _scale_row(k_lc, p - pow(cz, -1, p), p)],
                )
            )
            # inv = A^-1 * eval(K * cb^-1)  (A!=0 branch; A^-1 is 0 when A==0)
            self.ops.append(
                (
                    "mul",
                    (),
                    [inv_w],
                    [{t_inv: 1}, _scale_row(k_lc, pow(cb, -1, p), p)],
                )
            )
            self.consumed[ci] = True
            self.consumed[partner] = True
            mark_known(z_w)
            mark_known(inv_w)
            return True

        # main loop: drain C-side propagation, then pattern passes, then
        # (only if stuck) division solves, repeat to fixpoint
        while True:
            while ready:
                ci = ready.pop()
                if not self.consumed[ci]:
                    try_solve_fms(ci)
            progress = False
            for ci in range(r.n_constraints):
                if self.consumed[ci]:
                    continue
                if ua[ci] or ub[ci] or uc[ci]:
                    if try_bits(ci) or try_iszero(ci):
                        progress = True
            if progress:
                continue  # pattern solves refilled `ready`
            while deferred and not progress:
                ci = deferred.pop()
                if not self.consumed[ci]:
                    progress = try_solve_div(ci)
            if not progress:
                break

        unsolved = np.flatnonzero(~self.known)
        if len(unsolved):
            stuck = [
                ci
                for ci in range(r.n_constraints)
                if not self.consumed[ci] and (ua[ci] or ub[ci] or uc[ci])
            ]
            raise ValueError(
                f"{len(unsolved)} wires underdetermined "
                f"(first: {unsolved[:5].tolist()}); {len(stuck)} stuck "
                f"constraints (first: {stuck[:5]}) — unrecognized hint pattern"
            )

        constraints = [
            Constraint(LinComb(r.A[i]), LinComb(r.B[i]), LinComb(r.C[i]))
            for i in range(r.n_constraints)
        ]
        return _ProgramCS(self.ops, self.n_total, constraints)


class CircomWitnessProgram:
    """Compiled fast path: circom R1CS -> native-engine program.

    compute() returns the witness in circom wire order, standard form,
    shape (n_wires, 4) uint64 — directly consumable by Groth16Prover via
    witness_limbs().
    """

    def __init__(self, r1cs: R1CS):
        self.r1cs = r1cs
        cs = CircomWitnessCompiler(r1cs).compile()
        self.program = CompiledWitnessProgram(cs)

    def compute(self, known: dict[int, int]) -> np.ndarray:
        """known: {input wire index: value} (from circom_interop.
        input_assignments); returns (r1cs.n_wires, 4) u64 standard form."""
        r = self.r1cs
        lo = 1 + r.n_pub_out
        hi = lo + r.n_pub_in + r.n_prv_in
        vals = [known.get(w, 0) for w in range(lo, hi)]
        wires = self.program.compute_witness(**{INPUT_SLOT: vals})
        return wires[: r.n_wires]

    def compute_ints(self, known: dict[int, int]) -> list[int]:
        w = self.compute(known)
        return [
            int(w[i, 0])
            | (int(w[i, 1]) << 64)
            | (int(w[i, 2]) << 128)
            | (int(w[i, 3]) << 192)
            for i in range(len(w))
        ]

    def save(self, path: str) -> None:
        """Persist the compiled bytecode tables (.npz): the compile pass
        (~80 s at 10^6 constraints) is paid once per circuit, like circom's
        own setup-time codegen."""
        self.program.save(path)

    @classmethod
    def load(cls, r1cs: R1CS, path: str) -> "CircomWitnessProgram":
        self = cls.__new__(cls)
        self.r1cs = r1cs
        self.program = CompiledWitnessProgram.load(path)
        return self

    def check(self, wires_u64: np.ndarray) -> int | None:
        """Native R1CS satisfaction check; None if satisfied, else the first
        violated constraint index (defense-in-depth, service debug mode)."""
        full = wires_u64
        if len(full) < self.program.n_wires:
            full = np.zeros((self.program.n_wires, 4), dtype=np.uint64)
            full[: len(wires_u64)] = wires_u64
        return self.program.check_witness(full)


def witness_program_from_files(r1cs_path: str) -> CircomWitnessProgram:
    return CircomWitnessProgram(load_r1cs(r1cs_path))
