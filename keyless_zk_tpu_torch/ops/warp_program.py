"""K7's schedule: one group operation as steps of independent Fq operations
that the 32 lanes of a warp run side by side (csrc/msm_reduce.cu
`horner_kernel`).

The doubling and the add are traced through the port's own formulas
(curves/jacobian.py `dbl` and `add_formula`, the same as csrc/ec.cuh
`dbl_core` and `add_core`) with a recording field: every Fq product, add
and sub becomes one operation on a slot of the kernel's shared slot file,
each result a new slot. At G2 the Fq2 product and square lower to the
Karatsuba forms of csrc/field.cuh (three and two Fq products). The
operations are then grouped into steps: a product runs one step after the
latest product it depends on (its "phase"), and the adds and subs between
two product steps run in steps of their own by depth. So a G1 doubling is
3 product steps (3, 3 and 1 products) among 10 add and sub steps, a G1 add
5 among 10, and the G2 ops the same with up to 7 (doubling) and 12 (add)
Fq products in a step. Every result is canonical, so the kernel's
coordinates equal the sequential formulas' bit for bit.

Why a step per add: an Fq add or sub is a chain of some 25 dependent
instructions. Spread over lanes, the adds of a step cost one add's
latency. Trials on the H100 that gave a product's lane its operands' adds
(all of them, as integer combinations of earlier products, or one sum)
ran slower or no faster.

Slots: the first point p at [0, 3E), the second q at [3E, 6E), E Fq
elements per coordinate (1 for G1, 2 for G2: c0 then c1); temporaries
above. The encoded program (`encode`) is a header and the steps, one word
per lane: kind << 30 | dst << 20 | a << 10 | b.
"""

from __future__ import annotations

import functools

import numpy as np

from ..curves.jacobian import JacobianCurve, JacPoint

MUL, ADD, SUB = 1, 2, 3
LANES = 32
SLOTS = 256  # the kernel's slot file (csrc/msm_reduce.cu kSlots)
CODE_MAX = 4096  # words of the kernel's program buffer (kCodeMax)
# header: dbl steps, add steps, dbl outputs (6), add outputs (6), add's h (2), add's rr (2)
H_DBL_STEPS, H_ADD_STEPS, H_DBL_OUT, H_ADD_OUT, H_H, H_RR, HEADER = 0, 1, 2, 8, 14, 16, 18


class _Tape:
    def __init__(self, n_inputs: int):
        self.ops: list[tuple[int, int, int, int]] = []
        self.n = n_inputs

    def op(self, kind: int, a: int, b: int) -> int:
        self.ops.append((kind, self.n, a, b))
        self.n += 1
        return self.n - 1


class _FqTrace:
    """Fq operations that record themselves; an element is a slot."""

    def __init__(self, tape: _Tape):
        self.t = tape

    def add(self, a, b):
        return self.t.op(ADD, a, b)

    def sub(self, a, b):
        return self.t.op(SUB, a, b)

    def mul(self, a, b):
        return self.t.op(MUL, a, b)

    def sqr(self, a):
        return self.t.op(MUL, a, a)


class _Fq2Trace:
    """Fq2 on (c0, c1) slot pairs, the products in csrc/field.cuh's forms."""

    def __init__(self, tape: _Tape):
        self.f = _FqTrace(tape)

    def add(self, a, b):
        return (self.f.add(a[0], b[0]), self.f.add(a[1], b[1]))

    def sub(self, a, b):
        return (self.f.sub(a[0], b[0]), self.f.sub(a[1], b[1]))

    def mul(self, a, b):
        f = self.f
        t0, t1 = f.mul(a[0], b[0]), f.mul(a[1], b[1])
        t2 = f.mul(f.add(a[0], a[1]), f.add(b[0], b[1]))
        return (f.sub(t0, t1), f.sub(f.sub(t2, t0), t1))

    def sqr(self, a):
        f = self.f
        re = f.mul(f.add(a[0], a[1]), f.sub(a[0], a[1]))
        t = f.mul(a[0], a[1])
        return (re, f.add(t, t))


def _flat(e) -> list[int]:
    return list(e) if isinstance(e, tuple) else [e]


def _inputs(E: int, base: int) -> JacPoint:
    coord = (lambda i: base + i) if E == 1 else (lambda i: (base + 2 * i, base + 2 * i + 1))
    return JacPoint(coord(0), coord(1), coord(2))


def schedule(ops, n_inputs: int) -> list[list[tuple[int, int, int, int]]]:
    """Group SSA operations into steps: a product at one more than the
    latest phase of its inputs, an add or sub at its inputs' latest phase
    and one more than the depth of its inputs of that phase; steps in
    (phase, depth) order, products first in a phase (depth 0)."""
    phase = [0] * n_inputs
    depth = [0] * n_inputs
    keyed: dict[tuple[int, int], list] = {}
    for op in ops:
        kind, dst, a, b = op
        assert dst == len(phase), "operations must be in SSA order"
        if kind == MUL:
            ph, dp = max(phase[a], phase[b]) + 1, 0
        else:
            ph = max(phase[a], phase[b])
            dp = 1 + max(depth[x] for x in (a, b) if phase[x] == ph)
        phase.append(ph)
        depth.append(dp)
        keyed.setdefault((ph, dp), []).append(op)
    steps = []
    for key in sorted(keyed):
        group = keyed[key]
        steps.extend(group[i : i + LANES] for i in range(0, len(group), LANES))
    return steps


@functools.lru_cache(maxsize=None)
def programs(tag: str) -> dict:
    """The doubling and add programs of one group ({"dbl", "add"}: steps,
    output slots, slots used, and the add's h and rr slots)."""
    E = 1 if tag == "fq" else 2
    field = _FqTrace if E == 1 else _Fq2Trace
    tape = _Tape(6 * E)
    res = sum((_flat(c) for c in JacobianCurve(field(tape)).dbl(_inputs(E, 0))), [])
    out = {"dbl": {"steps": schedule(tape.ops, 6 * E), "out": res, "slots": tape.n}}
    tape = _Tape(6 * E)
    res, h, rr = JacobianCurve(field(tape)).add_formula(_inputs(E, 0), _inputs(E, 3 * E))
    res, h, rr = sum((_flat(c) for c in res), []), _flat(h), _flat(rr)
    out["add"] = {"steps": schedule(tape.ops, 6 * E), "out": res, "h": h, "rr": rr, "slots": tape.n}
    return out


def _words(steps) -> np.ndarray:
    code = np.zeros((len(steps), LANES), dtype=np.uint32)
    for s, step in enumerate(steps):
        for lane, (kind, dst, a, b) in enumerate(step):
            code[s, lane] = (kind << 30) | (dst << 20) | (a << 10) | b
    return code.reshape(-1)


@functools.lru_cache(maxsize=None)
def encode(tag: str) -> np.ndarray:
    """The kernel's program for one group: the header, then the doubling's
    steps, then the add's, as int32 words."""
    p = programs(tag)
    dbl, add = p["dbl"], p["add"]
    assert max(dbl["slots"], add["slots"]) <= SLOTS, "the programs outgrow the kernel's slot file"
    head = np.zeros(HEADER, dtype=np.uint32)
    head[H_DBL_STEPS], head[H_ADD_STEPS] = len(dbl["steps"]), len(add["steps"])
    for at, vals in ((H_DBL_OUT, dbl["out"]), (H_ADD_OUT, add["out"]), (H_H, add["h"]), (H_RR, add["rr"])):
        head[at : at + len(vals)] = vals
    code = np.concatenate([head, _words(dbl["steps"]), _words(add["steps"])])
    assert code.size <= CODE_MAX, "the programs outgrow the kernel's program buffer"
    return code.view(np.int32)
