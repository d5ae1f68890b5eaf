"""Core constraint gadgets (the circom-template equivalents).

Native counterparts of the reference's template tree
(circuit/templates/stdlib/*.circom, helpers/arrays/*.circom,
circomlib comparators/bitify): each function adds constraints + witness
hints to a ConstraintSystem and returns output wires / linear combinations.

Linear operations (sums, constants, MDS layers, bit packing) stay inside
LinComb objects and cost zero constraints; only genuine products and bit
decompositions allocate wires — same cost model circom's optimizer targets.

A jax-free copy of keyless_zk_tpu/circuits/gadgets.py: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

from .r1cs import ConstraintSystem, LinComb, P


def as_lc(cs: ConstraintSystem, x) -> LinComb:
    """Coerce a wire index / int constant / LinComb to a LinComb."""
    if isinstance(x, LinComb):
        return x
    if isinstance(x, int):
        return cs.lc((x, 1))
    raise TypeError(type(x))


# ---- comparators (circomlib comparators.circom) ----------------------------


def is_zero(cs: ConstraintSystem, x: LinComb) -> int:
    """out = (x == 0) as a 0/1 wire.  IsZero: x*inv = 1 - out, x*out = 0."""
    inv = cs.new_wire()
    out = cs.new_wire()
    cs.op("iszero", (), [inv, out], [x])
    cs.constrain(x, cs.lc(inv), cs.const(1) - cs.lc(out))
    cs.constrain(x, cs.lc(out), LinComb())
    return out


def is_equal(cs: ConstraintSystem, a: LinComb, b: LinComb) -> int:
    return is_zero(cs, a - b)


def less_than(cs: ConstraintSystem, a: LinComb, b: LinComb, n_bits: int) -> int:
    """out = (a < b) for values known to fit n_bits (circomlib LessThan)."""
    assert n_bits <= 252
    shifted = a + cs.const(1 << n_bits) - b
    bits = cs.to_bits(shifted, n_bits + 1)
    # a < b  <=>  top bit of a + 2^n - b is 0
    out = cs.new_wire()
    cs.op("lc", (), [out], [cs.const(1) - cs.lc(bits[n_bits])])
    cs.constrain_eq(cs.lc(out), cs.const(1) - cs.lc(bits[n_bits]))
    return out


def assert_less_than(cs: ConstraintSystem, a: LinComb, b: LinComb, n_bits: int) -> None:
    out = less_than(cs, a, b, n_bits)
    cs.constrain_eq(cs.lc(out), cs.const(1))


# ---- selection --------------------------------------------------------------


def select(cs: ConstraintSystem, cond: LinComb, a: LinComb, b: LinComb) -> LinComb:
    """cond ? a : b  (cond boolean).  One product: b + cond*(a-b)."""
    d = cs.mul(cond, a - b)
    return b + cs.lc(d)


def dot(cs: ConstraintSystem, xs: list[LinComb], ys: list[LinComb]) -> LinComb:
    """sum_i xs[i]*ys[i] — one product wire per term."""
    acc = LinComb()
    for x, y in zip(xs, ys):
        acc = acc + cs.lc(cs.mul(x, y))
    return acc


# ---- array gadgets (templates/helpers/arrays/*.circom) ----------------------


def single_one_array(cs: ConstraintSystem, index: LinComb, length: int) -> list[int]:
    """Bit wires out[i] = (i == index); requires 0 <= index < length.

    Reference: SingleOneArray (helpers/arrays) — bits, sum == 1,
    sum(i*out[i]) == index.
    """
    outs = cs.new_wires(length)
    cs.op("onehot", (0,), outs, [index])
    total = LinComb()
    weighted = LinComb()
    for i, o in enumerate(outs):
        cs.assert_bit(o)
        total = total + cs.lc(o)
        weighted = weighted + cs.lc((o, i))
    cs.constrain_eq(total, cs.const(1))
    cs.constrain_eq(weighted, index)
    return outs


def left_array_selector(cs: ConstraintSystem, index: LinComb, length: int) -> list[int]:
    """out[i] = (i < index); index in [0, length].  Prefix mask.

    Built as the complement of the suffix of a SingleOneArray over
    length+1 slots (reference LeftArraySelector semantics).
    """
    one_hot = single_one_array(cs, index, length + 1)
    # out[i] = 1 - sum_{j <= i} one_hot[j]
    outs = []
    run = LinComb()
    for i in range(length):
        run = run + cs.lc(one_hot[i])
        w = cs.new_wire()
        cs.op("lc", (), [w], [cs.const(1) - run])
        cs.constrain_eq(cs.lc(w), cs.const(1) - run)
        outs.append(w)
    return outs


def right_array_selector(cs: ConstraintSystem, index: LinComb, length: int) -> list[int]:
    """out[i] = (i > index); index in [0, length-1]."""
    one_hot = single_one_array(cs, index, length)
    outs = []
    run = LinComb()
    for i in range(length):
        w = cs.new_wire()
        cs.op("lc", (), [w], [run])
        cs.constrain_eq(cs.lc(w), run)
        outs.append(w)
        run = run + cs.lc(one_hot[i])
    return outs


def array_selector(cs: ConstraintSystem, start: LinComb, end: LinComb, length: int) -> list[int]:
    """out[i] = (start <= i < end) — reference ArraySelector: cumulative
    difference of two one-hots."""
    s_hot = single_one_array(cs, start, length)
    e_hot = single_one_array(cs, end, length + 1)
    outs = []
    run = LinComb()
    for i in range(length):
        run = run + cs.lc(s_hot[i]) - cs.lc(e_hot[i])
        w = cs.new_wire()
        cs.op("lc", (), [w], [run])
        cs.constrain_eq(cs.lc(w), run)
        outs.append(w)
    return outs


def select_array_value(cs: ConstraintSystem, arr: list[LinComb], index: LinComb) -> LinComb:
    """arr[index] via a one-hot dot product (reference SelectArrayValue)."""
    hot = single_one_array(cs, index, len(arr))
    return dot(cs, [cs.lc(h) for h in hot], arr)


# ---- packing (templates/helpers/packing) ------------------------------------


def bits_to_num(cs: ConstraintSystem, bits: list[int], msb_first: bool = False) -> LinComb:
    """Linear pack; no constraints (packing is free in R1CS)."""
    seq = list(reversed(bits)) if msb_first else bits
    acc = LinComb()
    for i, b in enumerate(seq):
        acc = acc + cs.lc((b, 1 << i))
    return acc


def assert_bytes(cs: ConstraintSystem, wires: list[int]) -> list[list[int]]:
    """Range-check wires to [0,256); returns each byte's bits (LSB first)."""
    return [cs.to_bits(cs.lc(w), 8) for w in wires]


# ---- Poseidon (circomlib poseidon.circom; used for all commitments) ---------


def poseidon_gadget(cs: ConstraintSystem, inputs: list[LinComb]) -> LinComb:
    """Poseidon hash of 1..16 field inputs, matching hashes/poseidon.py.

    Linear layers (round constants, MDS) fold into LinCombs for free; each
    s-box costs 3 constraints (x2, x4, x5).
    """
    from ..hashes.poseidon_params import R_F, n_rounds_partial, poseidon_params

    t = len(inputs) + 1
    constants, mds = poseidon_params(t)
    r_p = n_rounds_partial(t)

    state: list[LinComb] = [LinComb()] + list(inputs)

    def sbox(x: LinComb) -> LinComb:
        x2 = cs.lc(cs.mul(x, x))
        x4 = cs.lc(cs.mul(x2, x2))
        return cs.lc(cs.mul(x4, x))

    for r in range(R_F + r_p):
        state = [x + cs.const(constants[r * t + i]) for i, x in enumerate(state)]
        if r < R_F // 2 or r >= R_F // 2 + r_p:
            state = [sbox(x) for x in state]
        else:
            state[0] = sbox(state[0])
        state = [
            sum((state[j].scale(mds[i][j]) for j in range(t)), LinComb())
            for i in range(t)
        ]
    return state[0]
