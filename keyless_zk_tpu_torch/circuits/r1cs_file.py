"""The R1CS instance that Groth16 setup consumes, and circom's binary
``.r1cs`` container.

Format as produced by `circom --r1cs` (consumed by snarkjs during setup,
reference scripts/python/setups/testing_setup.py:53-69):

  magic "r1cs", u32 version, u32 nSections, sections of (u32 type, u64 len):
    section 1 (header): u32 n8, n8-byte LE prime, u32 nWires, u32 nPubOut,
                        u32 nPubIn, u32 nPrvIn, u64 nLabels, u32 mConstraints
    section 2 (constraints): per constraint, for each of A, B, C:
                        u32 nEntries, then entries { u32 wireId, n8 LE coef }
    section 3 (wire2label): u64 per wire

A jax-free copy of keyless_zk_tpu/circuits/r1cs_file.py. Its writer builds
section 2 as one numpy word array (the bytes the JAX writer makes, without
its loop over terms): the keyless circuit has ~43 million.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from itertools import chain

import numpy as np

from ..fields import bn254
from ..groth16.binfile import BinFile, le_bytes_to_int


@dataclass
class R1CS:
    prime: int
    n_wires: int
    n_pub_out: int
    n_pub_in: int
    n_prv_in: int
    n_constraints: int
    # per-constraint sparse rows {wire: coef}
    A: list[dict]
    B: list[dict]
    C: list[dict]

    @property
    def n_public(self) -> int:
        return self.n_pub_out + self.n_pub_in


def load_r1cs(path: str) -> R1CS:
    bf = BinFile.load(path, "r1cs")
    hdr = bf.section(1)
    (n8,) = struct.unpack_from("<I", hdr, 0)
    prime = le_bytes_to_int(hdr[4 : 4 + n8])
    pos = 4 + n8
    n_wires, n_pub_out, n_pub_in, n_prv_in = struct.unpack_from("<IIII", hdr, pos)
    pos += 16
    (_n_labels,) = struct.unpack_from("<Q", hdr, pos)
    pos += 8
    (m,) = struct.unpack_from("<I", hdr, pos)

    body = bytes(bf.section(2))
    rows: list[list[dict]] = [[], [], []]
    off = 0
    for _ in range(m):
        for side in range(3):
            (n_entries,) = struct.unpack_from("<I", body, off)
            off += 4
            row = {}
            for _ in range(n_entries):
                (wire,) = struct.unpack_from("<I", body, off)
                row[wire] = int.from_bytes(body[off + 4 : off + 4 + n8], "little")
                off += 4 + n8
            rows[side].append(row)

    return R1CS(
        prime=prime,
        n_wires=n_wires,
        n_pub_out=n_pub_out,
        n_pub_in=n_pub_in,
        n_prv_in=n_prv_in,
        n_constraints=m,
        A=rows[0],
        B=rows[1],
        C=rows[2],
    )


def _constraint_words(r: R1CS, n8: int) -> np.ndarray:
    """Section 2 as little-endian uint32 words.

    Blocks run constraint-major, A, B, C within a constraint; block
    b = 3 q + side is its u32 count, then 1 + n8 / 4 words per term sorted
    by wire. The terms are taken out of the dicts by C-level iteration
    (`chain`, `map`, `np.fromiter`), sorted by (block, wire) with one stable
    argsort, and each coefficient's n8 bytes come from a table of the
    distinct coefficients (a handful in a real circuit)."""
    m = r.n_constraints
    sides = (r.A, r.B, r.C)
    lens = np.empty((3, m), dtype=np.int64)
    for s, rows in enumerate(sides):
        lens[s] = np.fromiter(map(len, rows), dtype=np.int64, count=m)
    total = int(lens.sum())
    wires = np.fromiter(chain.from_iterable(chain.from_iterable(map(dict.keys, rows) for rows in sides)),
                        dtype=np.int64, count=total)
    coefs = list(chain.from_iterable(chain.from_iterable(map(dict.values, rows) for rows in sides)))
    distinct = dict.fromkeys(coefs)
    index = {c: i for i, c in enumerate(distinct)}
    coef_idx = np.fromiter(map(index.__getitem__, coefs), dtype=np.int64, count=total)
    del coefs
    table = np.frombuffer(b"".join((c % r.prime).to_bytes(n8, "little") for c in distinct), dtype="<u4")
    table = table.reshape(len(distinct), n8 // 4)

    # terms arrive side-major (all of A, then B, then C): key them by their
    # block in the file and their wire
    block = np.repeat(3 * np.tile(np.arange(m, dtype=np.int64), 3) + np.repeat(np.arange(3), m), lens.reshape(-1))
    order = np.argsort((block << 32) | wires, kind="stable")
    del block
    per = 1 + n8 // 4
    terms = np.empty((total, per), dtype="<u4")
    terms[:, 0] = wires[order]
    np.take(table, coef_idx[order], axis=0, out=terms[:, 1:])
    del order, wires, coef_idx

    counts = lens.T.reshape(-1)  # block order
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    is_count = np.zeros(3 * m + per * total, dtype=bool)
    is_count[np.arange(3 * m) + per * starts] = True
    words = np.empty(is_count.size, dtype="<u4")
    words[is_count] = counts
    words[~is_count] = terms.reshape(-1)
    return words


def save_r1cs(path: str, r: R1CS, n8: int = 32) -> None:
    """Write an R1CS in circom's container format, byte for byte what
    keyless_zk_tpu.circuits.r1cs_file.save_r1cs writes."""
    hdr = struct.pack("<I", n8)
    hdr += r.prime.to_bytes(n8, "little")
    hdr += struct.pack("<IIIIQI", r.n_wires, r.n_pub_out, r.n_pub_in, r.n_prv_in, r.n_wires, r.n_constraints)
    body = _constraint_words(r, n8)
    wire2label = np.arange(r.n_wires, dtype="<u8")

    with open(path, "wb") as f:
        f.write(b"r1cs")
        f.write(struct.pack("<II", 1, 3))
        for s_type, payload in ((1, hdr), (2, body), (3, wire2label)):
            f.write(struct.pack("<IQ", s_type, memoryview(payload).nbytes))
            f.write(payload)


def r1cs_from_cs(cs) -> R1CS:
    """Export a ConstraintSystem as an R1CS (public wires = circom pub-ins)."""
    A, B, C = cs.matrices()
    return R1CS(
        prime=bn254.R_SCALAR,
        n_wires=cs.n_wires,
        n_pub_out=0,
        n_pub_in=cs.n_public,
        n_prv_in=cs.n_wires - cs.n_public - 1,
        n_constraints=len(cs.constraints),
        A=[dict(a) for a in A],
        B=[dict(b) for b in B],
        C=[dict(c) for c in C],
    )


def r1cs_circom_order(cs) -> tuple[R1CS, list[int]]:
    """Re-number a native ConstraintSystem into circom wire conventions.

    circom orders wires [1, outputs, public inputs, private inputs,
    internals] (zkey_utils.hpp:72-74), and a circom-compiled witness
    generator receives ONLY the input signals — every other wire must be
    solved from the constraints. `r1cs_from_cs` declares all wires as
    inputs (the prover doesn't care), so it cannot exercise a foreign
    witness compiler; this export puts exactly the wires covered by the
    builder's input hints in the input range. Public wires that are *not*
    inputs (e.g. the in-circuit-computed public_inputs_hash) become circom
    outputs, which the compiler must solve like any internal wire.

    Returns (r1cs, perm) with perm[old_wire] = new_wire.
    """
    input_wires: list[int] = []
    seen: set[int] = set()
    for opcode, _params, outs, _ in cs.ops:
        if opcode == "input":
            for w in outs:
                if w not in seen:
                    seen.add(w)
                    input_wires.append(w)
    pub = list(range(1, cs.n_public + 1))
    pub_out = [w for w in pub if w not in seen]
    pub_in = [w for w in pub if w in seen]
    prv_in = [w for w in input_wires if w > cs.n_public]
    order = [0] + pub_out + pub_in + prv_in
    placed = set(order)
    order += [w for w in range(cs.n_wires) if w not in placed]
    perm = [0] * cs.n_wires
    for new, old in enumerate(order):
        perm[old] = new

    A, B, C = cs.matrices()

    def remap(row):
        return {perm[w]: c for w, c in dict(row).items()}

    return (
        R1CS(
            prime=bn254.R_SCALAR,
            n_wires=cs.n_wires,
            n_pub_out=len(pub_out),
            n_pub_in=len(pub_in),
            n_prv_in=len(prv_in),
            n_constraints=len(cs.constraints),
            A=[remap(a) for a in A],
            B=[remap(b) for b in B],
            C=[remap(c) for c in C],
        ),
        perm,
    )
