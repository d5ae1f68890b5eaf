"""Interop with circom-built setups: witnesses in circom's wire order.

The reference proves under snarkjs zkeys built from circom output, with the
witness produced by the circom-generated generator in circom's wire order
(prover-service/src/request_handler/prover_handler.rs:541-572; wire layout
per wtns_utils.hpp:11-48: wire 0 = 1, then public outputs, public inputs,
private inputs, then internal wires). Our native circuit defines its own
wire order, so to consume a circom setup we need witnesses in *circom's*
order. This module provides that:

- ``load_sym``: parse the ``circom --sym`` symbol table (``#s,#w,#c,name``
  lines) mapping fully-qualified signal names to witness wire indices.
- ``input_assignments``: map a circom ``input.json`` onto input wires,
  either via a .sym table (by name) or positionally (circom assigns main's
  input signals to wires n_pub_out+1.. in declaration order; JSON object
  order follows the template's declaration in circom's own input_gen
  tooling, circuit/tools/input_gen.py).
- ``solve_witness``: complete a partial assignment to a full witness by
  constraint propagation over the R1CS. Each pass solves any constraint
  A·w * B·w = C·w that is linear in a single unknown wire. This covers
  hint-free circuits (every ``<==`` assignment becomes such a constraint);
  circuits with free hints (``<--`` with quadratic ranges, e.g. the
  keyless FpMul long division) additionally need those wires supplied in
  ``known`` — the native witness engine computes them and maps them in via
  a .sym table.
- ``witness_from_input_json``: the whole route from an .r1cs and an
  input.json, through the compiled witness program (circom_witness.py),
  which is compiled once per .r1cs content and kept on disk.

A jax-free copy of keyless_zk_tpu/circuits/circom_interop.py. The compiled
programs are kept under `build/circom_witness/<digest>.npz` beside the
package (a directory the repository's .gitignore lists), keyed by the
first 16 hex digits of the .r1cs file's sha256.
"""

from __future__ import annotations

import hashlib
import json
import zipfile
from pathlib import Path

import numpy as np

from .circom_witness import CircomWitnessProgram
from .r1cs_file import R1CS, load_r1cs  # noqa: F401  (re-export)

CACHE_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "circom_witness"


def load_sym(path: str) -> dict[str, int]:
    """circom .sym: lines ``#s,#w,#c,name``; returns name -> witness wire.

    Wires reported as -1 (optimized out) are skipped. When several signal
    names share a wire (substitution), every name maps to that wire.
    """
    out: dict[str, int] = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 4:
                continue
            wire = int(parts[1])
            if wire >= 0:
                out[parts[3]] = wire
    return out


def _flatten(v):
    if isinstance(v, (list, tuple)):
        for x in v:
            yield from _flatten(x)
    else:
        yield int(v)


def input_assignments(r1cs: R1CS, inputs: dict, sym: dict[str, int] | None = None,
                      main_prefix: str = "main.") -> dict[int, int]:
    """circom input.json dict -> {wire: value} for main's input signals."""
    known: dict[int, int] = {}
    if sym is not None:
        for name, val in inputs.items():
            vals = list(_flatten(val))
            if len(vals) == 1 and f"{main_prefix}{name}" in sym:
                known[sym[f"{main_prefix}{name}"]] = vals[0] % r1cs.prime
            else:
                for i, v in enumerate(vals):
                    key = f"{main_prefix}{name}[{i}]"
                    if key not in sym:
                        raise KeyError(f"signal {key} not in sym table")
                    known[sym[key]] = v % r1cs.prime
        return known
    # positional: public inputs then private inputs in JSON order
    wire = 1 + r1cs.n_pub_out
    for val in inputs.values():
        for v in _flatten(val):
            known[wire] = v % r1cs.prime
            wire += 1
    return known


def _eval_row(row: dict, w: dict[int, int], prime: int):
    """(value, unknown_wire, unknown_coef): value of the known part; at most
    one unknown allowed (None wire if fully known, None if more than one)."""
    acc = 0
    unk_wire = unk_coef = None
    for wire, coef in row.items():
        if wire in w:
            acc = (acc + coef * w[wire]) % prime
        elif unk_wire is None:
            unk_wire, unk_coef = wire, coef
        else:
            return None  # >1 unknown: cannot use this row yet
    return acc, unk_wire, unk_coef


def solve_witness(r1cs: R1CS, known: dict[int, int], max_passes: int = 64) -> np.ndarray:
    """Complete a witness by propagation; returns object-dtype array of ints.

    Raises ValueError if constraints cannot determine every wire (circuit
    needs hint values in `known`) or if a fully-determined constraint is
    violated by the assignment.
    """
    p = r1cs.prime
    w: dict[int, int] = {0: 1}
    w.update({k: v % p for k, v in known.items()})
    pending = list(range(r1cs.n_constraints))
    for _ in range(max_passes):
        if not pending:
            break
        still = []
        progress = False
        for ci in pending:
            ea = _eval_row(r1cs.A[ci], w, p)
            eb = _eval_row(r1cs.B[ci], w, p)
            ec = _eval_row(r1cs.C[ci], w, p)
            if None in (ea, eb, ec):
                still.append(ci)
                continue
            (av, aw, ac), (bv, bw, bc), (cv, cw, cc) = ea, eb, ec
            unknowns = [(s, wr, co) for s, (wr, co) in zip("abc", [(aw, ac), (bw, bc), (cw, cc)]) if wr is not None]
            if not unknowns:
                if (av * bv - cv) % p != 0:
                    raise ValueError(f"constraint {ci} violated")
                progress = True
                continue
            if len(unknowns) > 1:
                still.append(ci)
                continue
            side, wr, co = unknowns[0]
            if side == "c":
                # A·w * B·w = cv + cc*x  ->  x = (A·B - cv) / cc
                w[wr] = (av * bv - cv) * pow(co, -1, p) % p
            elif side == "a":
                if bv % p == 0:
                    still.append(ci)
                    continue
                # (av + ac x) * bv = cv
                w[wr] = (cv * pow(bv, -1, p) - av) * pow(co, -1, p) % p
            else:
                if av % p == 0:
                    still.append(ci)
                    continue
                w[wr] = (cv * pow(av, -1, p) - bv) * pow(co, -1, p) % p
            progress = True
        pending = still
        if not progress:
            break
    missing = [i for i in range(r1cs.n_wires) if i not in w]
    if missing:
        raise ValueError(
            f"witness underdetermined: {len(missing)} wires unsolved "
            f"(first: {missing[:5]}); supply hint values via `known`"
        )
    # all wires known: every remaining constraint is now checkable
    for ci in pending:
        av = sum(c * w[x] for x, c in r1cs.A[ci].items()) % p
        bv = sum(c * w[x] for x, c in r1cs.B[ci].items()) % p
        cv = sum(c * w[x] for x, c in r1cs.C[ci].items()) % p
        if (av * bv - cv) % p != 0:
            raise ValueError(f"constraint {ci} violated")
    return np.array([w[i] for i in range(r1cs.n_wires)], dtype=object)


def witness_from_input_json(r1cs_path: str, input_json_path: str, sym_path: str | None = None) -> np.ndarray:
    """Witness in circom wire order from an .r1cs + input.json.

    Fast path: compile the R1CS to a native witness program (circom_witness
    .py — cached on disk per r1cs content) and execute in C. Falls back to
    the Python propagation solver only when the compiler hits a hint
    pattern it doesn't recognize."""
    r1cs = load_r1cs(r1cs_path)
    with open(input_json_path) as f:
        inputs = json.load(f)
    sym = load_sym(sym_path) if sym_path else None
    known = input_assignments(r1cs, inputs, sym)
    try:
        prog = _cached_program(r1cs, r1cs_path)
        return np.array(prog.compute_ints(known), dtype=object)
    except (ValueError, RuntimeError):
        # ValueError: the compiler hit an unknown hint pattern.
        # RuntimeError: the *compiled program* failed at runtime (e.g. an
        # OP_DIVSUB zero divisor, witness_engine.py) — the Python solver
        # handles these inputs, so fall back rather than crash the request.
        return solve_witness(r1cs, known)


def r1cs_digest(r1cs_path: str) -> str:
    """The cache key of an .r1cs file: its sha256, 16 hex digits."""
    h = hashlib.sha256()
    with open(r1cs_path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            h.update(chunk)
    return h.hexdigest()[:16]


_FAILED_COMPILES: set[str] = set()


def _cached_program(r1cs: R1CS, r1cs_path: str) -> CircomWitnessProgram:
    """Compile-once cache keyed by the r1cs file's content hash.

    Compile *failures* are negative-cached per digest for the process
    lifetime: without this, a circuit whose compile raises pays the full
    compile cost (~80 s at 1M constraints) on every request before falling
    back to the Python solver."""
    digest = r1cs_digest(r1cs_path)
    if digest in _FAILED_COMPILES:
        raise ValueError(f"witness compile previously failed for {digest}")
    path = CACHE_ROOT / f"{digest}.npz"
    if path.exists():
        try:
            return CircomWitnessProgram.load(r1cs, str(path))
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            pass  # stale/corrupt: recompile
    try:
        prog = CircomWitnessProgram(r1cs)
    except ValueError:
        _FAILED_COMPILES.add(digest)
        raise
    try:
        CACHE_ROOT.mkdir(parents=True, exist_ok=True)
        prog.save(str(path))
    except OSError:
        pass  # caching is best-effort
    return prog
