"""The R1CS instance that Groth16 setup consumes.

A jax-free copy of the `R1CS` dataclass and `r1cs_from_cs` of
keyless_zk_tpu/circuits/r1cs_file.py. The circom `.r1cs` file reader and
writer are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields import bn254


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
