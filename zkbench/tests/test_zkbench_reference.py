"""The reference's Poseidon against circomlib's published test vectors
(the vectors the repository's own tests pin its hashes to), so that the
frozen copy that computes every public-inputs hash is held to circomlib,
not only to the program it was copied from."""

import pytest

from zkbench.reference.poseidon import poseidon_hash

CIRCOMLIB = [
    ([1], 18586133768512220936620570745912940619677854269274689475585506675881198879027),
    ([1, 2], 7853200120776062878684798364095072458815029376092732009249414926327459813530),
    ([1, 2, 3, 4], 18821383157269793795438455681495246036402687001665670618754263018637548127333),
    ([1, 2, 3, 4, 5, 6], 20400040500897583745843009878988256314335038853985262692600694741116813247201),
]


@pytest.mark.parametrize("inputs,digest", CIRCOMLIB)
def test_poseidon_gives_circomlibs_vectors(inputs, digest):
    assert poseidon_hash(inputs) == digest
