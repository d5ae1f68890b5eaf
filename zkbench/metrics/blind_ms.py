"""Milliseconds per proof of the host's blinding tail: the BatchProver's
`blind` phase (host clock, after the device phases) summed over the
window's batches, divided by their proofs."""


def read(obs):
    done = [b for b in obs.batches if "blind" in b["phase_ms"]]
    proofs = sum(b["size"] for b in done)
    return sum(b["phase_ms"]["blind"] for b in done) / proofs if proofs else None
