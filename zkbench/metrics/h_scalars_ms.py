"""Milliseconds per proof of the h scalars: the BatchProver's
`h_scalars` phase (CUDA events) summed over the window's batches,
divided by their proofs."""


def read(obs):
    done = [b for b in obs.batches if "h_scalars" in b["phase_ms"]]
    proofs = sum(b["size"] for b in done)
    return sum(b["phase_ms"]["h_scalars"] for b in done) / proofs if proofs else None
