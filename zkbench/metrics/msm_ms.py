"""Milliseconds per proof of the five MSMs: the BatchProver's `msm_*`
phases (CUDA events) summed over the window's batches, divided by their
proofs."""

from zkbench.readings import MSM_PHASES


def read(obs):
    done = [b for b in obs.batches if all(p in b["phase_ms"] for p in MSM_PHASES)]
    proofs = sum(b["size"] for b in done)
    return sum(b["phase_ms"][p] for b in done for p in MSM_PHASES) / proofs if proofs else None
