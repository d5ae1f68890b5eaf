"""Median `generate_proof` phase (ms) of the window's requests, from the
service's per-request breakdowns (host clock): the wait for the prover's
lock and the proof."""

from zkbench.stats import median


def read(obs):
    xs = [b["phases_ms"]["generate_proof"] for b in obs.breakdowns if "generate_proof" in b.get("phases_ms", {})]
    return median(xs) if xs else None
