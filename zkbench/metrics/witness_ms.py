"""Median `generate_witness` phase (ms) of the window's requests, from
the service's per-request breakdowns (host clock)."""

from zkbench.stats import median


def read(obs):
    xs = [b["phases_ms"]["generate_witness"] for b in obs.breakdowns if "generate_witness" in b.get("phases_ms", {})]
    return median(xs) if xs else None
