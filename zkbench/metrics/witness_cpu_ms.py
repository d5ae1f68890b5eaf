"""Median over the window's requests of the CPU time (ms) that the
request's thread spent in its `generate_witness` span (the thread's
clock, time.thread_time): `witness_ms` less this is what the witness
waited, for the interpreter lock or for a core."""

from zkbench.stats import median


def read(obs):
    xs = [cpu_ms for b in obs.breakdowns for n, _, _, cpu_ms in b.get("spans", ()) if n == "generate_witness"]
    return median(xs) if xs else None
