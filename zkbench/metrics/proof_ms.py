"""Median over the window's requests of the request's proof with the
prover's lock held (ms): its `prove` spans summed (two where the proof
was retried), from the service's per-request breakdowns (host clock).
With `lock_wait_ms` it makes up `generate_proof_ms`."""

from zkbench.stats import median


def per_request_ms(obs, span: str) -> list[float]:
    """Each request's `span` spans summed (ms), over the window's requests
    that have one."""
    return [sum(t1 - t0 for n, t0, t1, _ in b["spans"] if n == span) * 1e3
            for b in obs.breakdowns if any(s[0] == span for s in b.get("spans", ()))]


def read(obs):
    xs = per_request_ms(obs, "prove")
    return median(xs) if xs else None
