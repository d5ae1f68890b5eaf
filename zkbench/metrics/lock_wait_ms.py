"""Mean over the window's requests of the request's wait for the prover's
lock (ms): its `prove_lock_wait` spans summed (two where the proof was
retried), from the service's per-request breakdowns (host clock). A mean,
not a median: below the knee most requests find the lock free, and the
queue shows only in the others' waits."""

import statistics

from zkbench.metrics.proof_ms import per_request_ms


def read(obs):
    xs = per_request_ms(obs, "prove_lock_wait")
    return statistics.fmean(xs) if xs else None
