"""Proofs per second through the BatchProver at a keyless configuration.

The port's counterpart of scripts/bench_batch_tpu.py (the batched
prover-service load, proofs/sec on one card): the setup store and the
started service state of tools/full_prove.py, the witness of a seeded test
JWT from the state's compiled witness program, and `prove_batch` at each
batch size B; the first proof of every batch must verify under the
setup's vk. The batches run on the service's own prover (the JAX script
builds a second prover over the same key: another ~33 s of construction
and a second copy of the tables on the card).

    python -m keyless_zk_tpu_torch.tools.bench_batch [--iters 32] [--config small|full]

The reference's toy circuit (the JAX script's default) is not in this
repository, so only `small` and `full` run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from ..bench import SETUP_ROOT, check_proof
from .full_prove import CONFIGS, started_state


def run_batch_bench(config: str = "small", iters: int = 32, batches=(1, 4, 8), root=SETUP_ROOT) -> dict:
    """Proofs/sec through the BatchProver; returns the best batch point:
    {"proofs_per_sec", "batch", "results" [per-batch dicts with every
    prove_batch call's ms], "setup_ms", "startup_s"}. The reference
    cannot batch (its FullProver sits behind a global mutex,
    prover_state.rs:21)."""
    from ..circuits.keyless_circuit import witness_kwargs
    from ..input_processing.input_signals import derive_circuit_input_signals
    from ..input_processing.testjwt import make_test_jwt
    from ..parallel.batch_prover import BatchProver

    t0 = time.monotonic()
    state = started_state(config, root)
    setup_ms = (time.monotonic() - t0) * 1e3
    tj = make_test_jwt()
    signals, pih = derive_circuit_input_signals(state.circuit_config, tj.vi, state.config.max_committed_epk_bytes)
    prog = state.witness_prog
    w_np = prog.witness_limbs(prog.compute_witness(**witness_kwargs(signals)))

    results = []
    for bsz in batches:
        batch = BatchProver(state.prover, max_batch=bsz)
        try:
            firsts = [batch.prove_batch([w_np] * bsz)[0]]  # warm-up
            samples = []
            t1 = time.perf_counter()
            done = 0
            while done < iters:
                take = min(bsz, iters - done)
                t = time.perf_counter()
                firsts.append(batch.prove_batch([w_np] * take)[0])
                samples.append(time.perf_counter() - t)
                done += take
            dt = time.perf_counter() - t1
        finally:
            batch.shutdown()
        for i, proof in enumerate(firsts):
            check_proof(state.vk, [pih], proof.to_json_dict(), f"B={bsz} batch {i}")
        results.append({
            "batch": bsz,
            "proofs_per_sec": round(iters / dt, 3),
            "ms_per_proof": round(dt / iters * 1e3, 1),
            "samples_ms": [round(s * 1e3, 1) for s in samples],
        })
        print(json.dumps(results[-1]), flush=True)
    best = max(results, key=lambda r: r["proofs_per_sec"])
    return {
        "proofs_per_sec": best["proofs_per_sec"],
        "batch": best["batch"],
        "results": results,
        "setup_ms": round(setup_ms, 1),
        "startup_s": {k: (round(v, 2) if isinstance(v, float) else v) for k, v in state.startup_s.items()},
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--config", default="small", choices=sorted(CONFIGS))
    args = ap.parse_args()
    res = run_batch_bench(config=args.config, iters=args.iters)
    print(json.dumps({"metric": f"batch_throughput_{args.config}", **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
