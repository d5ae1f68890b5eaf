"""Batched proving: many proofs per device sweep (PyTorch port of
keyless_zk_tpu/parallel/batch_prover.py).

The reference serializes proving behind a global mutex, one proof at a
time per process (prover-service/src/request_handler/prover_state.rs:21,
prover_handler.rs:266-268). Here requests queue up, and the worker hands
each batch it drains to `Groth16Prover.prove_batch` (groth16/prover.py),
which proves the batch in one sweep of the device: the five MSMs of all B
witnesses as one batched MSM each, the scalar merges as one segment sum
per table, the decode as one batched inversion per group, the h scalars
per element and the blinding tail per proof on the host. This module is
the queue.

Unlike the JAX package, a batch is not padded to `max_batch`: the JAX
package pads so that XLA compiles one shape, PyTorch compiles nothing,
and a pad row would cost a whole proof's device work.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..groth16.prover import Groth16Prover, Proof


@dataclass
class _Pending:
    witness_limbs: np.ndarray
    event: threading.Event
    t_put: float = field(default_factory=time.perf_counter)
    cpu0: float = field(default_factory=time.thread_time)
    result: object = None
    error: Exception | None = None
    info: dict | None = None


class BatchProver:
    """Queue + batch executor around a Groth16Prover.

    prove() blocks the calling thread until its proof is ready; requests
    arriving while a batch is in flight coalesce into the next batch
    (max_batch bounds device memory). `batch_sizes` holds the sizes of the
    batches the worker drained; after a batch, `last_h` its (B, domain, 16)
    h scalars and `phase_ms` its phase times: on a CUDA device the device
    phases (CUDA events), and on any device `blind`, the host's blinding
    tail that follows them (host clock)."""

    def __init__(self, prover: Groth16Prover, max_batch: int = 8):
        if max_batch < 1:
            raise ValueError("max_batch must be at least 1")
        self.prover = prover
        self.max_batch = max_batch
        self.phase_ms: dict[str, float] = {}
        self.batch_sizes: collections.deque = collections.deque(maxlen=1024)
        self._queue: queue.Queue[_Pending | None] = queue.Queue()
        self._stop = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def prove(self, witness_limbs: np.ndarray, timeout: float | None = None, info: dict | None = None) -> Proof:
        """One proof through the queue. `info`, when given, receives the
        size of the batch it rode in, that batch's phase ms (one dict
        shared by the batch's proofs) and this proof's `spans`: one
        [name, t0, t1, cpu_ms], `batch_queue_wait`, from the put to the
        worker draining the item, on time.perf_counter. Its cpu_ms is this
        thread's from the put until it blocks: it sleeps from there until
        after the batch, so that is all it spends over the span."""
        item = _Pending(witness_limbs=witness_limbs, event=threading.Event())
        self._queue.put(item)
        cpu_ms = (time.thread_time() - item.cpu0) * 1e3
        if not item.event.wait(timeout):
            raise TimeoutError("batched prove timed out")
        if info is not None and item.info is not None:
            info.update(batch_size=item.info["batch_size"], phase_ms=item.info["phase_ms"],
                        spans=[["batch_queue_wait", item.t_put, item.info["t_drained"], cpu_ms]])
        if item.error is not None:
            raise item.error
        return item.result

    def shutdown(self) -> None:
        """Stop the worker after the batch in flight."""
        self._stop = True
        self._queue.put(None)  # wake the worker
        self._worker.join()

    # ---- worker ----------------------------------------------------------

    def _drain_batch(self) -> list[_Pending]:
        first = self._queue.get()
        if first is None:
            return []
        batch = [first]
        while len(batch) < self.max_batch:
            try:
                nxt = self._queue.get_nowait()
            except queue.Empty:
                break
            if nxt is None:
                break
            batch.append(nxt)
        return batch

    def _run(self) -> None:
        while not self._stop:
            batch = self._drain_batch()
            if not batch:
                continue
            t_drained = time.perf_counter()
            self.batch_sizes.append(len(batch))
            try:
                proofs = self.prove_batch([b.witness_limbs for b in batch])
                for item, proof in zip(batch, proofs):
                    item.result = proof
            except Exception as e:  # noqa: BLE001 -- propagate to every waiter
                for item in batch:
                    item.error = e
            finally:
                info = {"batch_size": len(batch), "phase_ms": dict(self.phase_ms), "t_drained": t_drained}
                for item in batch:
                    item.info = info
                    item.event.set()

    # ---- the batch ----------------------------------------------------------

    @property
    def last_h(self) -> torch.Tensor | None:
        """The last batch's (B, domain, 16) h scalars, the prover's own (a
        second reference would keep them alive through the next batch)."""
        return self.prover.last_h

    def prove_batch(self, witnesses: list[np.ndarray]) -> list[Proof]:
        """Prove B witnesses in one device sweep (`Groth16Prover.prove_batch`,
        r and s sampled per proof); then `phase_ms` and `last_h` are the
        batch's."""
        proofs = self.prover.prove_batch(witnesses)
        self.phase_ms = self.prover.phase_ms
        return proofs
