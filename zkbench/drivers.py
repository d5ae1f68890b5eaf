"""The two loops that offer load.

`OpenLoop` sends each request over HTTP when it is due, whether or not
earlier ones have finished (independent users signing in), and times it
from its due time to its last response byte; `lateness` says how late
the generator sent. `ClosedLoop` keeps `clients` threads each waiting on
its own proof and asking for the next as soon as it has it (callers with
a backlog), and records every completion.
"""

from __future__ import annotations

import concurrent.futures
import http.client
import itertools
import json
import threading
import time


SOCKET_TIMEOUT_S = 300.0
MAX_IN_FLIGHT = 64  # client threads: more than the service's 32 in-flight requests


class OpenLoop:
    def __init__(self, port: int, bodies: list[bytes], due: list[float]):
        if len(bodies) != len(due):
            raise ValueError("one body per due time")
        self.port, self.bodies, self.due = port, bodies, due
        self.results: list[dict | None] = [None] * len(due)
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=MAX_IN_FLIGHT)
        self._futures: list = []
        self._dispatcher: threading.Thread | None = None
        self.t0: float | None = None

    def start(self, t0: float) -> None:
        """Send request i at t0 + due[i] (time.perf_counter's clock)."""
        self.t0 = t0
        self._dispatcher = threading.Thread(target=self._dispatch, daemon=True)
        self._dispatcher.start()

    def _dispatch(self) -> None:
        for i, d in enumerate(self.due):
            wait = self.t0 + d - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            self._futures.append(self._pool.submit(self._send, i))

    def _send(self, i: int) -> None:
        sent = time.perf_counter()
        status, payload = None, None
        try:
            conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=SOCKET_TIMEOUT_S)
            try:
                conn.request("POST", "/v0/prove", body=self.bodies[i], headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = resp.read()
                done = time.perf_counter()
                status = resp.status
            finally:
                conn.close()
            payload = json.loads(data)
        except (OSError, http.client.HTTPException, ValueError) as e:
            done = time.perf_counter()
            payload = {"error": f"{type(e).__name__}: {e}"}
        self.results[i] = {"due": self.t0 + self.due[i], "sent": sent, "done": done,
                           "status": status, "payload": payload}

    def wait(self, deadline: float) -> None:
        """Wait until every request has been sent and answered, or until
        `deadline` (perf_counter); what is still open then never came."""
        self._dispatcher.join(max(0.0, deadline - time.perf_counter()))
        concurrent.futures.wait(list(self._futures), timeout=max(0.0, deadline - time.perf_counter()))

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)

    def latencies(self) -> list[float]:
        """Seconds from due time to the last response byte of every
        request; a request not answered 200 enters as +inf."""
        return [r["done"] - r["due"] if r is not None and r["status"] == 200 else float("inf")
                for r in self.results]

    def lateness(self) -> list[float]:
        """Seconds by which each request was sent after its due time."""
        return [r["sent"] - r["due"] for r in self.results if r is not None]


class ClosedLoop:
    """`clients` threads each calling prove(item) -> (answer, info) on the
    items in turn (cycled), recording (index, done time, answer, info,
    error)."""

    def __init__(self, prove, items: list, clients: int):
        self.prove, self.items, self.clients = prove, items, clients
        self.records: list[dict] = []
        self._counter = itertools.count()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._client, daemon=True) for _ in range(clients)]

    def start(self) -> None:
        for t in self._threads:
            t.start()

    def _client(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                k = next(self._counter)
            answer, info, error = None, None, None
            try:
                answer, info = self.prove(self.items[k % len(self.items)])
            except Exception as e:  # noqa: BLE001 -- a failed proof is counted, not raised
                error = f"{type(e).__name__}: {e}"
            rec = {"k": k, "done": time.perf_counter(), "answer": answer, "info": info, "error": error}
            with self._lock:
                self.records.append(rec)

    def stop(self, timeout: float) -> bool:
        """Ask no more proofs, wait for those in flight; True when every
        client has ended."""
        self._stop.set()
        deadline = time.perf_counter() + timeout
        for t in self._threads:
            t.join(max(0.0, deadline - time.perf_counter()))
        return not any(t.is_alive() for t in self._threads)

    def batches(self) -> list[dict]:
        """The batches completed so far, in order: {done (the first of its
        proofs to return), size, phase_ms, records}. Proofs of one batch
        share their info's phase_ms object."""
        with self._lock:
            recs = list(self.records)
        groups: dict = {}
        for r in recs:
            key = id(r["info"]["phase_ms"]) if r["info"] else ("failed", r["k"])
            groups.setdefault(key, []).append(r)
        out = [{"done": min(r["done"] for r in g), "records": g,
                "size": g[0]["info"]["batch_size"] if g[0]["info"] else 1,
                "phase_ms": g[0]["info"]["phase_ms"] if g[0]["info"] else {}} for g in groups.values()]
        return sorted(out, key=lambda b: b["done"])
