"""Open-loop timing from the due time, how late the generator sent, and
the closed loop's batches: against a stand-in HTTP server and a stand-in
prover, on the CPU."""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer, ThreadingHTTPServer

import pytest

from zkbench import signins
from zkbench.drivers import ClosedLoop, OpenLoop


def _server(cls, delay):
    class H(BaseHTTPRequestHandler):
        def do_POST(self):
            self.rfile.read(int(self.headers["Content-Length"]))
            time.sleep(delay)
            data = json.dumps({"ok": True}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):
            pass

    srv = cls(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _run(srv, due):
    loop = OpenLoop(srv.server_address[1], [b"{}"] * len(due), due)
    t0 = time.perf_counter() + 0.05
    loop.start(t0)
    loop.wait(t0 + max(due) + 30)
    loop.close()
    srv.shutdown()
    srv.server_close()
    return loop


def test_open_loop_times_from_due_and_sends_on_time():
    srv = _server(ThreadingHTTPServer, 0.2)
    loop = _run(srv, [0.0, 0.05, 0.1, 0.3])
    lat, late = loop.latencies(), loop.lateness()
    assert all(0.19 < x < 0.6 for x in lat)
    assert len(late) == 4 and max(late) < 0.05
    for r, d in zip(loop.results, [0.0, 0.05, 0.1, 0.3]):
        assert r["due"] == pytest.approx(loop.t0 + d)


def test_open_loop_counts_queueing_behind_a_stall():
    """A server that answers one request at a time: a request due while
    another is served waits, and its latency counts that wait from its
    due time, not from when the server took it."""
    srv = _server(HTTPServer, 0.3)
    loop = _run(srv, [0.0, 0.0, 0.0])
    lat = sorted(loop.latencies())
    assert lat[0] == pytest.approx(0.3, abs=0.1)
    assert lat[2] == pytest.approx(0.9, abs=0.15)
    assert max(loop.lateness()) < 0.05


def test_open_loop_counts_a_refused_connection_as_missing():
    srv = _server(ThreadingHTTPServer, 0.0)
    port = srv.server_address[1]
    srv.shutdown()
    srv.server_close()
    loop = OpenLoop(port, [b"{}"], [0.0])
    loop.start(time.perf_counter())
    loop.wait(time.perf_counter() + 10)
    loop.close()
    assert loop.latencies() == [float("inf")]


def test_arrivals_are_one_set_of_gaps_in_another_order():
    t = {"rate_per_s": 1.0, "shape_seed": 3}
    a, b = signins.arrivals(t, 11, 51), signins.arrivals(t, 12, 51)
    assert len(a) == len(b) == 51 and a[0] == b[0] == 0.0 and max(a) < 51 and max(b) < 51
    gaps = lambda xs: sorted(round(y - x, 9) for x, y in zip(xs, xs[1:]))  # noqa: E731
    assert a != b and len(set(gaps(a)) & set(gaps(b))) >= 45
    assert signins.arrivals(t, 11, 51) == a


@pytest.mark.parametrize("rate,seconds", [(0.64, 51), (1.0, 40), (2.5, 10)])
def test_arrivals_offer_the_rate_over_the_window(rate, seconds):
    """round(rate x seconds) requests, due in order from 0, their gaps
    filling the window: the offered rate is the traffic file's."""
    t = {"rate_per_s": rate, "shape_seed": 3}
    xs = signins.arrivals(t, 2**31 + 5, seconds)
    assert len(xs) == round(rate * seconds) and xs[0] == 0.0
    assert xs == sorted(xs) and xs[-1] < seconds


def test_closed_loop_groups_proofs_into_batches():
    lock = threading.Lock()
    state = {"n": 0, "batch": 0, "info": None}

    def prove(i):
        with lock:  # every 4 calls share one batch's info
            if state["n"] % 4 == 0:
                state["batch"] += 1
                state["info"] = {"batch_size": 4, "phase_ms": {"h_scalars": 1.0}}
            state["n"] += 1
            info = dict(state["info"])
        time.sleep(0.01)
        return ("proof", i), info

    loop = ClosedLoop(prove, list(range(8)), clients=4)
    loop.start()
    time.sleep(0.3)
    assert loop.stop(timeout=10)
    batches = loop.batches()
    assert sum(len(b["records"]) for b in batches) == len(loop.records)
    assert all(b["size"] == 4 for b in batches)
    assert [b["done"] for b in batches] == sorted(b["done"] for b in batches)
    assert {r["answer"][1] for r in loop.records} <= set(range(8))
