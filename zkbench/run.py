"""Run one cell of the benchmark once.

    python -m zkbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic
mix and its metrics are found by name (spec.py); the program is
keyless_zk_tpu_torch, started by system.py. Set-up (the service's start
from its setup store, the traffic, the warm-up) is timed from the
process's start to the window's; the window offers the cell's load for
`seconds`; then the run waits for every answer due, reads the device's
memory peak, frees the program, and judges the answers with the plain
reference (reference/judge.py). With `--trace 1` the window is traced and
the cell's per-layer metrics are reported instead of its end-to-end
ones. The last line of standard output is the result; the numbers
compared, each beside its limit, are the last lines of standard error
and the result's last key.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import gc
import hashlib
import json
import math
import multiprocessing
import os
import subprocess
import sys
import time
from pathlib import Path

from . import signins, stats
from .readings import Observations
from .reference import ed25519, judge
from .spec import Spec, reader

FORBIDDEN = ("jax", "jaxlib", "flax", "keyless_zk_tpu")
ANSWER_GRACE_S = 60.0  # how long past the window's close an answer may come
TW_SECRET = hashlib.sha256(b"zkbench training-wheels key").digest()


def _boot_now() -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def process_start() -> float:
    """The process's start on CLOCK_BOOTTIME (from /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        return int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return _boot_now()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's, compared whole (the program's name begins with the JAX
    package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cache_env(root: Path) -> dict:
    """Fixed directories inside the checkout for every build and kernel
    cache a library may keep."""
    base = root / "zkbench" / "cache"
    return {
        "TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
        "TRITON_CACHE_DIR": str(base / "triton"),
        "CUDA_CACHE_PATH": str(base / "nv_compute"),
        "USE_FLAX": "0",
    }


def card_info() -> dict:
    import torch

    info = {"kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        info["nvidia_smi"] = out.stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        info["nvidia_smi"] = [f"unavailable: {e}"]
    return info


def host_sample() -> dict:
    """The host's CPU counters now (/proc/stat's first line, in ticks),
    this process's CPU seconds, the load average and the cores' mean
    clock; whatever the host does not offer is left out."""
    out = {"t": time.perf_counter(), "own_cpu_s": sum(os.times()[:2])}
    try:
        with open("/proc/stat") as f:
            out["ticks"] = [int(x) for x in f.readline().split()[1:9]]
        out["loadavg"] = [float(x) for x in Path("/proc/loadavg").read_text().split()[:3]]
        mhz = [float(line.split(":")[1]) for line in Path("/proc/cpuinfo").read_text().splitlines()
               if line.startswith("cpu MHz")]
        out["mhz_mean"] = sum(mhz) / len(mhz) if mhz else None
    except (OSError, ValueError, IndexError):
        pass
    return out


def host_between(a: dict, b: dict) -> dict:
    """How the host's cores were used between two samples: the cores this
    process kept busy on average, and, where the host's counters move (a
    sandboxed kernel may keep them still), the shares of all cores' time
    that were busy, waiting on I/O and stolen by the hypervisor, and this
    process's share, so that busy less own is what other processes took."""
    seconds = b["t"] - a["t"]
    own_s = b["own_cpu_s"] - a["own_cpu_s"]
    out = {"seconds": seconds, "own_cores": own_s / seconds if seconds > 0 else None,
           "loadavg": b.get("loadavg"), "mhz_mean": b.get("mhz_mean")}
    d = [y - x for x, y in zip(a.get("ticks", []), b.get("ticks", []))]
    if sum(d) > 0:
        user, nice, system, idle, iowait, irq, softirq, steal = d
        total = sum(d)
        out.update(busy=(user + nice + system + irq + softirq) / total, iowait=iowait / total, steal=steal / total,
                   own=own_s * os.sysconf("SC_CLK_TCK") / total)
    return out


def say(**kv) -> None:
    """An earlier line of the run's output."""
    print(json.dumps({"info": kv}, default=str), flush=True)


class Session:
    """A cell's program, started once; `measure` runs one window on it."""

    def __init__(self, root: Path, spec: Spec, cell: dict, device: str = "cuda", trace: bool = False):
        from .system import System

        self.root, self.spec, self.cell, self.device = Path(root), spec, cell, device
        self.config, self.traffic = spec.config(cell), spec.traffic(cell)
        self.cache = self.root / "zkbench" / "cache"
        self.tracer = None
        if trace:
            from .trace import Tracer

            self.tracer = Tracer(self.cache / "trace" / "window.json")
        self.system = System(self.config, self.cache, TW_SECRET, device=device)
        self.system.start()
        if self.tracer is not None:
            self.system.instrument(self.tracer.record)
        self.gen = signins.SignIns(self.traffic)
        self.system.add_jwk(self.gen.jwk)
        self.vk = self.system.verification_key()
        self.zkey = self.system.zkey_path()
        self.port = self.system.serve() if self.traffic["entry"] == "http" else None

    def measure(self, seed: int, seconds: float) -> dict:
        loop = self.traffic["loop"]
        if loop == "open":
            return self._open(seed, seconds)
        if loop == "closed":
            return self._closed(seed, seconds)
        raise ValueError(f"unknown loop {loop!r}")

    # ---- open loop over HTTP -----------------------------------------------------

    def _post_all(self, requests: list[dict]) -> list[int | None]:
        from .drivers import OpenLoop

        warm = OpenLoop(self.port, [json.dumps(r).encode() for r in requests], [0.0] * len(requests))
        warm.start(time.perf_counter())
        warm.wait(time.perf_counter() + 600)
        warm.close()
        return [r["status"] if r else None for r in warm.results]

    def _open(self, seed: int, seconds: float) -> dict:
        from .drivers import OpenLoop

        t = self.traffic
        due = signins.arrivals(t, seed, seconds)
        requests = self.gen.batch(seed, len(due), t["shape_seed"], "window")
        warm = self.gen.batch(seed, sum(t["warmup"]), t["shape_seed"] + 1, "warmup")
        # warm-up: requests alone, then requests at once
        statuses = self._post_all(warm[:t["warmup"][0]]) if t["warmup"][0] else []
        if self.tracer is not None:
            self.tracer.start()
        statuses += self._post_all(warm[t["warmup"][0]:])
        if any(s != 200 for s in statuses):
            raise RuntimeError(f"a warm-up request was not answered 200: {statuses}")
        self.system.clear_breakdowns()
        driver = OpenLoop(self.port, [json.dumps(r).encode() for r in requests], due)
        t0 = time.perf_counter() + 0.05
        boot_t0 = _boot_now() + (t0 - time.perf_counter())
        driver.start(t0)
        self._window_marks(t0, t0 + seconds)
        driver.wait(t0 + seconds + ANSWER_GRACE_S)
        driver.close()
        breakdowns = self.system.breakdowns()
        tampered = self._post_all([signins.tampered(requests[0])])[0]
        lat = driver.latencies()
        late = driver.lateness()
        return {
            "boot_t0": boot_t0, "window_s": seconds, "kind": "served",
            "requests": requests, "answers": driver.results, "attempted": len(requests),
            "failed": sum(1 for x in lat if math.isinf(x)),
            "end_to_end": {"request_p90_ms": stats.percentile(lat, 90) * 1e3},
            "breakdowns": breakdowns, "batches": [], "tamper_accepted": int(tampered == 200),
            "info": {"offered_rate_per_s": len(due) / seconds, "requests": len(due),
                     "request_p50_ms": stats.percentile(lat, 50) * 1e3,
                     "answered_200": sum(1 for x in lat if not math.isinf(x)),
                     "lateness_ms": {"median": stats.median(late) * 1e3 if late else None,
                                     "max": max(late) * 1e3 if late else None},
                     "batch_sizes": sorted({b.get("batch_size") for b in breakdowns}),
                     "failures": [{"request": i, "status": a["status"] if a else None,
                                   "error": str((a or {}).get("payload", {}).get("error"))[:300]}
                                  for i, a in enumerate(driver.results) if not a or a["status"] != 200][:5],
                     "phase_median_ms": {k: stats.median([b["phases_ms"][k] for b in breakdowns])
                                         for k in (breakdowns[0]["phases_ms"] if breakdowns else {})}},
        }

    # ---- closed loop on the BatchProver ------------------------------------------

    def _closed(self, seed: int, seconds: float) -> dict:
        from .drivers import ClosedLoop

        t = self.traffic
        requests = self.gen.batch(seed, t["witnesses"], t["shape_seed"], "window")
        with concurrent.futures.ThreadPoolExecutor(max_workers=t["witness_threads"]) as pool:
            witnesses = list(pool.map(self.system.witness, requests))
        driver = ClosedLoop(lambda i: self.system.prove_batched(witnesses[i], timeout=600),
                            list(range(len(witnesses))), t["clients"])
        if self.tracer is not None:
            self.tracer.start()
        driver.start()
        warm = t["warmup_batches"]
        batches = self._wait_batches(driver, lambda bs: len(bs) >= warm, 900)
        t_start = batches[warm - 1]["done"]
        boot_t0 = _boot_now() - (time.perf_counter() - t_start)
        if self.tracer is not None:
            self.tracer.mark("zkbench.window_start")
        batches = self._wait_batches(driver, lambda bs: bs[-1]["done"] >= t_start + seconds, seconds + 900)
        t_end = next(b["done"] for b in batches if b["done"] >= t_start + seconds)
        if self.tracer is not None:
            self.tracer.mark("zkbench.window_end")
            self.tracer.stop()
        if not driver.stop(timeout=600):
            raise RuntimeError("a client of the closed loop did not end")
        batches = driver.batches()
        window = [b for b in batches if t_start < b["done"] <= t_end]
        done = [r for b in window for r in b["records"] if r["error"] is None]
        after = [r for b in batches if b["done"] > t_start for r in b["records"]]
        return {
            "boot_t0": boot_t0, "window_s": t_end - t_start, "kind": "proof",
            "requests": [requests[r["k"] % len(requests)] for r in after],
            "answers": [r["answer"] for r in after], "attempted": len(after),
            "failed": sum(1 for r in after if r["error"] is not None),
            "end_to_end": {"proofs_per_s": stats.rate(len(done), t_end - t_start)},
            "breakdowns": [], "batches": [{"size": b["size"], "phase_ms": b["phase_ms"]} for b in window],
            "tamper_accepted": None,
            "info": {"window_s": t_end - t_start, "proofs_in_window": len(done),
                     "batch_sizes": [b["size"] for b in window], "proofs_judged": len(after),
                     "errors": sorted({r["error"] for r in after if r["error"]})[:3]},
        }

    @staticmethod
    def _wait_batches(driver, ready, timeout: float) -> list[dict]:
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            bs = driver.batches()
            if bs and ready(bs):
                return bs
            time.sleep(0.01)
        raise RuntimeError("the closed loop stopped completing batches")

    def _window_marks(self, t0: float, t1: float) -> None:
        if self.tracer is None:
            return
        time.sleep(max(0.0, t0 - time.perf_counter()))
        self.tracer.mark("zkbench.window_start")
        time.sleep(max(0.0, t1 - time.perf_counter()))
        self.tracer.mark("zkbench.window_end")
        self.tracer.stop()

    # ---- after the window ----------------------------------------------------

    def observations(self, m: dict, kind: str) -> Observations:
        from .yardstick import key_counts

        obs = Observations(device_kind=kind, startup_s=self.system.startup_s,
                           breakdowns=m["breakdowns"], batches=m["batches"])
        if self.tracer is not None:
            obs.trace = self.tracer.summary()
            obs.key_counts = key_counts(self.zkey, self.cache)
        return obs

    def close(self) -> None:
        self.system.close()
        self.system = None
        gc.collect()


def judge_tasks(m: dict, vk: dict, jwk_n: int, circuit: dict, shift: int = 0) -> tuple:
    """(function, tasks) that judge a window's answers. `shift` > 0 hands
    request i the answer of request i + shift: the control, a valid answer
    of another statement."""
    answers = m["answers"]
    if shift:
        answers = answers[shift:] + answers[:shift]
    common = {"modulus": jwk_n, "circuit": circuit, "vk": vk}
    if m["kind"] == "served":
        tw_pk = ed25519.public_key(TW_SECRET)
        return judge.judge_served, [
            {**common, "request": r, "tw_pk": tw_pk, "status": a["status"] if a else None,
             "payload": a["payload"] if a else None} for r, a in zip(m["requests"], answers)]
    return judge.judge_proof, [{**common, "request": r, "proof": a} for r, a in zip(m["requests"], answers)]


def judge_all(fn, tasks: list[dict], workers: int) -> list[dict]:
    """Run the reference over every task in a pool of fresh processes
    (spawned: they import the reference alone)."""
    if not tasks:
        return []
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(max_workers=min(workers, len(tasks)), mp_context=ctx) as pool:
        return list(pool.map(fn, tasks, chunksize=1))


def counted(m: dict, results: list[dict], vk_bad: int | None = None) -> dict:
    return judge.tally(results, m["tamper_accepted"], vk_bad)


def vk_check(vk: dict, zkey: Path) -> int:
    """1 where the verification key that judges the answers is not the one
    that the proving key the service loaded carries, read from the key
    file by the benchmark's own parser."""
    from .reference.bn254 import Q
    from .yardstick import zkey_vk

    return judge.vk_mismatch(vk, zkey_vk(zkey, Q))


def circuit_facts(config: dict) -> dict:
    return {"max_lengths": config["circuit"]["max_lengths"],
            "max_committed_epk_bytes": config["service"].get("max_committed_epk_bytes", 93)}


def result_line(spec: Spec, cell: dict, m: dict, obs: Observations | None, trace: bool, setup_s: float,
                device: dict, counts: dict) -> dict:
    metrics = {}
    for met in spec.metrics(cell, trace):
        name = met["name"]
        if trace:
            value = reader(name)(obs)
        elif name == "setup_s":
            value = setup_s
        else:
            value = m["end_to_end"].get(name)
        if value is None:
            continue
        metrics[name] = {"value": value if math.isfinite(value) else None, "unit": met["unit"]}
    line = {"correct": judge.verdict(counts), "attempted": m["attempted"], "failed": m["failed"],
            "metrics": metrics, "device": device}
    if trace and obs is not None and obs.trace is not None:
        line["breakdown"] = {"device_ops": obs.trace["device_ops"], "idle_gaps": obs.trace["idle_gaps"]}
    line["checks"] = {name: {"value": v, "limit": judge.LIMITS[name]} for name, v in counts.items()}
    return line


def main(argv=None) -> int:
    t_proc = process_start()
    ap = argparse.ArgumentParser(prog="python -m zkbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    spec = Spec(root)
    cell = spec.cell(args.workload)
    os.environ.update(cache_env(root))

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"zkbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    from .system import import_program

    import_program(root)
    card = card_info()
    say(card=card)
    h0 = host_sample()
    session = Session(root, spec, cell, trace=bool(args.trace))
    h1 = host_sample()
    say(startup_s=session.system.startup_s)
    m = session.measure(args.seed, args.seconds)
    h2 = host_sample()
    setup_s = m["boot_t0"] - t_proc
    say(**m["info"], setup_s=setup_s)
    say(host={"start": host_between(h0, h1), "measure": host_between(h1, h2)})
    device = {"platform": "gpu", "kind": card["kind"], "count": cell["chips"],
              "memory_peak_bytes": torch.cuda.max_memory_allocated()}
    obs = session.observations(m, card["kind"]) if args.trace else None
    if obs is not None:
        device.update(busy_s=obs.trace["busy_s"], window_s=obs.trace["window_s"])
    vk, jwk_n = session.vk, session.gen.key.n
    config = session.config
    vk_bad = vk_check(vk, session.zkey)
    session.close()
    del session
    torch.cuda.empty_cache()

    fn, tasks = judge_tasks(m, vk, jwk_n, circuit_facts(config))
    counts = counted(m, judge_all(fn, tasks, os.cpu_count() or 1), vk_bad)
    line = result_line(spec, cell, m, obs, bool(args.trace), setup_s, device, counts)
    bad = forbidden_modules()
    if bad:
        print(f"zkbench: the run loaded {bad}; it may load no JAX and no JAX package", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
