"""Find the knee of an open-loop cell: the highest offered rate it
sustains without a growing backlog, in one process on one card.

    python -m zkbench.sweep --workload <open-loop cell> --rates 0.7,0.8,... \\
        --seconds 51 --seed <n> [--out chiprun_out/sweep]

The service starts once; each rate, in ascending order, runs REPEATS
windows of the cell's traffic at that rate, each window on its own seed
(seed, seed + 1, ...: another order of the same work). A backlog grows
where the median latency of the last third of a window's requests
exceeds the first third's by half or more, or where a request fails.
Near the knee one window in several grows (the host's speed moves
between windows), so a rate is sustained only where none of its
windows grew, and the sweep stops at the first rate where one did. The
knee is the highest rate below it (at least the highest rate tried,
where none grew). The tool rewrites the cell's own traffic file
(`zkbench/traffic/<traffic>.json`) with `rate_per_s` set to 4/5 of the
knee and the sweep's points under `sweep`, and writes a copy of it and
a table of the points in Markdown into `--out`.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

from . import stats
from .run import Session, card_info, cache_env
from .spec import Spec

GROWTH = 1.5
SHARE = 0.8  # the cell runs at 4/5 of its knee
REPEATS = 3


def point(m: dict, rate: float) -> dict:
    lat = [x * 1e3 for x in m["latencies"]]
    third = max(1, len(lat) // 3)
    first, last = stats.median(lat[:third]), stats.median(lat[-third:])
    failed = sum(1 for x in lat if math.isinf(x))
    return {"rate_per_s": rate, "requests": len(lat), "failed": failed,
            "p50_ms": m["info"]["request_p50_ms"], "p90_ms": m["end_to_end"]["request_p90_ms"],
            "first_third_ms": first, "last_third_ms": last,
            "growing": bool(failed or last > GROWTH * first)}


def knee(points: list[dict]) -> float | None:
    """The highest rate below the first at which any window grew."""
    best = None
    for rate in sorted({p["rate_per_s"] for p in points}):
        if any(p["growing"] for p in points if p["rate_per_s"] == rate):
            break
        best = rate
    return best


def table(points: list[dict]) -> str:
    rows = ["| rate (req/s) | seed | requests | failed | p50 ms | p90 ms | first third ms | last third ms | growing |",
            "|---|---|---|---|---|---|---|---|---|"]
    for p in points:
        rows.append(f"| {p['rate_per_s']} | {p.get('seed', '')} | {p['requests']} | {p['failed']} | {p['p50_ms']:.1f} "
                    f"| {p['p90_ms']:.1f} "
                    f"| {p['first_third_ms']:.1f} | {p['last_third_ms']:.1f} | {p['growing']} |")
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m zkbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True, help="comma-separated requests per second, ascending")
    ap.add_argument("--seconds", type=float, default=None, help="a window's length (default: run_seconds)")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default="chiprun_out/sweep")
    args = ap.parse_args(argv)
    root = Path.cwd()
    os.environ.update(cache_env(root))
    import torch

    if not torch.cuda.is_available():
        print("zkbench.sweep: no CUDA device", file=sys.stderr)
        return 2
    spec = Spec(root)
    cell = spec.cell(args.workload)
    if args.seconds is None:
        args.seconds = float(spec.data["run_seconds"])
    card = card_info()
    session = Session(root, spec, cell)
    if session.traffic["loop"] != "open":
        print("zkbench.sweep: the cell's traffic is not an open loop", file=sys.stderr)
        return 2
    base = {k: v for k, v in session.traffic.items() if k != "sweep"}
    points = []
    for rate in (float(r) for r in args.rates.split(",")):
        session.traffic = {**base, "rate_per_s": rate}
        for _ in range(REPEATS):
            t = time.perf_counter()
            seed = args.seed + len(points)
            m = session.measure(seed, args.seconds)
            m["latencies"] = [(a["done"] - a["due"]) if a and a["status"] == 200 else math.inf for a in m["answers"]]
            points.append({**point(m, rate), "seed": seed})
            print(json.dumps({"point": points[-1], "s": time.perf_counter() - t}), flush=True)
        if any(p["growing"] for p in points[-REPEATS:]):
            break  # past the knee: higher rates only grow faster
    session.close()
    k = knee(points)
    traffic = {**base, "sweep": {"card": card, "seconds": args.seconds, "seed": args.seed, "growth": GROWTH, "repeats": REPEATS,
                                 "knee_per_s": k, "share": SHARE, "points": points}}
    if k is not None:
        traffic["rate_per_s"] = round(SHARE * k, 4)
    else:
        print("zkbench.sweep: the lowest rate already grew; the cell's rate is left as it was", file=sys.stderr)
    text = json.dumps(traffic, indent=1) + "\n"
    (root / "zkbench" / "traffic" / f"{cell['traffic']}.json").write_text(text)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{cell['traffic']}.json").write_text(text)
    md = f"Knee sweep of `{cell['name']}` ({card['kind']}, {card['nvidia_smi']}), {REPEATS} windows of " \
         f"{args.seconds:g} s a rate, seeds from {args.seed}: knee {k} requests/s, cell rate {traffic['rate_per_s']}.\n\n{table(points)}\n"
    (out / f"{cell['name']}.md").write_text(md)
    print(md)
    return 0


if __name__ == "__main__":
    sys.exit(main())
