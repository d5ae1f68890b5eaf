"""A traced window: torch.profiler over the device, and the benchmark's
own host spans around the calls into each layer.

The profiler's CPU and device events share one clock; two annotations
made by the thread that runs the window (`zkbench.window_start`,
`zkbench.window_end`) tie that clock to time.perf_counter, on which the
host spans are recorded. From the device events inside the window
(kernels, copies, sets) come the busy seconds (the union of their
intervals), the operations that took most time, and the longest gaps
with nothing running on the device, each named by the host span that
covered most of it.
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


class Tracer:
    def __init__(self, out_path: Path):
        self.out_path = Path(out_path)
        self.spans: list[tuple[str, float, float]] = []
        self._lock = threading.Lock()
        self._prof = None
        self.marks: dict[str, float] = {}

    def record(self, name: str, t0: float, t1: float) -> None:
        with self._lock:
            self.spans.append((name, t0, t1))

    def start(self) -> None:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)
        self._prof.__enter__()

    def mark(self, name: str) -> float:
        import torch

        with torch.profiler.record_function(name):
            t = time.perf_counter()
        self.marks[name] = t
        return t

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        self.out_path.parent.mkdir(parents=True, exist_ok=True)
        self._prof.export_chrome_trace(str(self.out_path))
        self._prof = None

    def summary(self) -> dict:
        """{busy_s, window_s, device_ops, idle_gaps} of the window between
        the two marks; the exported trace is deleted once read."""
        try:
            events = json.loads(self.out_path.read_text())["traceEvents"]
        finally:
            self.out_path.unlink(missing_ok=True)
        return summarize(events, self.spans, self.marks)


def summarize(events: list[dict], spans: list[tuple[str, float, float]], marks: dict) -> dict:
    """The window's device busy seconds, top operations and idle gaps.
    `marks` holds the perf_counter times of the window's two annotations."""
    ann = {e["name"]: float(e["ts"]) for e in events
           if e.get("ph") == "X" and e.get("cat") != "gpu_user_annotation"
           and e.get("name") in ("zkbench.window_start", "zkbench.window_end")}
    if len(ann) != 2:
        raise ValueError("the trace lacks the window's annotations")
    ws, we = ann["zkbench.window_start"], ann["zkbench.window_end"]
    offset = ws - marks["zkbench.window_start"] * 1e6  # trace us = perf_counter us + offset
    intervals, by_name = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        a, b = max(float(e["ts"]), ws), min(float(e["ts"]) + float(e.get("dur", 0)), we)
        if b <= a:
            continue
        intervals.append((a, b))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a)
    busy, gaps = 0.0, []
    cursor = ws
    for a, b in sorted(intervals):
        if a > cursor:
            gaps.append((cursor, a))
        if b > cursor:
            busy += b - max(a, cursor)
            cursor = b
    if we > cursor:
        gaps.append((cursor, we))
    host = [(n, t0 * 1e6 + offset, t1 * 1e6 + offset) for n, t0, t1 in spans]
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
        cover: dict = {}
        for n, s0, s1 in host:
            ov = min(b, s1) - max(a, s0)
            if ov > 0:
                cover[n] = cover.get(n, 0.0) + ov
        named.append([max(cover, key=cover.get) if cover else "no span", (b - a) / 1e6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": busy / 1e6,
        "window_s": (we - ws) / 1e6,
        "device_ops": [[name[:160], us / 1e6] for name, us in ops],
        "idle_gaps": named,
    }
