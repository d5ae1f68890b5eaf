"""What a run leaves for the per-layer metrics' readers
(`zkbench/metrics/<name>.py`, each a `read(obs)` that returns a number,
or None where it finds nothing to read)."""

from __future__ import annotations

from dataclasses import dataclass, field

MSM_PHASES = ("msm_a", "msm_b1", "msm_b2", "msm_c", "msm_h")


@dataclass
class Observations:
    device_kind: str
    startup_s: dict
    breakdowns: list = field(default_factory=list)  # the service's, one per request of the window
    batches: list = field(default_factory=list)  # {size, phase_ms} of each batch the window completed
    trace: dict | None = None  # trace.summarize's, of the window
    key_counts: dict | None = None  # yardstick.key_counts of the key the service loaded


def idle_pct(obs: Observations):
    t = obs.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
