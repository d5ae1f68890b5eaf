"""The five MSMs' share of their roofline: the least time (the bytes
yardstick.msm_floor_bytes counts from the key file, at the card's HBM
peak) over the measured `msm_*` phase time, both summed over the window's
batches. Bound: bytes."""

from zkbench.readings import MSM_PHASES
from zkbench.yardstick import HBM_BYTES_PER_S, msm_floor_bytes


def read(obs):
    peak = HBM_BYTES_PER_S.get(obs.device_kind)
    done = [b for b in obs.batches if all(p in b["phase_ms"] for p in MSM_PHASES)]
    if peak is None or obs.key_counts is None or not done:
        return None
    least_s = sum(msm_floor_bytes(obs.key_counts, b["size"]) for b in done) / peak
    measured_s = sum(b["phase_ms"][p] for b in done for p in MSM_PHASES) / 1e3
    return 100.0 * least_s / measured_s
