"""The knee sweep's rules: a window grows when its last third waits half
again as long as its first, or a request fails; the knee is the highest
rate below the first at which any window grew."""

import math

from zkbench import sweep


def _m(lat_s, p50=1.0, p90=2.0):
    return {"latencies": lat_s, "end_to_end": {"request_p90_ms": p90}, "info": {"request_p50_ms": p50}}


def test_a_window_grows_when_its_last_third_waits_longer():
    assert not sweep.point(_m([1.0] * 9 + [1.4] * 3), 0.5)["growing"]
    assert sweep.point(_m([1.0] * 9 + [1.6] * 3), 0.5)["growing"]
    assert sweep.point(_m([1.0] * 5 + [math.inf]), 0.5)["growing"]


def test_the_knee_is_below_the_first_rate_any_window_grew_at():
    pts = [{"rate_per_s": r, "growing": g} for r, g in
           [(0.5, False), (0.5, False), (0.8, False), (0.8, False), (0.9, False), (0.9, True), (1.0, False)]]
    assert sweep.knee(pts) == 0.8
    assert sweep.knee([{"rate_per_s": 0.5, "growing": True}]) is None
