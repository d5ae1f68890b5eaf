"""The port's flat-stream Pippenger at lane counts that do not divide the
stream, against the discrete-log oracle.

On the card the scan runs one wave of lanes (ops/msm.py `_SCAN_LANES`,
132 SMs x the blocks per SM its registers allow), not a power of two, so
the stream is padded with sentinel entries to whole lanes. These cases run
that padding, buckets that cross many lanes (the boundary merge's pass
count comes from the boundary keys) and lanes of one slab, on the CPU
through the kernels' plain versions."""

import numpy as np
import pytest
import torch

from keyless_zk_tpu_torch.curves.jacobian import G1_CURVE, JacPoint
from keyless_zk_tpu_torch.fields.bn254 import R_SCALAR as R
from keyless_zk_tpu_torch.ops import msm
from torch_fixtures import GROUPS, limbs_t, points_with_dlogs, rand_ints

torch.set_num_threads(1)


@pytest.mark.parametrize("n,mode,c,v", [
    (150, "sparse", 9, 7),  # compacted stream, 7 lanes: padding, buckets across lanes
    (150, "sparse", 9, 1),  # one lane walks the whole stream
    (40, "dense", 4, 13),   # dense stream of 64 windows, 13 lanes
    (40, "dense", 4, 640),  # more lanes than entries per lane: one slab each
])
def test_pippenger_at_any_lane_count(n, mode, c, v):
    rng = np.random.default_rng(n + v)
    pts, dlogs = points_with_dlogs("fq", n, rng)
    pts[3], dlogs[3] = None, 0
    sc = rand_ints(rng, n) if mode == "dense" else [int(b) for b in rng.integers(0, 2, n)]
    sc[0], sc[1] = 0, R - 1
    x, y, inf = G1_CURVE.encode_affine(pts)
    scalars = limbs_t(sc)
    total = -(-msm.SCALAR_BITS // c) * n
    cap = min(msm._p2(max(msm._count_nonzero_digits(scalars, c), 1)), msm._p2(total))
    assert cap % v or v == 1 or v > cap // 2
    out = msm._msm_pippenger_fused(x, y, inf, scalars, tag="fq", c=c, v=v, cap=cap)
    got = G1_CURVE.decode_jacobian(JacPoint(*(t[None] for t in out)))[0]
    group, gen = GROUPS["fq"]
    assert got == group.mul(gen, sum(s * k for s, k in zip(sc, dlogs)) % R)
