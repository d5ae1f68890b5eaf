"""Shared inputs for the PyTorch port's parity tests: points with known
discrete logs, made quickly on the host from a seeded numpy generator.

The host curve here is the JAX package's (keyless_zk_tpu/curves/
ref_curve.py), not the port's copy, so the oracle the port's MSMs are held
against is independent of the port."""

import numpy as np
import torch

from keyless_zk_tpu.curves import ref_curve
from keyless_zk_tpu_torch.fields.bn254 import R_SCALAR as R
from keyless_zk_tpu_torch.fields.limbs import ints_to_limbs

GROUPS = {"fq": (ref_curve.G1, ref_curve.G1_GEN), "fq2": (ref_curve.G2, ref_curve.G2_GEN)}


def rand_ints(rng, n, mod=R):
    return [int.from_bytes(rng.bytes(32), "little") % mod for _ in range(n)]


def points_with_dlogs(tag, n, rng):
    """n affine points P_i = k_i * G with known k_i: a random walk over 8
    random full-width steps, one affine add per point. Subset-sum
    coincidences inside MSM buckets would need a small linear relation
    among random 254-bit values, so they do not occur."""
    group, gen = GROUPS[tag]
    steps = rand_ints(rng, 8)
    step_pts = [group.mul(gen, s) for s in steps]
    k = rand_ints(rng, 1)[0]
    p = group.mul(gen, k)
    pts, dlogs = [], []
    for _ in range(n):
        j = int(rng.integers(8))
        p = group.add(p, step_pts[j])
        k = (k + steps[j]) % R
        pts.append(p)
        dlogs.append(k)
    return pts, dlogs


def limbs_t(vals):
    return torch.from_numpy(ints_to_limbs(vals).astype(np.int32))
