"""The port's batched MSM (ops/msm.py `msm_batch`) and the batched K7
(ops/cuda_msm.py `horner_total` over (3R, B, Wn) window totals) against
the JAX package.

`msm_batch` runs B scalar vectors over one point table in one flat stream
whose bucket ids carry the batch offset; on the CPU the JAX `msm_batch`
runs one XLA MSM per element. The two sum in different orders, so the
results are compared as affine points (exact BN254 integers, no
tolerance). Batches hold one element of random scalars, one of 0/1
scalars and one of zeros; n = 200 takes the flat stream, n = 100 the
direct double-and-add per element. The batched K7's plain version runs
every element's Horner chain at once, and is held bit for bit against B
unbatched calls and against msm_sim.horner_total per element."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keyless_zk_tpu.curves import jacobian as jjac
from keyless_zk_tpu.ops import msm as jmsm
from keyless_zk_tpu.ops import msm_sim
from keyless_zk_tpu_torch.curves.jacobian import G1_CURVE, G2_CURVE, JacPoint
from keyless_zk_tpu_torch.fields.bn254 import R_SCALAR as R
from keyless_zk_tpu_torch.ops import cuda_msm, msm
from torch_fixtures import GROUPS, limbs_t, points_with_dlogs, rand_ints

torch.set_num_threads(1)

B = 3


def _batch(tag, n, seed):
    """Points with known discrete logs (one at infinity) and B scalar
    vectors: random, 0/1, all zero."""
    rng = np.random.default_rng(seed)
    pts, dlogs = points_with_dlogs(tag, n, rng)
    pts[5], dlogs[5] = None, 0
    vecs = [rand_ints(rng, n), [int(b) for b in rng.integers(0, 2, n)], [0] * n]
    vecs[0][1] = R - 1
    return pts, dlogs, vecs


def _port(curve, pts, vecs):
    x, y, inf = curve.encode_affine(pts)
    out = msm.msm_batch(x, y, inf, torch.stack([limbs_t(v) for v in vecs]), curve=curve)
    assert out.x.shape[0] == len(vecs)
    return curve.decode_jacobian(out)


@pytest.mark.parametrize("n", [200, 100])
def test_msm_batch_g1_matches_jax(n):
    """At n = 200 the JAX side (an XLA Pippenger per element, ~25 s each on
    the CPU) runs the two nonzero elements; the zero element must be the
    point at infinity, which is what any MSM of zero scalars gives."""
    pts, dlogs, vecs = _batch("fq", n, 300 + n)
    jx, jy, jinf = jjac.G1_CURVE.encode_affine(pts)
    k = 2 if n > 128 else B
    sc = jnp.stack([jnp.asarray(limbs_t(v).numpy().astype(np.uint32)) for v in vecs[:k]])
    want = jjac.G1_CURVE.decode_jacobian(jmsm.msm_batch(jx, jy, jinf, sc, curve=jjac.G1_CURVE))
    got = _port(G1_CURVE, pts, vecs)
    assert got[:k] == want and got[2] is None
    group, gen = GROUPS["fq"]
    assert got[1] == group.mul(gen, sum(s * k for s, k in zip(vecs[1], dlogs)) % R)


def test_msm_batch_g2_matches_host():
    n = 200
    pts, dlogs, vecs = _batch("fq2", n, 7)
    group, gen = GROUPS["fq2"]
    want = [group.mul(gen, sum(s * k for s, k in zip(v, dlogs)) % R) for v in vecs]
    assert _port(G2_CURVE, pts, vecs) == want


def _windows(tag, rng, b, wn):
    """(3R, b, wn) window totals: random points (one at infinity), z != 1."""
    curve = cuda_msm.curve_for(tag)
    pts, _ = points_with_dlogs(tag, b * wn, rng)
    pts[1] = None
    x, y, inf = curve.encode_affine(pts)
    p = curve.dbl(curve.from_affine(x, y, inf))
    return cuda_msm.point_to_planes(p, tag).reshape(-1, b, wn).contiguous()


@pytest.mark.parametrize("tag", ["fq", "fq2"])
def test_batched_horner_matches_unbatched_and_contract(tag):
    rng = np.random.default_rng(11)
    R = cuda_msm.rows_for(tag)
    wn, c = (4, 5) if tag == "fq" else (3, 2)  # the JAX contract runs op by op: G2 kept short
    wins = _windows(tag, rng, B, wn)
    got = cuda_msm.horner_total(tag, wins, c)
    assert got.shape == (3 * R, B)
    for b in range(B):
        one = cuda_msm.horner_total(tag, wins[:, b].contiguous(), c)
        assert torch.equal(got[:, b], one)
        want = msm_sim.horner_total(
            tag, *(jnp.asarray(wins[i * R : (i + 1) * R, b].T.numpy().astype(np.uint32)) for i in range(3)), c)
        for i in range(3):
            assert np.array_equal(np.asarray(want[i]).astype(np.int64), got[i * R : (i + 1) * R, b].numpy())
