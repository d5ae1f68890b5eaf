"""The port's MSM dispatcher (ops/msm.py) against the discrete-log oracle
and the JAX package's msm.

Points P_i = k_i * G have known k_i, so the expected MSM is
(sum s_i k_i) * G: one host scalar multiplication. Every n is served: the
direct path (n <= 128) and the flat-stream Pippenger above it, in dense
mode (uniform scalars: the stream is every window's digits) and compacted
mode (bit-valued scalars, as most keyless witness wires are), with zero
scalars and infinity rows. On the CPU the MSM kernels run their plain
versions. The dense mode is exercised up to n = 256 here: at n = 1000 its
plain bucket reduction alone takes minutes of CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keyless_zk_tpu.curves import jacobian as jjac
from keyless_zk_tpu.ops import msm as jmsm
from keyless_zk_tpu_torch.curves.jacobian import G1_CURVE, G2_CURVE, JacPoint
from keyless_zk_tpu_torch.fields.bn254 import R_SCALAR as R
from keyless_zk_tpu_torch.ops import msm
from torch_fixtures import GROUPS, limbs_t, points_with_dlogs, rand_ints

torch.set_num_threads(1)

CURVES = {"fq": G1_CURVE, "fq2": G2_CURVE}


def _case(tag, n, mode, seed):
    rng = np.random.default_rng(seed)
    pts, dlogs = points_with_dlogs(tag, n, rng)
    pts[5] = None
    dlogs[5] = 0
    if mode == "dense":
        sc = rand_ints(rng, n)
    else:
        sc = [int(b) for b in rng.integers(0, 2, n)]
        sc[7] = 40000
        sc[9] = rand_ints(rng, 1)[0]
    sc[0] = 0
    sc[1] = R - 1
    return pts, dlogs, sc


def _run(tag, pts, sc):
    curve = CURVES[tag]
    x, y, inf = curve.encode_affine(pts)
    out = msm.msm(x, y, inf, limbs_t(sc), curve=curve)
    return curve.decode_jacobian(JacPoint(*(c[None] for c in out)))[0]


def _oracle(tag, dlogs, sc):
    group, gen = GROUPS[tag]
    return group.mul(gen, sum(s * k for s, k in zip(sc, dlogs)) % R)


@pytest.mark.parametrize("n,mode", [
    (100, "dense"), (129, "dense"), (129, "sparse"), (200, "dense"), (200, "sparse"),
    (256, "dense"), (256, "sparse"), (1000, "sparse"), (2065, "sparse"),
])
def test_msm_g1_matches_oracle(n, mode):
    pts, dlogs, sc = _case("fq", n, mode, n)
    assert _run("fq", pts, sc) == _oracle("fq", dlogs, sc)


def test_compaction_engages():
    """Bit-valued scalars compact the stream far below windows * n."""
    _, _, sc = _case("fq", 1000, "sparse", 1)
    nnz = msm._count_nonzero_digits(limbs_t(sc), 9)
    assert nnz < 1000 and -(-254 // 9) * 1000 > 4 * nnz


@pytest.mark.parametrize("n", [100, 129])
def test_msm_g1_matches_jax_msm(n):
    """Same points and scalars through the JAX package's msm: at n = 100
    both packages take their direct paths; at n = 129 the port takes its
    flat-stream Pippenger and the JAX package, on the CPU, its portable XLA
    Pippenger (`_msm_pippenger`). They sum in different orders, so the
    results are compared as affine points, and against the oracle."""
    pts, dlogs, sc = _case("fq", n, "dense", 100 + n)
    jx, jy, jinf = jjac.G1_CURVE.encode_affine(pts)
    j = jmsm.msm(jx, jy, jinf, jnp.asarray(limbs_t(sc).numpy().astype(np.uint32)), curve=jjac.G1_CURVE)
    want = jjac.G1_CURVE.decode_jacobian(jjac.JacPoint(*(c[None] for c in j)))[0]
    assert want == _oracle("fq", dlogs, sc)
    assert _run("fq", pts, sc) == want


def test_digits_match_jax():
    rng = np.random.default_rng(8)
    sc = rand_ints(rng, 40) + [0, R - 1, 1]
    for c in (4, 9, 12, 16):
        t = limbs_t(sc)
        jk, jn = jmsm.extract_digits_signed(jnp.asarray(t.numpy().astype(np.uint32)), c)
        tk, tn = msm.extract_digits_signed(t, c)
        assert np.array_equal(np.asarray(jk), tk.numpy()) and np.array_equal(np.asarray(jn), tn.numpy())
        assert np.array_equal(np.asarray(jmsm.extract_digits(jnp.asarray(t.numpy().astype(np.uint32)), c)),
                              msm.extract_digits(t, c).numpy())
