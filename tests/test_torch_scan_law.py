"""The group law of K4's complete body on G1 (ops/cuda_curve.py
`madd_proj_plain`, Renes, Costello and Batina 2016, Algorithm 8, on a
homogeneous projective accumulator) with its conversion to Jacobian
coordinates (`proj_to_jac_plain`), against the complete body's first law
(`cuda_curve.madd_plain`, madd-2007-bl with the affine doubling), the JAX
package's curves/jacobian.py `add_mixed` and the host group law, as affine
points, case by case: P + Q, P + P with the accumulator's z != 1,
P + (-P), the accumulator at infinity, Q at infinity, both at infinity.
The complete body keeps `madd_plain` on G2, so these cases are G1's.

Points are multiples of the generator by numpy-seeded scalars; each
accumulator is its point scaled by a random lambda != 1 (projective
(x l : y l : l), Jacobian (x l^2, y l^3, l)). Exact integers, no tolerance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keyless_zk_tpu.curves import ref_curve
from keyless_zk_tpu.curves.jacobian import G1_CURVE as JG1
from keyless_zk_tpu.curves.jacobian import JacPoint as JJac
from keyless_zk_tpu_torch.curves.jacobian import G1_CURVE, JacPoint
from keyless_zk_tpu_torch.fields.bn254 import Q
from keyless_zk_tpu_torch.ops import cuda_curve
from torch_fixtures import rand_ints

torch.set_num_threads(1)

N = 16
CASES = ("p_plus_q", "p_plus_p", "p_plus_neg_p", "acc_inf", "q_inf", "both_inf")
R_MONT = (1 << 256) % Q
F = G1_CURVE.ops


def _host(t) -> list:
    """(n, 16) Montgomery limbs -> host ints."""
    return [v * pow(R_MONT, -1, Q) % Q for v in F.decode(t, mont=False)]


def _jac_affine(p: JacPoint) -> list:
    out = []
    for x, y, z in zip(*(_host(c) for c in p)):
        if z == 0:
            out.append(None)
            continue
        zi = pow(z, -1, Q)
        out.append((x * zi * zi % Q, y * zi ** 3 % Q))
    return out


def inputs(case: str, seed: int):
    """(accumulator points, incoming points, lambdas, Y of the projective
    infinities): host lists of N lanes."""
    rng = np.random.default_rng(seed)
    group, gen = ref_curve.G1, ref_curve.G1_GEN
    ps = [group.mul(gen, k) for k in rand_ints(rng, N)]
    qs = [group.mul(gen, k) for k in rand_ints(rng, N)]
    lams = [2 + v % (Q - 2) for v in rand_ints(rng, N, Q)]
    ys = [1 if i % 2 == 0 else lams[i] for i in range(N)]  # (0 : 1 : 0) and (0 : l : 0)
    if case == "p_plus_p":
        qs = list(ps)
    elif case == "p_plus_neg_p":
        qs = [group.neg(p) for p in ps]
    if case in ("acc_inf", "both_inf"):
        ps = [None] * N
    if case in ("q_inf", "both_inf"):
        qs = [None] * N
    return ps, qs, lams, ys


def accumulators(ps, lams, ys):
    """The same points as a projective and a Jacobian batch."""
    proj, jac = [], []
    for p, lam, y in zip(ps, lams, ys):
        if p is None:
            proj.append((0, y, 0))
            jac.append((0, 0, 0))
        else:
            proj.append((p[0] * lam % Q, p[1] * lam % Q, lam))
            jac.append((p[0] * lam * lam % Q, p[1] * lam ** 3 % Q, lam))
    return (JacPoint(*(F.encode([c[i] for c in proj]) for i in range(3))),
            JacPoint(*(F.encode([c[i] for c in jac]) for i in range(3))))


@pytest.mark.parametrize("case", CASES)
def test_projective_law_matches_first_law_jax_and_host(case):
    ps, qs, lams, ys = inputs(case, seed=CASES.index(case) + 70)
    proj, jac = accumulators(ps, lams, ys)
    qx, qy, q_inf = G1_CURVE.encode_affine(qs)

    got = cuda_curve.proj_to_jac_plain(cuda_curve.madd_proj_plain(proj, qx, qy, q_inf, "fq"), "fq")
    got_aff = _jac_affine(got)
    want = [ref_curve.G1.add(p, q) for p, q in zip(ps, qs)]
    assert got_aff == want
    assert _jac_affine(cuda_curve.madd_plain(jac, qx, qy, q_inf, "fq")) == want

    def j(t):
        return jnp.asarray(t.numpy().astype(np.uint32))

    jout = JG1.add_mixed(JJac(*(j(c) for c in jac)), j(qx), j(qy), jnp.asarray(q_inf.numpy()))
    assert _jac_affine(JacPoint(*(torch.from_numpy(np.asarray(c).astype(np.int64)).int() for c in jout))) == want
    if case in ("p_plus_neg_p", "both_inf"):
        assert got_aff == [None] * N and not got.z.any()


def test_madd_proj_plain_is_algorithm_8_coordinates():
    """madd_proj_plain gives the projective coordinates of Algorithm 8's 26
    steps, transcribed here on host ints (the kernel's csrc/ec.cuh
    `madd_proj` is held to madd_proj_plain limb for limb on the card); and
    a run's first accumulator is (x : y : 1), or (0 : 1 : 0) at infinity."""
    ps, qs, lams, ys = inputs("p_plus_q", seed=80)
    qs[:4] = ps[:4]  # P == Q lanes too
    proj, _ = accumulators(ps, lams, ys)
    qx, qy, q_inf = G1_CURVE.encode_affine(qs)
    got = cuda_curve.madd_proj_plain(proj, qx, qy, q_inf, "fq")
    b3 = 9
    for lane, (p, q, lam) in enumerate(zip(ps, qs, lams)):
        X1, Y1, Z1 = p[0] * lam % Q, p[1] * lam % Q, lam
        X2, Y2 = q
        t0 = X1 * X2
        t1 = Y1 * Y2
        t3 = (X2 + Y2) * (X1 + Y1) - (t0 + t1)
        t4 = Y2 * Z1 + Y1
        Y3 = X2 * Z1 + X1
        t0 = 3 * t0
        t2 = b3 * Z1
        Z3 = t1 + t2
        t1 = t1 - t2
        Y3 = b3 * Y3
        X3 = t3 * t1 - t4 * Y3
        Y3 = t1 * Z3 + Y3 * t0
        Z3 = Z3 * t4 + t0 * t3
        assert [_host(c[lane : lane + 1])[0] for c in got] == [X3 % Q, Y3 % Q, Z3 % Q]
    qs[5] = None
    qx, qy, q_inf = G1_CURVE.encode_affine(qs)
    start = cuda_curve.proj_start_plain(qx, qy, q_inf, "fq")
    assert [_host(c[5:6])[0] for c in start] == [0, 1, 0]
    assert [_host(c[0:1])[0] for c in start] == [qs[0][0], qs[0][1], 1]


def test_madd_proj_plain_is_g1_only():
    ps, qs, lams, ys = inputs("p_plus_q", seed=81)
    proj, _ = accumulators(ps, lams, ys)
    qx, qy, q_inf = G1_CURVE.encode_affine(qs)
    with pytest.raises(ValueError):
        cuda_curve.madd_proj_plain(proj, qx, qy, q_inf, "fq2")
