"""K3's plain versions (ops/cuda_curve.py madd_plain, dbl_plain, add_plain)
against the JAX package, G1 and G2, n = 64, with every edge case planted:
p at infinity, q at infinity, both, P == Q, P == -Q.

Two references: the JAX package's Jacobian curves (`add_mixed`, `dbl`,
`add`), compared as affine points (host ints), as tests/test_pallas_curve.py
compares the Pallas kernels; and the Pallas kernels' own cores
(`pallas_ec.madd_core` without `assume_distinct`, `dbl_core`, `add_core`)
evaluated as plain jnp on the CPU, compared in Jacobian coordinates, bit for
bit. The wrappers take the plain version for CPU tensors and refuse a
tensor that is on neither the CPU nor a card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keyless_zk_tpu.curves import ref_curve
from keyless_zk_tpu.curves.jacobian import G1_CURVE as JG1
from keyless_zk_tpu.curves.jacobian import G2_CURVE as JG2
from keyless_zk_tpu.curves.jacobian import JacPoint as JJac
from keyless_zk_tpu.ops import pallas_ec
from keyless_zk_tpu_torch.curves.jacobian import G1_CURVE, G2_CURVE, JacPoint
from keyless_zk_tpu_torch.fields.bn254 import Q
from keyless_zk_tpu_torch.ops import cuda_curve
from torch_fixtures import points_with_dlogs, rand_ints

torch.set_num_threads(1)

N = 64
CASES = {"p_inf": 0, "q_inf": 1, "same": 2, "opposite": 3, "both_inf": 4}
R_INV = pow(1 << 256, -1, Q)


def _host_fq(v: int) -> int:
    return v * R_INV % Q


def _affine(tag, x, y, z):
    """Host affine point (None at infinity) of Montgomery Jacobian limbs."""
    dec = G1_CURVE.ops.decode if tag == "fq" else G2_CURVE.ops.decode
    xs, ys, zs = dec(x, mont=False), dec(y, mont=False), dec(z, mont=False)
    out = []
    for xv, yv, zv in zip(xs, ys, zs):
        if tag == "fq":
            xv, yv, zv = _host_fq(xv), _host_fq(yv), _host_fq(zv)
            if zv == 0:
                out.append(None)
                continue
            zi = pow(zv, -1, Q)
            out.append((xv * zi * zi % Q, yv * zi * zi * zi % Q))
        else:
            xv, yv, zv = (tuple(_host_fq(c) for c in v) for v in (xv, yv, zv))
            if zv == (0, 0):
                out.append(None)
                continue
            zi = ref_curve.fq2_inv(zv)
            zi2 = ref_curve.fq2_sqr(zi)
            out.append((ref_curve.fq2_mul(xv, zi2), ref_curve.fq2_mul(yv, ref_curve.fq2_mul(zi2, zi))))
    return out


def _inputs(tag, seed):
    """Jacobian p and q with random z, q's affine form and its infinity
    mask, the edge cases in lanes 0-4."""
    rng = np.random.default_rng(seed)
    curve = G1_CURVE if tag == "fq" else G2_CURVE
    f = curve.ops
    pts, _ = points_with_dlogs(tag, 2 * N, rng)
    p_aff, q_aff = pts[:N], pts[N:]
    group = ref_curve.G1 if tag == "fq" else ref_curve.G2
    q_aff[CASES["same"]] = p_aff[CASES["same"]]
    q_aff[CASES["opposite"]] = group.neg(p_aff[CASES["opposite"]])
    px, py, _ = curve.encode_affine(p_aff)
    qx, qy, _ = curve.encode_affine(q_aff)

    def z(shift):
        vals = rand_ints(rng, N, Q)
        if tag == "fq":
            return f.encode(vals)
        return f.encode([(v, (v + shift) % Q) for v in vals])

    def scaled(x, y, lam):
        l2 = f.sqr(lam)
        return JacPoint(f.mul(x, l2), f.mul(y, f.mul(l2, lam)), lam)

    lane = torch.arange(N)
    p_inf = (lane == CASES["p_inf"]) | (lane == CASES["both_inf"])
    q_inf = (lane == CASES["q_inf"]) | (lane == CASES["both_inf"])
    p = scaled(px, py, z(1))
    p = JacPoint(p.x, p.y, f.select(p_inf, torch.zeros_like(p.z), p.z))
    q = scaled(qx, qy, z(2))
    q = JacPoint(q.x, q.y, f.select(q_inf, torch.zeros_like(q.z), q.z))
    return p, q, qx, qy, q_inf


def _j(t):
    return jnp.asarray(t.numpy().astype(np.uint32))


def _jac_j(p):
    return JJac(*(_j(c) for c in p))


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64)).int()


def _rows_j(tag, t):
    """(n, 16) / (n, 2, 16) torch -> pallas_ec element (limb list / pair)."""
    a = t.numpy().astype(np.uint32)
    if tag == "fq":
        return [jnp.asarray(a[:, i]) for i in range(16)]
    return ([jnp.asarray(a[:, 0, i]) for i in range(16)], [jnp.asarray(a[:, 1, i]) for i in range(16)])


def _rows_t(tag, el):
    if tag == "fq":
        return torch.from_numpy(np.stack([np.asarray(v) for v in el], axis=-1).astype(np.int64)).int()
    return torch.stack([_rows_t("fq", el[0]), _rows_t("fq", el[1])], dim=-2)


@pytest.mark.parametrize("tag", ["fq", "fq2"])
def test_plain_group_ops_match_jax_curves_as_affine_points(tag):
    p, q, qx, qy, q_inf = _inputs(tag, seed=41 if tag == "fq" else 42)
    jcurve = JG1 if tag == "fq" else JG2
    group = ref_curve.G1 if tag == "fq" else ref_curve.G2
    P, Qa = _affine(tag, *p), _affine(tag, *q)
    assert P[CASES["p_inf"]] is None and Qa[CASES["q_inf"]] is None
    assert P[CASES["same"]] == Qa[CASES["same"]]
    assert P[CASES["opposite"]] == group.neg(Qa[CASES["opposite"]])

    ops = {
        "madd": (cuda_curve.madd_plain(p, qx, qy, q_inf, tag),
                 jcurve.add_mixed(_jac_j(p), _j(qx), _j(qy), jnp.asarray(q_inf.numpy()))),
        "dbl": (cuda_curve.dbl_plain(p, tag), jcurve.dbl(_jac_j(p))),
        "add": (cuda_curve.add_plain(p, q, tag), jcurve.add(_jac_j(p), _jac_j(q))),
    }
    for name, (got, want) in ops.items():
        got_aff = _affine(tag, *got)
        assert got_aff == _affine(tag, *(_t(c) for c in want)), name
        # and the group law itself, on the host
        expect = [group.add(a, a) for a in P] if name == "dbl" else [group.add(a, b) for a, b in zip(P, Qa)]
        assert got_aff == expect, name
    assert _affine(tag, *ops["madd"][0])[CASES["opposite"]] is None
    assert _affine(tag, *ops["madd"][0])[CASES["both_inf"]] is None


@pytest.mark.parametrize("tag", ["fq", "fq2"])
def test_plain_group_ops_match_pallas_cores_bitwise(tag):
    """The Pallas kernels' cores as plain jnp: madd_core (complete), dbl_core
    and add_core give the plain versions' Jacobian coordinates bit for bit.
    Where both add operands are at infinity the two pick different
    representatives of infinity (z == 0 on both sides)."""
    p, q, qx, qy, q_inf = _inputs(tag, seed=43 if tag == "fq" else 44)
    F = pallas_ec.field_for(tag)
    pj = [_rows_j(tag, c) for c in p]
    qj = [_rows_j(tag, c) for c in q]

    want = pallas_ec.madd_core(F, *pj, _rows_j(tag, qx), _rows_j(tag, qy), jnp.asarray(q_inf.numpy()))
    got = cuda_curve.madd_plain(p, qx, qy, q_inf, tag)
    for g, w in zip(got, want):
        assert torch.equal(g, _rows_t(tag, w))

    want = pallas_ec.dbl_core(F, *pj)
    for g, w in zip(cuda_curve.dbl_plain(p, tag), want):
        assert torch.equal(g, _rows_t(tag, w))

    want = [_rows_t(tag, w) for w in pallas_ec.add_core(F, *pj, *qj)]
    got = cuda_curve.add_plain(p, q, tag)
    both = CASES["both_inf"]
    keep = torch.arange(N) != both
    for g, w in zip(got, want):
        assert torch.equal(g[keep], w[keep])
    assert not got.z[both].any() and not want[2][both].any()


def test_wrappers_dispatch_on_device_only():
    """CPU tensors take the plain version (no launch is counted); a tensor on
    another device is refused, never computed by the plain version."""
    p, q, qx, qy, q_inf = _inputs("fq", seed=45)
    before = {k: getattr(cuda_curve, k).launches for k in ("curve_madd", "curve_dbl", "curve_add")}
    assert all(torch.equal(a, b) for a, b in zip(cuda_curve.curve_madd(p, qx, qy, q_inf, "fq"),
                                                 cuda_curve.madd_plain(p, qx, qy, q_inf, "fq")))
    assert all(torch.equal(a, b) for a, b in zip(cuda_curve.curve_dbl(p, "fq"), cuda_curve.dbl_plain(p, "fq")))
    assert all(torch.equal(a, b) for a, b in zip(cuda_curve.curve_add(p, q, "fq"), cuda_curve.add_plain(p, q, "fq")))
    assert before == {k: getattr(cuda_curve, k).launches for k in before}
    meta = JacPoint(*(c.to("meta") for c in p))
    with pytest.raises(ValueError):
        cuda_curve.curve_dbl(meta, "fq")
    with pytest.raises(ValueError):
        cuda_curve.curve_add(meta, JacPoint(*(c.to("meta") for c in q)), "fq")
