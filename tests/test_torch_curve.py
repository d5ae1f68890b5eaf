"""Group law of the PyTorch port against the JAX package and ref_curve.

Both packages use the same Jacobian formulas in the same order, so the
Jacobian coordinates agree bit for bit, edge cases included (infinity on
either side, P == Q, P == -Q). Affine results are also held against the
JAX package's host curve (keyless_zk_tpu/curves/ref_curve.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keyless_zk_tpu.curves import jacobian as jjac
from keyless_zk_tpu.curves import ref_curve as jref
from keyless_zk_tpu_torch.curves import jacobian as tjac
from keyless_zk_tpu_torch.curves import ref_curve

torch.set_num_threads(1)

CASES = [
    (jjac.G1_CURVE, tjac.G1_CURVE, jref.G1, jref.G1_GEN),
    (jjac.G2_CURVE, tjac.G2_CURVE, jref.G2, jref.G2_GEN),
]
IDS = ["g1", "g2"]


def _points(group, gen, rng, n):
    return [group.mul(gen, int.from_bytes(rng.bytes(32), "little")) for _ in range(n)]


def _pair_batches(group, gen, rng):
    """(P, Q) lists covering: generic, P inf, Q inf, both inf, P == Q, P == -Q."""
    ps = _points(group, gen, rng, 6)
    qs = _points(group, gen, rng, 6)
    ps[1] = None
    qs[2] = None
    ps[3] = qs[3] = None
    qs[4] = ps[4]
    qs[5] = group.neg(ps[5])
    return ps, qs


def _to_jax(t):
    return jnp.asarray(t.numpy().astype(np.uint32))


def _eq(jp, tp):
    return all(np.array_equal(np.asarray(a).astype(np.int64), b.numpy().astype(np.int64)) for a, b in zip(jp, tp))


def _jac(curve, pts):
    """Host points -> a Jacobian batch with z != 1 (doubled, so that the
    add formulas see general z)."""
    x, y, inf = curve.encode_affine(pts)
    return curve.dbl(curve.from_affine(x, y, inf))


@pytest.mark.parametrize("jc,tc,group,gen", CASES, ids=IDS)
def test_dbl_add_add_mixed_bitwise(jc, tc, group, gen):
    rng = np.random.default_rng(11)
    ps, qs = _pair_batches(group, gen, rng)
    tp = _jac(tc, ps)
    jp = tuple(_to_jax(c) for c in tp)
    tq = _jac(tc, qs)
    jq = tuple(_to_jax(c) for c in tq)
    assert _eq(jc.dbl(jjac.JacPoint(*jp)), tc.dbl(tp))
    assert _eq(jc.add(jjac.JacPoint(*jp), jjac.JacPoint(*jq)), tc.add(tp, tq))
    # mixed: the affine operand with its infinity mask; P == Q and P == -Q
    # arise against the doubled P, so pair with 2Q in affine form
    qx, qy, qinf = tc.encode_affine([group.add(q, q) for q in qs])
    jm = jc.add_mixed(jjac.JacPoint(*jp), _to_jax(qx), _to_jax(qy), jnp.asarray(qinf.numpy()))
    tm = tc.add_mixed(tp, qx, qy, qinf)
    assert _eq(jm, tm)
    # and the values: decode against the host group law
    want = [group.add(group.add(p, p), group.add(q, q)) for p, q in zip(ps, qs)]
    assert tc.decode_jacobian(tc.add(tp, tq)) == want
    assert tc.decode_jacobian(tm) == want
    assert tc.decode_jacobian(tc.dbl(tp)) == [group.add(group.add(p, p), group.add(p, p)) for p in ps]


@pytest.mark.parametrize("jc,tc,group,gen", CASES, ids=IDS)
def test_to_affine_bitwise(jc, tc, group, gen):
    rng = np.random.default_rng(12)
    pts = _points(group, gen, rng, 4) + [None]
    tp = _jac(tc, pts)
    jx, jy, jinf = jc.to_affine(jjac.JacPoint(*(_to_jax(c) for c in tp)))
    tx, ty, tinf = tc.to_affine(tp)
    assert _eq((jx, jy), (tx, ty))
    assert np.array_equal(np.asarray(jinf), tinf.numpy())
    assert tc.decode_jacobian(tp) == [None if p is None else group.add(p, p) for p in pts]


@pytest.mark.parametrize("jc,tc,group,gen", CASES, ids=IDS)
def test_neg_and_scalar_mul_bits_bitwise(jc, tc, group, gen):
    """`neg` and `scalar_mul_bits` (MSB-first double-and-add, one 0/1 bit
    array for the batch) give the JAX package's Jacobian coordinates, and
    the host curve's -P and k * P; a point at infinity stays there."""
    rng = np.random.default_rng(14)
    pts = _points(group, gen, rng, 3) + [None]
    tp = _jac(tc, pts)
    jp = jjac.JacPoint(*(_to_jax(c) for c in tp))
    assert _eq(jc.neg(jp), tc.neg(tp))
    assert tc.decode_jacobian(tc.neg(tp)) == [None if p is None else group.neg(group.add(p, p)) for p in pts]
    k = int(rng.integers(1, 1 << 20)) | (1 << 20)  # 21 bits, the top one set
    bits = np.array([(k >> i) & 1 for i in range(20, -1, -1)], dtype=np.int32)
    got = tc.scalar_mul_bits(tp, torch.from_numpy(bits))
    assert _eq(jc.scalar_mul_bits(jp, jnp.asarray(bits)), got)
    assert tc.decode_jacobian(got) == [None if p is None else group.mul(group.add(p, p), k) for p in pts]
    assert tc.decode_jacobian(tc.scalar_mul_bits(tp, np.zeros(3, dtype=np.int32))) == [None] * len(pts)


def test_ref_curve_copy_matches_jax_package():
    """The jax-free host copy is the same curve (generators, twist, law)."""
    assert ref_curve.G1_GEN == jref.G1_GEN and ref_curve.G2_GEN == jref.G2_GEN
    assert ref_curve.B2 == jref.B2
    p = ref_curve.G2.mul(ref_curve.G2_GEN, 123456789)
    assert p == jref.G2.mul(jref.G2_GEN, 123456789)
