"""K3: batched complete group-law ops on G1/G2 point batches, their plain
versions and their wrappers.

The kernels (csrc/curve_ops.cu) replace keyless_zk_tpu/ops/pallas_curve.py
`madd_pallas`, `dbl_pallas` and `add_pallas`; their callers are key
setup's fixed-base ladder (circuits/setup.py), the small-n MSM
(ops/msm.py `_msm_small`) and, for the full add, the combine of the
sharded MSM's partials (parallel/sharded.py `sharded_msm`). Each wrapper dispatches on its tensors' device
only: a CPU tensor takes the plain version, a CUDA tensor launches the
kernel or raises.

Layout at this boundary: a point batch is a JacPoint of contiguous int32
coordinate tensors, (n, 16) for G1 ("fq") and (n, 2, 16) for G2 ("fq2"),
in Montgomery form, each starting on a 16-byte boundary; infinity is
z == 0.

Plain versions, equal to the kernels in Jacobian coordinates:

- `madd_plain` transcribes keyless_zk_tpu/ops/pallas_ec.py `madd_core`
  without `assume_distinct`: P == Q doubles the affine operand
  (`dbl_affine_core`), and its selects run in its order (p at infinity
  gives (qx, qy, q_inf ? 0 : 1); q at infinity alone gives p);
- `dbl_plain` and `add_plain` are the port's curves/jacobian.py `dbl` and
  `add`, which share csrc/ec.cuh's formulas and selects (dbl-2009-l,
  add-2007-bl). Their infinity representatives can differ from the JAX
  kernels' (both inputs at infinity); as affine points all agree.

K4's complete body (csrc/msm_scan.cu) adds on G1 in homogeneous
projective coordinates; `madd_proj_plain` and `proj_to_jac_plain` are its
law and its conversion to the Jacobian form it writes (csrc/ec.cuh
`madd_proj`, `proj_to_jac`), equal to them coordinate for coordinate.
"""

from __future__ import annotations

import torch

from ..curves.jacobian import JacobianCurve, JacPoint
from . import _build
from .cuda_msm import _stream, curve_for


def _dbl_affine(curve: JacobianCurve, x, y) -> JacPoint:
    """pallas_ec.dbl_affine_core: 2 * (x, y) for an affine point (z == 1)."""
    f = curve.ops
    A = f.sqr(x)
    B = f.sqr(y)
    C = f.sqr(B)
    t = f.sub(f.sub(f.sqr(f.add(x, B)), A), C)
    D = f.add(t, t)
    E = f.add(f.add(A, A), A)
    x3 = f.sub(f.sqr(E), f.add(D, D))
    c8 = f.add(f.add(C, C), f.add(C, C))
    c8 = f.add(c8, c8)
    y3 = f.sub(f.mul(E, f.sub(D, x3)), c8)
    return JacPoint(x3, y3, f.add(y, y))


def madd_plain(p: JacPoint, qx, qy, q_inf, tag: str) -> JacPoint:
    """Complete mixed add p + (qx, qy, q_inf); q may be one point (batch 1)
    for the whole batch."""
    curve = curve_for(tag)
    f = curve.ops
    z1z1 = f.sqr(p.z)
    u2 = f.mul(qx, z1z1)
    s2 = f.mul(f.mul(qy, p.z), z1z1)
    h = f.sub(u2, p.x)
    rr = f.sub(s2, p.y)
    r2 = f.add(rr, rr)
    hh = f.sqr(h)
    i4 = f.add(f.add(hh, hh), f.add(hh, hh))
    j = f.mul(h, i4)
    v = f.mul(p.x, i4)
    x3 = f.sub(f.sub(f.sqr(r2), j), f.add(v, v))
    yj = f.mul(p.y, j)
    y3 = f.sub(f.mul(r2, f.sub(v, x3)), f.add(yj, yj))
    z3 = f.sub(f.sub(f.sqr(f.add(p.z, h)), z1z1), hh)
    out = JacPoint(x3, y3, z3)

    p_inf = f.is_zero(p.z)
    take_dbl = f.is_zero(h) & ~p_inf & ~q_inf & f.is_zero(rr)
    if bool(take_dbl.any()):  # only lanes that need it; changes no value
        out = curve.select(take_dbl, _dbl_affine(curve, qx, qy), out)
    one = f.const(1, q_inf.shape, qx.device)
    q_z = f.select(q_inf, torch.zeros_like(one), one)
    out = curve.select(p_inf, JacPoint(qx, qy, q_z), out)
    return curve.select(q_inf & ~p_inf, p, out)


def _mul_b3(f, a):
    """3b * a for G1 (y^2 = x^3 + 3): 9a = 8a + a."""
    a2 = f.add(a, a)
    a4 = f.add(a2, a2)
    return f.add(f.add(a4, a4), a)


def proj_start_plain(qx, qy, q_inf, tag: str) -> JacPoint:
    """A run's first accumulator: (qx : qy : 1), or (0 : 1 : 0) at infinity
    (a table's infinity row holds zero coordinates, and (0 : 0 : 0) is no
    projective point). A JacPoint holds the three coordinates."""
    f = curve_for(tag).ops
    zero = f.zeros(q_inf.shape, qx.device)
    one = f.const(1, q_inf.shape, qx.device)
    return JacPoint(f.select(q_inf, zero, qx), f.select(q_inf, one, qy), f.select(q_inf, zero, one))


def madd_proj_plain(p: JacPoint, qx, qy, q_inf, tag: str) -> JacPoint:
    """Complete mixed add of a homogeneous projective batch p ((X : Y : Z) is
    (X / Z, Y / Z); infinity (0 : Y : 0)) and affine points (qx, qy,
    q_inf): Renes, Costello and Batina (2016), Algorithm 8 for a = 0, its
    26 steps in order, no branch; complete for P == Q, P == -Q and p at
    infinity. q at infinity gives p. G1 only: the twist's 3b is an Fq2
    constant, and the complete scan keeps `madd_plain` on G2."""
    if tag != "fq":
        raise ValueError("madd_proj_plain: G1 only (the complete scan adds G2 by madd_plain)")
    f = curve_for(tag).ops
    t0 = f.mul(p.x, qx)  # 1
    t1 = f.mul(p.y, qy)  # 2
    t3 = f.add(qx, qy)  # 3
    t4 = f.add(p.x, p.y)  # 4
    t3 = f.mul(t3, t4)  # 5
    t4 = f.add(t0, t1)  # 6
    t3 = f.sub(t3, t4)  # 7
    t4 = f.mul(qy, p.z)  # 8
    t4 = f.add(t4, p.y)  # 9
    y3 = f.mul(qx, p.z)  # 10
    y3 = f.add(y3, p.x)  # 11
    x3 = f.add(t0, t0)  # 12
    t0 = f.add(x3, t0)  # 13
    t2 = _mul_b3(f, p.z)  # 14
    z3 = f.add(t1, t2)  # 15
    t1 = f.sub(t1, t2)  # 16
    y3 = _mul_b3(f, y3)  # 17
    x3 = f.mul(t4, y3)  # 18
    t2 = f.mul(t3, t1)  # 19
    x3 = f.sub(t2, x3)  # 20
    y3 = f.mul(y3, t0)  # 21
    t1 = f.mul(t1, z3)  # 22
    y3 = f.add(t1, y3)  # 23
    t0 = f.mul(t0, t3)  # 24
    z3 = f.mul(z3, t4)  # 25
    z3 = f.add(z3, t0)  # 26
    return curve_for(tag).select(q_inf, p, JacPoint(x3, y3, z3))


def proj_to_jac_plain(p: JacPoint, tag: str) -> JacPoint:
    """(X : Y : Z) -> Jacobian (X Z, Y Z^2, Z): the same point; infinity
    (Z = 0) -> z = 0."""
    f = curve_for(tag).ops
    return JacPoint(f.mul(p.x, p.z), f.mul(p.y, f.sqr(p.z)), p.z)


def dbl_plain(p: JacPoint, tag: str) -> JacPoint:
    return curve_for(tag).dbl(p)


def add_plain(p: JacPoint, q: JacPoint, tag: str) -> JacPoint:
    return curve_for(tag).add(p, q)


def _check(name: str, tag: str, points, *rest: torch.Tensor) -> int:
    """Device, layout and batch checks; returns the batch size n of the
    Jacobian batches `points` (all of one size)."""
    coord = (16,) if tag == "fq" else (2, 16)
    tensors = [c for p in points for c in p] + list(rest)
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.dtype == torch.bool:
            continue
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: coordinates must start on a 16-byte boundary (the kernels read 16-byte vectors)")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: coordinates must be int32, got {t.dtype}")
        if tuple(t.shape[1:]) != coord:
            raise ValueError(f"{name}: a {tag} coordinate is (n, {', '.join(map(str, coord))}), got {tuple(t.shape)}")
    n = points[0].x.shape[0]
    if any(c.shape[0] != n for p in points for c in p):
        raise ValueError(f"{name}: batch sizes differ")
    return n


def _empty_like(p: JacPoint) -> JacPoint:
    return JacPoint(*(torch.empty_like(c) for c in p))


@_build.counted
def curve_madd(p: JacPoint, qx, qy, q_inf, tag: str) -> JacPoint:
    """Complete mixed add of a Jacobian batch p (n) and affine points
    (qx, qy, q_inf) with batch n, or batch 1 for one point added to all."""
    if p.x.device.type == "cpu":
        return madd_plain(p, qx, qy, q_inf, tag)
    n = _check("curve_madd", tag, [p], qx, qy, q_inf)
    nq = qx.shape[0]
    if nq not in (1, n) or qy.shape[0] != nq or q_inf.shape != (nq,):
        raise ValueError("curve_madd: the affine batch must have n rows or one")
    out = _empty_like(p)
    curve_madd.launches += 1
    err = _build.library().kzk_curve_madd(
        *(c.data_ptr() for c in (*p, qx, qy, q_inf, *out)), n, nq, int(tag == "fq2"), _stream(p.x)
    )
    _build.check(err, "curve_madd")
    return out


@_build.counted
def curve_dbl(p: JacPoint, tag: str) -> JacPoint:
    """2p for a Jacobian batch p."""
    if p.x.device.type == "cpu":
        return dbl_plain(p, tag)
    n = _check("curve_dbl", tag, [p])
    out = _empty_like(p)
    curve_dbl.launches += 1
    err = _build.library().kzk_curve_dbl(*(c.data_ptr() for c in (*p, *out)), n, int(tag == "fq2"), _stream(p.x))
    _build.check(err, "curve_dbl")
    return out


@_build.counted
def curve_add(p: JacPoint, q: JacPoint, tag: str) -> JacPoint:
    """Complete p + q for Jacobian batches of one size."""
    if p.x.device.type == "cpu":
        return add_plain(p, q, tag)
    n = _check("curve_add", tag, [p, q])
    out = _empty_like(p)
    curve_add.launches += 1
    err = _build.library().kzk_curve_add(
        *(c.data_ptr() for c in (*p, *q, *out)), n, int(tag == "fq2"), _stream(p.x)
    )
    _build.check(err, "curve_add")
    return out
