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
