"""Batched Jacobian-coordinate group law for BN254 G1/G2 (PyTorch).

Port of keyless_zk_tpu/curves/jacobian.py with the same formulas
(dbl-2009-l, add-2007-bl, madd-2007-bl) in the same order of operations, so
the Jacobian coordinates agree with the JAX package bit for bit. A point
batch is an (x, y, z) triple of Montgomery coordinate tensors; z == 0
encodes infinity. Edge cases (infinity, P == Q, P == -Q) are resolved by
masks; the doubling that P == Q needs is computed only when some lane
needs it, which changes no value.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .field_ops import FQ2_OPS, FQ_OPS


class JacPoint(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


class JacobianCurve:
    def __init__(self, ops):
        self.ops = ops

    def _batch(self, coord: torch.Tensor):
        return coord.shape[: coord.dim() - self.ops.coord_ndim]

    # ---- constructors ----
    def infinity(self, shape=(), device="cpu"):
        f = self.ops
        return JacPoint(f.zeros(shape, device), f.zeros(shape, device), f.zeros(shape, device))

    def from_affine(self, x, y, inf_mask=None):
        """Affine coordinate tensors (+ optional infinity mask) -> Jacobian."""
        f = self.ops
        batch = self._batch(x)
        one = f.const(1, batch, x.device)
        z = one
        if inf_mask is not None:
            z = f.select(inf_mask, f.zeros(batch, x.device), one)
        return JacPoint(x, y, z)

    def is_infinity(self, p: JacPoint):
        return self.ops.is_zero(p.z)

    def select(self, mask, p: JacPoint, q: JacPoint) -> JacPoint:
        f = self.ops
        return JacPoint(f.select(mask, p.x, q.x), f.select(mask, p.y, q.y), f.select(mask, p.z, q.z))

    def neg(self, p: JacPoint) -> JacPoint:
        return JacPoint(p.x, self.ops.neg(p.y), p.z)

    # ---- group law ----
    def dbl(self, p: JacPoint) -> JacPoint:
        f = self.ops
        A = f.sqr(p.x)
        B = f.sqr(p.y)
        C = f.sqr(B)
        t = f.sub(f.sub(f.sqr(f.add(p.x, B)), A), C)
        D = f.add(t, t)
        E = f.add(f.add(A, A), A)
        F = f.sqr(E)
        x3 = f.sub(F, f.add(D, D))
        c8 = f.add(f.add(C, C), f.add(C, C))
        c8 = f.add(c8, c8)
        y3 = f.sub(f.mul(E, f.sub(D, x3)), c8)
        z3 = f.mul(f.add(p.y, p.y), p.z)
        return JacPoint(x3, y3, z3)  # z == 0 stays 0

    def add(self, p: JacPoint, q: JacPoint) -> JacPoint:
        f = self.ops
        out, h, rr = self.add_formula(p, q)
        p_inf = self.is_infinity(p)
        q_inf = self.is_infinity(q)
        both = ~p_inf & ~q_inf
        take_dbl = f.is_zero(h) & both & f.is_zero(rr)
        if bool(take_dbl.any()):  # P == Q -> double; P == -Q -> z3 = 0 already
            out = self.select(take_dbl, self.dbl(p), out)
        out = self.select(p_inf, q, out)
        out = self.select(q_inf, p, out)
        return out

    def add_formula(self, p: JacPoint, q: JacPoint):
        """add-2007-bl without its edge cases: (p + q, h, rr), with h and rr
        left for the caller's P == +-Q test."""
        f = self.ops
        z1z1 = f.sqr(p.z)
        z2z2 = f.sqr(q.z)
        u1 = f.mul(p.x, z2z2)
        u2 = f.mul(q.x, z1z1)
        s1 = f.mul(f.mul(p.y, q.z), z2z2)
        s2 = f.mul(f.mul(q.y, p.z), z1z1)
        h = f.sub(u2, u1)
        rr = f.sub(s2, s1)
        r2 = f.add(rr, rr)
        i = f.sqr(f.add(h, h))
        j = f.mul(h, i)
        v = f.mul(u1, i)
        x3 = f.sub(f.sub(f.sqr(r2), j), f.add(v, v))
        s1j = f.mul(s1, j)
        y3 = f.sub(f.mul(r2, f.sub(v, x3)), f.add(s1j, s1j))
        zz = f.sub(f.sub(f.sqr(f.add(p.z, q.z)), z1z1), z2z2)
        z3 = f.mul(zz, h)
        return JacPoint(x3, y3, z3), h, rr

    def add_mixed(self, p: JacPoint, qx, qy, q_inf) -> JacPoint:
        """p (Jacobian) + q (affine with explicit infinity mask)."""
        f = self.ops
        z1z1 = f.sqr(p.z)
        u2 = f.mul(qx, z1z1)
        s2 = f.mul(f.mul(qy, p.z), z1z1)
        h = f.sub(u2, p.x)
        rr = f.sub(s2, p.y)
        r2 = f.add(rr, rr)
        hh = f.sqr(h)
        i = f.add(f.add(hh, hh), f.add(hh, hh))
        j = f.mul(h, i)
        v = f.mul(p.x, i)
        x3 = f.sub(f.sub(f.sqr(r2), j), f.add(v, v))
        yj = f.mul(p.y, j)
        y3 = f.sub(f.mul(r2, f.sub(v, x3)), f.add(yj, yj))
        z3 = f.sub(f.sub(f.sqr(f.add(p.z, h)), z1z1), hh)
        out = JacPoint(x3, y3, z3)

        p_inf = self.is_infinity(p)
        take_dbl = f.is_zero(h) & ~p_inf & ~q_inf & f.is_zero(rr)
        if bool(take_dbl.any()):
            out = self.select(take_dbl, self.dbl(p), out)
        batch = self._batch(qx)
        q_z = f.select(q_inf, f.zeros(batch, qx.device), f.const(1, batch, qx.device))
        out = self.select(p_inf, JacPoint(qx, qy, q_z), out)
        out = self.select(q_inf, p, out)
        return out

    def scalar_mul_bits(self, p: JacPoint, bits) -> JacPoint:
        """MSB-first double-and-add with a (nbits,) 0/1 array (shared
        exponent). The bits are read on the host and the add runs at the
        set bits only; the JAX version adds at every bit and selects, which
        gives the same coordinates."""
        acc = self.infinity(self._batch(p.x), p.x.device)
        for bit in torch.as_tensor(bits).reshape(-1).tolist():
            acc = self.dbl(acc)
            if bit == 1:
                acc = self.add(acc, p)
        return acc

    # ---- affine conversion (device) ----
    def to_affine(self, p: JacPoint):
        """Returns (x, y, inf_mask); uses one batched Fermat inversion."""
        f = self.ops
        inf = self.is_infinity(p)
        batch = self._batch(p.x)
        z = f.select(inf, f.const(1, batch, p.z.device), p.z)
        zi = f.inv(z)
        zi2 = f.sqr(zi)
        x = f.mul(p.x, zi2)
        y = f.mul(p.y, f.mul(zi2, zi))
        return x, y, inf

    # ---- host codecs ----
    def encode_affine(self, pts, device="cpu"):
        """List of host affine points (None = infinity) -> (x, y, inf) tensors."""
        zero = 0 if self.ops.coord_ndim == 1 else (0, 0)
        xs = [zero if p is None else p[0] for p in pts]
        ys = [zero if p is None else p[1] for p in pts]
        inf = torch.tensor([p is None for p in pts], dtype=torch.bool, device=device)
        return self.ops.encode(xs, device=device), self.ops.encode(ys, device=device), inf

    def decode_jacobian(self, p: JacPoint):
        """Jacobian batch -> list of host affine points (None = inf): one
        batched to_affine on the tensors' device, then one readback."""
        x, y, inf = self.to_affine(p)
        host = torch.cat([x.reshape(-1), y.reshape(-1), inf.reshape(-1).int()]).cpu()
        nx = x.numel()
        x = host[:nx].reshape(x.shape)
        y = host[nx : 2 * nx].reshape(y.shape)
        inf = host[2 * nx :].bool().tolist()
        xs = self.ops.decode(x)
        ys = self.ops.decode(y)
        return [None if i else (xx, yy) for xx, yy, i in zip(xs, ys, inf)]


G1_CURVE = JacobianCurve(FQ_OPS)
G2_CURVE = JacobianCurve(FQ2_OPS)
