"""Coordinate-field operations so one Jacobian module serves G1 and G2.

Port of keyless_zk_tpu/curves/field_ops.py: two `CoordOps` objects whose
methods are batched torch functions on Montgomery limb tensors.

Shapes: Fq coordinate (..., 16); Fq2 coordinate (..., 2, 16).

Fq2 products stack their independent Fq products into one `mont_mul` call
(one kernel launch on the card instead of three); the values are the
canonical ones the JAX Karatsuba formulas give.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import torch_field as tf
from ..fields.limbs import int_to_limbs
from ..fields.torch_field import FQ


class FqOps:
    """Batched Fq operations on (..., 16) Montgomery limbs."""

    coord_ndim = 1

    def add(self, a, b):
        return tf.add(a, b, FQ)

    def sub(self, a, b):
        return tf.sub(a, b, FQ)

    def mul(self, a, b):
        return tf.mont_mul(a, b, FQ)

    def sqr(self, a):
        return tf.mont_mul(a, a, FQ)

    def neg(self, a):
        return tf.neg(a, FQ)

    def inv(self, a):
        return tf.mont_inv(a, FQ)

    def is_zero(self, a):
        return tf.is_zero(a)

    def select(self, mask, a, b):
        """mask has batch shape; broadcast over coordinate dims."""
        return torch.where(mask[..., None], a, b)

    def zeros(self, shape=(), device="cpu"):
        return torch.zeros((*shape, 16), dtype=torch.int32, device=device)

    def const(self, value: int, shape=(), device="cpu"):
        """Host int -> Montgomery-form constant batch."""
        return tf.consts(FQ, FQ.to_mont_int(value % FQ.p), shape, device)

    def encode(self, values, mont=True, device="cpu"):
        """List of coordinate ints -> (n, 16)."""
        return tf.encode_ints(values, FQ, mont=mont, device=device)

    def decode(self, arr, mont=True):
        return tf.decode_ints(arr, FQ, mont=mont)


def _stack_mul(lhs: list, rhs: list) -> list:
    """Independent Fq products in one mont_mul call."""
    shape = torch.broadcast_shapes(*(t.shape for t in lhs + rhs))
    a = torch.stack([t.expand(shape) for t in lhs])
    b = torch.stack([t.expand(shape) for t in rhs])
    return list(tf.mont_mul(a, b, FQ).unbind(0))


class Fq2Ops:
    """Batched Fq2 = Fq[u]/(u^2+1) operations on (..., 2, 16) Montgomery limbs."""

    coord_ndim = 2

    def add(self, a, b):
        return tf.add(a, b, FQ)

    def sub(self, a, b):
        return tf.sub(a, b, FQ)

    def mul(self, a, b):
        a0, a1 = a[..., 0, :], a[..., 1, :]
        b0, b1 = b[..., 0, :], b[..., 1, :]
        t0, t1, t2 = _stack_mul([a0, a1, tf.add(a0, a1, FQ)], [b0, b1, tf.add(b0, b1, FQ)])
        re = tf.sub(t0, t1, FQ)
        im = tf.sub(tf.sub(t2, t0, FQ), t1, FQ)
        return torch.stack([re, im], dim=-2)

    def sqr(self, a):
        a0, a1 = a[..., 0, :], a[..., 1, :]
        re, t = _stack_mul([tf.add(a0, a1, FQ), a0], [tf.sub(a0, a1, FQ), a1])
        return torch.stack([re, tf.add(t, t, FQ)], dim=-2)

    def neg(self, a):
        return tf.neg(a, FQ)

    def inv(self, a):
        a0, a1 = a[..., 0, :], a[..., 1, :]
        s0, s1 = _stack_mul([a0, a1], [a0, a1])
        di = tf.mont_inv(tf.add(s0, s1, FQ), FQ)
        r0, r1 = _stack_mul([a0, a1], [di, di])
        return torch.stack([r0, tf.neg(r1, FQ)], dim=-2)

    def is_zero(self, a):
        return (a == 0).all(dim=-1).all(dim=-1)

    def select(self, mask, a, b):
        return torch.where(mask[..., None, None], a, b)

    def zeros(self, shape=(), device="cpu"):
        return torch.zeros((*shape, 2, 16), dtype=torch.int32, device=device)

    def const(self, value, shape=(), device="cpu"):
        """Fq2 pair of host ints -> Montgomery constant batch."""
        c0, c1 = value if isinstance(value, tuple) else (value, 0)
        v = np.stack(
            [int_to_limbs(FQ.to_mont_int(c0 % FQ.p)), int_to_limbs(FQ.to_mont_int(c1 % FQ.p))]
        ).astype(np.int32)
        return torch.from_numpy(v).to(device).expand(*shape, 2, 16)

    def encode(self, values, mont=True, device="cpu"):
        """List of (c0, c1) pairs -> (n, 2, 16)."""
        c0 = tf.encode_ints([v[0] for v in values], FQ, mont=mont, device=device)
        c1 = tf.encode_ints([v[1] for v in values], FQ, mont=mont, device=device)
        return torch.stack([c0, c1], dim=-2)

    def decode(self, arr, mont=True):
        c0 = tf.decode_ints(arr[..., 0, :], FQ, mont=mont)
        c1 = tf.decode_ints(arr[..., 1, :], FQ, mont=mont)
        return list(zip(c0, c1))


FQ_OPS = FqOps()
FQ2_OPS = Fq2Ops()
