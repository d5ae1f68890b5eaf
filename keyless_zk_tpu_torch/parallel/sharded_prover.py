"""Groth16 proving with the device phases sharded over a process group
(PyTorch port of keyless_zk_tpu/parallel/sharded_prover.py).

The single prover (groth16/prover.py) runs five MSMs and the coset-NTT
polynomial phase on one device. This one shards them over a mesh of
processes (parallel/sharded.py), one card each:

- the five MSMs partition their points and scalars across the group
  (`sharded_msm`: a local Pippenger per process, one all-gather of the
  Jacobian partials, K3's add to combine them);
- the polynomial transforms run as four-step NTTs (`four_step_ntt`: one
  all-to-all each), a, b and c in one batched call per direction;
- the coefficient evaluation and the pointwise field products stay local.

`prove` and `prove_batch` are the single prover's pipeline with these
`_msm` and `_h_scalars` (a batch's MSMs run one element at a time). Every
process holds the whole key, must pass the same witnesses, r and s
(sampled ones would differ between processes), and returns the same
proofs; for the same r and s they equal the single prover's.
"""

from __future__ import annotations

import torch

from .. import device as devices
from ..curves.jacobian import JacPoint
from ..fields import torch_field as tf
from ..fields.torch_field import FR
from ..groth16.prover import Groth16Prover
from .sharded import Mesh, four_step_ntt, sharded_msm


class ShardedGroth16Prover(Groth16Prover):
    """Groth16Prover whose MSMs and transforms shard across `mesh`.

    The point tables are padded so that the mesh size divides every MSM
    length: `_pad_tables` appends infinity rows, and `_msm` pads the
    scalars with zeros to match."""

    def __init__(self, pk, mesh: Mesh, device=devices.DEFAULT):
        super().__init__(pk, device)
        self.mesh = mesh
        self.n_dev = mesh.size
        if self.domain_pow < 2 * (self.n_dev - 1).bit_length():
            raise ValueError("domain too small to four-step over this mesh")
        self._pad_tables()
        self.coset = self.plan.coset_powers()

    def _pad_tables(self) -> None:
        d = self.n_dev

        def pad_to(table):
            x, y, inf = table
            pad = -inf.shape[0] % d
            if pad == 0:
                return table
            return (
                torch.cat([x, x.new_zeros((pad, *x.shape[1:]))]),
                torch.cat([y, y.new_zeros((pad, *y.shape[1:]))]),
                torch.cat([inf, inf.new_ones(pad)]),
            )

        self.points_a = pad_to(self.points_a)
        self.points_b1 = pad_to(self.points_b1)
        self.points_b2 = pad_to(self.points_b2)
        self.points_c = pad_to(self.points_c)
        self.points_h = pad_to(self.points_h)

    def _msm(self, table, scalars: torch.Tensor, curve, c: int | None = None) -> JacPoint:
        scalars = torch.nn.functional.pad(scalars, (0, 0, 0, table[0].shape[0] - scalars.shape[-2]))
        parts = [sharded_msm(*table, sc, curve=curve, mesh=self.mesh, c=c) for sc in scalars]
        return JacPoint(*(torch.stack(cs) for cs in zip(*parts)))

    def _h_scalars(self, witness: torch.Tensor) -> torch.Tensor:
        n = self.pk.domain_size
        ab = self._eval_ab(witness)
        a, b = ab[:n], ab[n:]
        c = tf.mont_mul(a, b, FR)
        abc = four_step_ntt(torch.stack([a, b, c]), domain_pow=self.domain_pow, mesh=self.mesh, inverse=True)
        abc = tf.mont_mul(abc, self.coset, FR)
        abc = four_step_ntt(abc, domain_pow=self.domain_pow, mesh=self.mesh)
        h = tf.sub(tf.mont_mul(abc[0], abc[1], FR), abc[2], FR)
        return tf.from_mont(h, FR)
