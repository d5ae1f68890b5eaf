"""Sharded proving kernels over a torch.distributed process group (PyTorch
port of keyless_zk_tpu/parallel/sharded.py, where they run over a
jax.sharding.Mesh under shard_map).

Every process holds the same full inputs and returns the same full result,
as the JAX functions take and return global arrays; each process computes
its own slice, and the collectives exchange what the slices need:

- `sharded_msm`: points and scalars are partitioned across the group; each
  process runs the local Pippenger (ops/msm.py) on its slice, then the
  Jacobian partials are all-gathered and summed by a halving tree of K3's
  complete add (ops/cuda_curve.py `curve_add`), padded with infinity to a
  power of two of at least two, so every group size runs the same combine.
  Communication is O(processes), independent of n. (The JAX package sums
  the partials with the XLA group law; the results are equal as affine
  points.)
- `four_step_ntt`: one 2^k NTT split as n = n1 * n2: local n2-point NTTs,
  the twiddle matrix (K1), ONE all-to-all, local n1-point NTTs. The local
  plans are the prover's: K10's butterfly passes (ops/cuda_ntt.py
  `get_cuda_plan`, its public `ntt` / `intt`, natural order; their plain
  versions on the CPU). The result is all-gathered, so every process
  returns the whole transform.
- `sharded_ntt_batch`: a batch of polynomials, one slice per process.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..curves.jacobian import G1_CURVE, JacobianCurve, JacPoint
from ..fields import bn254
from ..fields import torch_field as tf
from ..fields.torch_field import FR
from ..ops import cuda_curve
from ..ops.cuda_msm import planes_to_point, point_to_planes
from ..ops.cuda_ntt import get_cuda_plan
from ..ops.msm import msm
from ..ops.ntt import geometric_powers


@dataclass(frozen=True)
class Mesh:
    """A process group in place of the JAX package's jax.sharding.Mesh:
    `group` (None in one process without torch.distributed), its `size`
    and this process's `rank` in it."""

    group: object
    size: int
    rank: int


def make_mesh() -> Mesh:
    """The mesh over every process of the default group; one process and no
    group where torch.distributed is not initialized."""
    if not dist.is_initialized():
        return Mesh(None, 1, 0)
    return Mesh(dist.group.WORLD, dist.get_world_size(), dist.get_rank())


def _all_gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(mesh.size, *t.shape): every process's t, in rank order."""
    if mesh.group is None:
        return t[None]
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return torch.stack(parts)


def _tag(curve: JacobianCurve) -> str:
    return "fq" if curve is G1_CURVE else "fq2"


def _tree_add_points(curve: JacobianCurve, pts: JacPoint) -> JacPoint:
    """Sum of a (k, ...) batch of Jacobian points by a halving tree of K3's
    complete add, padded with infinity to a power of two (at least two)."""
    k = pts.x.shape[0]
    width = max(2, 1 << max(k - 1, 0).bit_length())
    inf = curve.infinity((width - k,), pts.x.device)
    pts = JacPoint(*(torch.cat([c, i]) for c, i in zip(pts, inf)))
    while width > 1:
        width //= 2
        pts = cuda_curve.curve_add(JacPoint(*(c[:width].contiguous() for c in pts)),
                                   JacPoint(*(c[width:].contiguous() for c in pts)), _tag(curve))
    return JacPoint(*(c[0] for c in pts))


def sharded_msm(
    points_x: torch.Tensor,
    points_y: torch.Tensor,
    points_inf: torch.Tensor,
    scalars: torch.Tensor,
    *,
    curve: JacobianCurve,
    mesh: Mesh,
    **msm_kwargs,
) -> JacPoint:
    """MSM with points partitioned across the mesh; every process gets the
    result. n must be divisible by the mesh size (pad with zero scalars
    and infinity rows upstream)."""
    n = scalars.shape[0]
    if n % mesh.size:
        raise ValueError(f"mesh size {mesh.size} must divide n = {n}")
    per = n // mesh.size
    lo, hi = mesh.rank * per, (mesh.rank + 1) * per
    part = msm(points_x[lo:hi], points_y[lo:hi], points_inf[lo:hi], scalars[lo:hi], curve=curve, **msm_kwargs)
    tag = _tag(curve)
    gathered = _all_gather(point_to_planes(part, tag), mesh)  # (D, 3R)
    return _tree_add_points(curve, planes_to_point(gathered.T.contiguous(), tag))


def _twiddle_matrix(w_mont: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    """W[j1, k2] = w^(j1*k2), (n1, n2, 16) Montgomery.

    Log-doubling over rows: W[m+a] = W[a] * G_m where G_m[k2] = w^(m*k2)
    starts as the k2 geometric row and squares elementwise each doubling
    (every product on K1)."""
    G = geometric_powers(w_mont, n2)  # (n2, 16): w^k2
    one = tf.encode_ints([FR.r_mod_p], FR, device=w_mont.device)[0]
    W = one.expand(1, n2, 16)
    cur = G
    while W.shape[0] < n1:
        W = torch.cat([W, tf.mont_mul(W, cur[None], FR)], dim=0)
        cur = tf.mont_mul(cur, cur, FR)
    return W


@functools.lru_cache(maxsize=32)
def _four_step_tables(domain_pow: int, n1_pow: int, inverse: bool, device: torch.device) -> torch.Tensor:
    w = bn254.fr_root_of_unity(domain_pow)
    if inverse:
        w = pow(w, -1, FR.p)
    w_mont = tf.encode_ints([w], FR, mont=True, device=device)[0]
    return _twiddle_matrix(w_mont, 1 << n1_pow, 1 << (domain_pow - n1_pow))


def four_step_ntt(
    x: torch.Tensor,
    *,
    domain_pow: int,
    mesh: Mesh,
    n1_pow: int | None = None,
    inverse: bool = False,
) -> torch.Tensor:
    """One 2^domain_pow NTT sharded across the mesh (four-step).

    With n = n1*n2, j = j1 + n1*j2 and k = k2 + n2*k1:

        X[n2*k1 + k2] = NTT_n1^(j1) [ w^(j1*k2) * NTT_n2^(j2)[x[j1 + n1*j2]] ]

    Step 1 runs this process's n1/D n2-point NTTs (its block of j1), step 2
    applies its rows of the twiddle matrix, step 3 is ONE all-to-all (each
    process keeps n/D elements), step 4 runs n2/D n1-point NTTs (its block
    of k2); the blocks are then all-gathered into the whole transform, in
    standard order. The inverse applies n^-1 through the inverse local
    plans (n1^-1 * n2^-1).

    x: (..., n, 16) Fr Montgomery, the same on every process; leading axes
    are independent transforms. Requires D | n1 and D | n2."""
    D = mesh.size
    if n1_pow is None:
        n1_pow = max(domain_pow // 2, (D - 1).bit_length())
    n2_pow = domain_pow - n1_pow
    n1, n2 = 1 << n1_pow, 1 << n2_pow
    if n1 % D or n2 % D:
        raise ValueError(f"mesh size {D} must divide both n1={n1} and n2={n2}")
    dev = x.device
    plan1, plan2 = get_cuda_plan(n1_pow, dev), get_cuda_plan(n2_pow, dev)
    W = _four_step_tables(domain_pow, n1_pow, inverse, dev)
    batch = x.shape[:-2]
    a1, a2 = n1 // D, n2 // D
    j_lo = mesh.rank * a1

    # steps 1-2: (..., n1/D, n2) = this process's j1 rows, j2 -> k2
    z = x.reshape(*batch, n2, n1, 16)[..., j_lo : j_lo + a1, :].movedim(-3, -2)
    z = plan2.intt(z) if inverse else plan2.ntt(z)
    z = tf.mont_mul(z, W[j_lo : j_lo + a1], FR)
    # step 3: chunk d (k2 block d) goes to process d; chunk d received is
    # process d's j1 rows of this process's k2 block
    z = z.reshape(*batch, a1, D, a2, 16).movedim(-3, 0).contiguous()  # (D, ..., n1/D, n2/D, 16)
    if mesh.group is not None:
        out = torch.empty_like(z)
        dist.all_to_all_single(out, z, group=mesh.group)
        z = out
    z = z.movedim(0, -4).reshape(*batch, n1, a2, 16).movedim(-3, -2)  # (..., n2/D, n1): k2 block, full j1
    # step 4: j1 -> k1
    z = plan1.intt(z) if inverse else plan1.ntt(z)  # (..., n2/D, n1) = [k2, k1]
    full = _all_gather(z.contiguous(), mesh).movedim(0, -4).reshape(*batch, n2, n1, 16)  # [k2, k1]
    return full.movedim(-3, -2).reshape(*batch, 1 << domain_pow, 16)


def sharded_ntt_batch(polys: torch.Tensor, *, domain_pow: int, mesh: Mesh, inverse: bool = False) -> torch.Tensor:
    """Batch-of-polynomials NTT, (B, n, 16), one batch slice per process
    (D | B); every process returns the whole batch."""
    B = polys.shape[0]
    if B % mesh.size:
        raise ValueError(f"mesh size {mesh.size} must divide the batch {B}")
    per = B // mesh.size
    plan = get_cuda_plan(domain_pow, polys.device)
    local = polys[mesh.rank * per : (mesh.rank + 1) * per]
    out = plan.intt(local) if inverse else plan.ntt(local)
    return _all_gather(out.contiguous(), mesh).reshape(polys.shape)
