"""Multi-scalar multiplication (Pippenger) for BN254 G1 and G2 (PyTorch).

Port of keyless_zk_tpu/ops/msm.py: signed c-bit digits, one per-window
sort, a compacted (or dense) flat stream of (bucket, point) entries, the
fused bucket scan (K4), the boundary merge of runs that cross lanes (K5),
the weighted bucket reduction (K6) and the Horner sum over windows (K7).
The kernels live in ops/cuda_msm.py; on CPU tensors they run their plain
versions, so this one pipeline serves both devices.

Sizes chosen for the H100 (not carried over from the TPU tuning):

- `_SCAN_LANES`: one K4 thread per lane, and one wave of lanes for the
  whole stream: 132 SMs x the 128-thread blocks per SM that the scan's
  registers allow (ptxas's report in build.log). Held to 128 registers
  for four blocks per SM, the scan spilled and ran slower, in one wave or
  two (tools/kernel_variants.py `occupancy`, PERF.md).
  The lane count need not be a power of two: the stream is padded with
  sentinel entries to whole lanes. No buffer grows with the stream any
  more (K4 writes the interior bucket totals in place), so there is no
  chunking: one launch scans every window.
- `_MIN_SLABS` = 32: each lane walks at least 32 entries, so short streams
  (the witness MSMs) take fewer lanes; every lane adds two entries to the
  boundary sequence that K5 reduces (three launches at 2V = 2^16).
- `fused_window_bits` keeps the JAX cost model's form (n adds per window
  plus ~2.6 * 2^(c-1) for the reduction and a fixed per-window overhead).

`msm` serves every n: n <= 128 takes the direct double-and-add, every
larger n the flat-stream Pippenger (the JAX fused path asserts for
128 < n < ~400, where its lane count exceeds the chunk). `msm_batch` runs
B scalar vectors over one point table through the same pipeline, one
stream for the batch; `msm` is its B = 1 case.
"""

from __future__ import annotations

import torch

from ..curves.jacobian import G1_CURVE, JacobianCurve, JacPoint
from ..fields.limbs import LIMB_BITS, NUM_LIMBS
from . import cuda_curve, cuda_msm
from .cuda_msm import planes_to_point, rows_for, tree_reduce_points

SCALAR_BITS = 254

# one wave of K4: 132 SMs x 2 blocks of 128 threads, the blocks per SM that
# 65536 registers allow at the registers per thread ptxas reports for
# window_scan_kernel in build.log (232 for G1, 255 for G2)
_SCAN_LANES = 132 * 2 * 128
_MIN_SLABS = 32
_SMALL_N = 128  # at or below: the direct double-and-add (as the JAX package)


def extract_digits(scalars: torch.Tensor, c: int) -> torch.Tensor:
    """(n, 16) standard-form scalar limbs -> (n_windows, n) int32 c-bit digits."""
    n_windows = -(-SCALAR_BITS // c)
    s = scalars.long()
    mask = (1 << c) - 1
    outs = []
    for w in range(n_windows):
        lo = w * c
        li, off = lo // LIMB_BITS, lo % LIMB_BITS
        d = s[:, li] >> off
        if off + c > LIMB_BITS and li + 1 < NUM_LIMBS:
            d = d | (s[:, li + 1] << (LIMB_BITS - off))
        if off + c > 2 * LIMB_BITS and li + 2 < NUM_LIMBS:
            d = d | (s[:, li + 2] << (2 * LIMB_BITS - off))
        outs.append(d & mask)
    return torch.stack(outs).int()


def extract_digits_signed(scalars: torch.Tensor, c: int):
    """Balanced signed digits: (keys, negs), both (n_windows, n) int32, with
    scalar = sum_w (-1)^negs[w] * keys[w] * 2^(c*w), keys in [0, 2^(c-1)]."""
    d = extract_digits(scalars, c)
    half = 1 << (c - 1)
    full = 1 << c
    keys, negs = [], []
    carry = torch.zeros_like(d[0])
    for w in range(d.shape[0]):
        dw = d[w] + carry
        neg = dw > half
        carry = neg.int()
        keys.append(torch.where(neg, full - dw, dw))
        negs.append(neg.int())
    return torch.stack(keys).int(), torch.stack(negs).int()


def _count_nonzero_digits(scalars: torch.Tensor, c: int) -> int:
    """Nonzero signed digits across all windows of (..., n, 16) scalars (a
    host sync on the card); over a (B, n, 16) batch, the JAX package's
    `_count_nonzero_digits_batch`."""
    keys, _ = extract_digits_signed(scalars.reshape(-1, NUM_LIMBS), c)
    return int((keys >= 1).sum())


def fused_window_bits(n: int) -> int:
    """Window size: n mixed adds per window for the scan, ~2.6 * 2^(c-1)
    add-equivalents for the reduction, plus a fixed per-window overhead."""

    def cost(c: int) -> float:
        return -(-SCALAR_BITS // c) * (n + 2.6 * (1 << (c - 1)) + 3000.0)

    return min(range(8, 17), key=cost)


def _p2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def _msm_small(points_x, points_y, points_inf, scalars, *, curve: JacobianCurve) -> JacPoint:
    """Direct MSM for small n: batched double-and-add over all points at
    once (254 steps), then a log-depth tree sum. The points are affine, so
    each step takes the complete mixed add of K3 (ops/cuda_curve.py; the
    JAX version lifts them to Jacobian and takes the full add: same points,
    other coordinates). On the card a step is two K3 launches and no host
    sync, where the group law in torch takes many small launches and a sync
    (a key whose B tables hold a few distinct points takes this path).

    scalars (n, 16) give one point; a batch (B, n, 16) gives B points from
    one ladder over all B * n lanes (the JAX package runs one ladder per
    element), each element's lanes summed on their own."""
    batch = scalars.shape[:-2]
    n = scalars.shape[-2]
    flat = scalars.reshape(-1, NUM_LIMBS)
    lanes = flat.shape[0]
    reps = lanes // max(n, 1)
    tag = "fq" if curve is G1_CURVE else "fq2"
    if reps > 1:  # every element's lanes take the same table rows
        points_x, points_y, points_inf = (
            t.repeat(reps, *([1] * (t.dim() - 1))) for t in (points_x, points_y, points_inf))
    bit_idx = torch.arange(SCALAR_BITS - 1, -1, -1, device=scalars.device)
    bits = (flat.long()[:, bit_idx // LIMB_BITS] >> (bit_idx % LIMB_BITS)) & 1  # (lanes, 254)
    acc = curve.infinity((lanes,), scalars.device)
    # before the highest set bit of any scalar every lane stays at the
    # all-zero infinity (doubling it and skipping the add change nothing),
    # so those steps are skipped: witness scalars are mostly 0/1
    live = torch.nonzero(bits.any(dim=0))
    for i in range(int(live[0]) if live.numel() else SCALAR_BITS, SCALAR_BITS):
        acc = cuda_curve.curve_dbl(acc, tag)
        acc = curve.select(bits[:, i] == 1, cuda_curve.curve_madd(acc, points_x, points_y, points_inf, tag), acc)
    acc = JacPoint(*(co.reshape(*batch, n, *co.shape[1:]) for co in acc))
    return tree_reduce_points(curve, acc, n)


def msm(
    points_x: torch.Tensor,
    points_y: torch.Tensor,
    points_inf: torch.Tensor,
    scalars: torch.Tensor,
    *,
    curve: JacobianCurve,
    c: int | None = None,
    assume_distinct: bool = True,
) -> JacPoint:
    """sum_i scalars[i] * P_i. Points affine (Montgomery limbs, int32),
    scalars standard-form (n, 16) int32 limbs. Returns one Jacobian point:
    `msm_batch` of a batch of one.

    `assume_distinct` (the JAX package's default) skips the P == Q doubling
    in the bucket scan (csrc/ec.cuh madd_core): sound for a deduplicated
    table of points with random discrete logs. Pass False for tables that
    may contain duplicate points: the scan then takes its complete body
    (`cuda_msm.window_scan_complete`). The digit stream is compacted to
    the next power of two at or above its nonzero count (a host sync):
    keyless witnesses are ~94% bit-valued, whose digits vanish in every
    window but the lowest."""
    out = msm_batch(points_x, points_y, points_inf, scalars[None], curve=curve, c=c,
                    assume_distinct=assume_distinct)
    return JacPoint(*(co[0] for co in out))


def msm_batch(
    points_x: torch.Tensor,
    points_y: torch.Tensor,
    points_inf: torch.Tensor,
    scalars: torch.Tensor,
    *,
    curve: JacobianCurve,
    c: int | None = None,
    assume_distinct: bool = True,
) -> JacPoint:
    """B MSMs over ONE point table: scalars (B, n, 16) -> JacPoint with a
    leading batch axis B (port of keyless_zk_tpu/ops/msm.py `msm_batch`).

    n <= 128 takes `_msm_small`, one ladder for the batch (the JAX package
    runs `_msm_small` per element). Above it, one flat-stream Pippenger
    whose bucket ids carry the batch offset (see `_msm_pippenger_fused`):
    one sort, one compaction and one launch of each of K4-K7 for the whole
    batch. The stream is compacted to the next power of two at or above
    the batch's nonzero digit count. Equal points of different elements
    land in different buckets, so the scan's skipped P == Q doubling stays
    sound on a deduplicated table; `assume_distinct=False` takes the
    complete scan, as in `msm`. `_msm_small` is complete either way (K3's
    complete mixed add)."""
    B, n = scalars.shape[0], scalars.shape[1]
    if n <= _SMALL_N:
        return _msm_small(points_x, points_y, points_inf, scalars, curve=curve)
    tag = "fq" if curve is G1_CURVE else "fq2"
    cw = c or fused_window_bits(n)
    total = B * -(-SCALAR_BITS // cw) * n
    cap = min(_p2(max(_count_nonzero_digits(scalars, cw), 1)), _p2(total))
    v = min(_SCAN_LANES, max(1, -(-cap // _MIN_SLABS)))
    return _msm_pippenger_fused(points_x, points_y, points_inf, scalars, tag=tag, c=cw, v=v, cap=cap,
                                assume_distinct=assume_distinct)


def _msm_pippenger_fused(points_x, points_y, points_inf, scalars, *, tag: str, c: int, v: int, cap: int,
                         assume_distinct: bool = True) -> JacPoint:
    """Flat-stream Pippenger (port of msm._msm_pippenger_fused) over a batch
    of scalar vectors (B, n, 16) and one point table; returns B points (one
    point for (n, 16) scalars, the JAX function's `batch=None`).

    Every (batch element, window, point) maps to a flat bucket id
    (b * Wn + w) * NB + digit: the rows of the sort are (b, w) pairs, so the
    batch only lengthens the stream. Zero digits and pads take a sentinel
    that sorts past the real entries, so one per-row sort groups the
    buckets and the compaction gathers the rows' real prefixes into the
    first `cap` stream slots. The stream, padded to whole lanes, runs
    through K4 in one launch of `v` lanes (its complete body unless
    `assume_distinct`), which writes every bucket that
    lies inside a lane into the bucket table; the boundary merge (K5)
    writes the buckets that cross lanes into the same table; K6 reduces
    all B * Wn windows at once and K7 runs the B Horner chains in one
    launch. No host sync between K4 and K7.
    """
    dev = scalars.device
    R = rows_for(tag)
    single = scalars.dim() == 2
    if single:
        scalars = scalars[None]
    B, n = scalars.shape[0], scalars.shape[1]
    V = v
    L = -(-cap // V)
    m = L * V  # stream slots: cap padded to whole lanes

    keys, negs = extract_digits_signed(scalars.reshape(B * n, NUM_LIMBS), c)  # (Wn, B * n)
    Wn = keys.shape[0]
    rows = B * Wn  # row b * Wn + w: element b, window w
    keys = keys.reshape(Wn, B, n).transpose(0, 1).reshape(rows, n)
    negs = negs.reshape(Wn, B, n).transpose(0, 1).reshape(rows, n)
    NB = (1 << (c - 1)) + 1  # digits 0..2^(c-1); bucket 0 has weight 0
    n_seg = rows * NB

    # sort each window row by (digit, negate, index); zero digits take the
    # sentinel digit NB and sort to the row's tail
    real = keys >= 1
    kr = torch.where(real, keys, NB).long()
    iota = torch.arange(n, device=dev, dtype=torch.int64)
    pr = torch.where(real, iota | (negs.long() << 30), n)
    packed = torch.sort((kr << 31) | pr, dim=1).values
    kr_s = packed >> 31
    pr_s = packed & ((1 << 31) - 1)

    if cap < rows * n:
        # compaction: slot p belongs to row rw = (right bisect of p in offs)
        # - 1 at local offset p - offs[rw]; slots past the real count take
        # the sentinel bucket n_seg and the table's infinity row n
        nnz_rows = real.sum(dim=1)
        offs = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(nnz_rows, 0)])
        pos = torch.arange(m, device=dev, dtype=torch.int64)
        rw = (torch.searchsorted(offs, pos + 1) - 1).clamp(0, rows - 1)
        valid = pos < offs[rows]
        src = torch.where(valid, rw * n + pos - offs[rw], 0)
        fb_s = torch.where(valid, rw * NB + kr_s.reshape(-1)[src], n_seg)
        pay_s = torch.where(valid, pr_s.reshape(-1)[src], n)
    else:
        # dense: the row-sorted planes are the stream. A row's sentinel
        # tail lands in the next window's weight-0 bucket 0 (or past the
        # last window), so it is an arithmetic no-op wherever it ends up
        warr = torch.arange(rows, device=dev, dtype=torch.int64)[:, None]
        fb_s = torch.nn.functional.pad((warr * NB + kr_s).reshape(-1), (0, m - rows * n), value=n_seg)
        pay_s = torch.nn.functional.pad(pr_s.reshape(-1), (0, m - rows * n), value=n)

    table = torch.cat(
        [points_x.reshape(n, R), points_y.reshape(n, R)], dim=1
    )
    table = torch.cat([table, torch.zeros((1, 2 * R), dtype=table.dtype, device=dev)]).int().contiguous()
    tinf = torch.cat([points_inf.bool(), torch.ones(1, dtype=torch.bool, device=dev)]).contiguous()

    # entry p is slab p % L of lane p // L; K4 fills in the interior buckets
    tbl = torch.zeros((3 * R, n_seg), dtype=torch.int32, device=dev)
    hk, hpt, tk, tpt = cuda_msm.window_scan(
        tag,
        fb_s.int().reshape(V, L).T.contiguous(),
        pay_s.int().reshape(V, L).T.contiguous(),
        table,
        tinf,
        tbl,
        assume_distinct=assume_distinct,
    )

    # the boundary sequence, (head, tail) per lane in order: K5 writes the
    # totals of the buckets that cross lanes into the table
    bkeys = torch.stack([hk, tk], dim=1).reshape(2 * V)
    bkeys = torch.cummax(bkeys, dim=0).values.int().contiguous()  # fill -1/-2 sentinels
    bpts = torch.stack([hpt, tpt], dim=2).reshape(3 * R, 2 * V).contiguous()
    cuda_msm.boundary_merge(tag, bkeys, bpts, tbl)

    wins = cuda_msm.weighted_bucket_total(tag, tbl.reshape(3 * R, rows, NB))  # (3R, B * Wn)
    out = planes_to_point(cuda_msm.horner_total(tag, wins.reshape(3 * R, B, Wn), c), tag)
    return JacPoint(*(co[0] for co in out)) if single else out
