"""Multi-scalar multiplication (Pippenger) for BN254 G1 and G2 (PyTorch).

Port of keyless_zk_tpu/ops/msm.py: signed c-bit digits, one per-window
sort, a compacted (or dense) flat stream of (bucket, point) entries, the
fused bucket scan (K4), the boundary merge of runs that cross lanes (K5),
the weighted bucket reduction (K6) and the Horner sum over windows (K7).
The kernels live in ops/cuda_msm.py; on CPU tensors they run their plain
versions, so this one pipeline serves both devices.

Sizes chosen for the H100 (not carried over from the TPU tuning):

- `_SCAN_LANES` = 2^16 (G1) / 2^15 (G2): one K4 thread per lane; 2^16
  threads at 128 per block is ~4 resident blocks per SM on 132 SMs, which
  the scan's register use (a G1 mixed add in 8-word limbs) allows. Each lane
  walks at least `_MIN_SLABS` entries when the stream is shorter, so small
  MSMs use fewer lanes.
- `_CHUNK_ENTRIES` = 2^23 (G1) / 2^22 (G2): each chunk materializes a
  (3R, L, V) int32 emit buffer of 192 (G1) or 384 (G2) bytes per entry,
  1.6 GB either way, well inside the card's 80 GB with the tables resident.
- `fused_window_bits` keeps the JAX cost model's form (n adds per window
  plus ~2.6 * 2^(c-1) for the reduction and a fixed per-window overhead).

`msm` serves every n: n <= 128 takes the direct double-and-add, every
larger n the flat-stream Pippenger (the JAX fused path asserts for
128 < n < ~400, where its lane count exceeds the chunk).
"""

from __future__ import annotations

import torch

from ..curves.jacobian import G1_CURVE, JacobianCurve, JacPoint
from ..fields.limbs import LIMB_BITS, NUM_LIMBS
from . import cuda_curve, cuda_msm
from .cuda_msm import planes_to_point, rows_for, tree_reduce_points

SCALAR_BITS = 254

_SCAN_LANES = {"fq": 1 << 16, "fq2": 1 << 15}
_CHUNK_ENTRIES = {"fq": 1 << 23, "fq2": 1 << 22}
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
    """Nonzero signed digits across all windows (a host sync on the card)."""
    keys, _ = extract_digits_signed(scalars, c)
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
    (a key whose B tables hold a few distinct points takes this path)."""
    n = scalars.shape[0]
    tag = "fq" if curve is G1_CURVE else "fq2"
    bit_idx = torch.arange(SCALAR_BITS - 1, -1, -1, device=scalars.device)
    bits = (scalars.long()[:, bit_idx // LIMB_BITS] >> (bit_idx % LIMB_BITS)) & 1  # (n, 254)
    acc = curve.infinity((n,), scalars.device)
    # before the highest set bit of any scalar every lane stays at the
    # all-zero infinity (doubling it and skipping the add change nothing),
    # so those steps are skipped: witness scalars are mostly 0/1
    live = torch.nonzero(bits.any(dim=0))
    for i in range(int(live[0]) if live.numel() else SCALAR_BITS, SCALAR_BITS):
        acc = cuda_curve.curve_dbl(acc, tag)
        acc = curve.select(bits[:, i] == 1, cuda_curve.curve_madd(acc, points_x, points_y, points_inf, tag), acc)
    return tree_reduce_points(curve, acc, n)


def msm(
    points_x: torch.Tensor,
    points_y: torch.Tensor,
    points_inf: torch.Tensor,
    scalars: torch.Tensor,
    *,
    curve: JacobianCurve,
    c: int | None = None,
) -> JacPoint:
    """sum_i scalars[i] * P_i. Points affine (Montgomery limbs, int32),
    scalars standard-form (n, 16) int32 limbs. Returns one Jacobian point.

    The points must be distinct with random discrete logs (a deduplicated
    table): the scan takes no P == Q doubling (csrc/ec.cuh madd_core),
    like the JAX package's default `assume_distinct`. The digit stream is
    compacted to the next power of two at or above its nonzero count (a
    host sync): keyless witnesses are ~94% bit-valued, whose digits vanish
    in every window but the lowest."""
    n = scalars.shape[0]
    if n <= _SMALL_N:
        return _msm_small(points_x, points_y, points_inf, scalars, curve=curve)
    tag = "fq" if curve is G1_CURVE else "fq2"
    cw = c or fused_window_bits(n)
    total = -(-SCALAR_BITS // cw) * n
    cap = min(_p2(max(_count_nonzero_digits(scalars, cw), 1)), _p2(total))
    chunk = min(cap, _CHUNK_ENTRIES[tag])
    v = min(_SCAN_LANES[tag], max(1, chunk // _MIN_SLABS))
    return _msm_pippenger_fused(
        points_x, points_y, points_inf, scalars,
        tag=tag, c=cw, v=v, cap=cap, chunk=chunk,
    )


def _msm_pippenger_fused(
    points_x, points_y, points_inf, scalars, *, tag: str, c: int, v: int, cap: int, chunk: int,
) -> JacPoint:
    """Flat-stream Pippenger (port of msm._msm_pippenger_fused, unbatched).

    Every (window, element) pair maps to a flat bucket id w * NB + digit;
    zero digits and pads take a sentinel that sorts past the real entries,
    so one per-window sort groups the buckets and the compaction gathers the
    rows' real prefixes into the first `cap` stream slots. The stream runs
    through K4 in `chunk`-entry pieces of V lanes; chunk boundaries behave
    like lane boundaries and resolve in the one global boundary merge (K5).
    """
    dev = scalars.device
    R = rows_for(tag)
    n = scalars.shape[0]
    V = v
    if chunk % V or cap % chunk:
        raise ValueError(f"msm: chunk {chunk} / cap {cap} / lanes {V} do not tile")
    L = chunk // V
    n_chunks = cap // chunk

    keys, negs = extract_digits_signed(scalars, c)  # (Wn, n)
    rows = keys.shape[0]
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
        pos = torch.arange(cap, device=dev, dtype=torch.int64)
        rw = (torch.searchsorted(offs, pos + 1) - 1).clamp(0, rows - 1)
        valid = pos < offs[rows]
        src = torch.where(valid, rw * n + pos - offs[rw], 0)
        fb_s = torch.where(valid, rw * NB + kr_s.reshape(-1)[src], n_seg)
        pay_s = torch.where(valid, pr_s.reshape(-1)[src], n)
        row_base = offs[:-1]
    else:
        # dense: the row-sorted planes are the stream. A row's sentinel
        # tail lands in the next window's weight-0 bucket 0 (or past the
        # last window), so it is an arithmetic no-op wherever it ends up
        warr = torch.arange(rows, device=dev, dtype=torch.int64)[:, None]
        fb_s = (warr * NB + kr_s).reshape(-1)
        pay_s = pr_s.reshape(-1)
        if cap > rows * n:
            fb_s = torch.nn.functional.pad(fb_s, (0, cap - rows * n), value=n_seg)
            pay_s = torch.nn.functional.pad(pay_s, (0, cap - rows * n), value=n)
        row_base = torch.arange(rows, device=dev, dtype=torch.int64) * n

    # bucket geometry from the sorted digits alone: entry p is slab p % L of
    # global lane p // L. A bucket whose run starts and ends inside one lane
    # (not at its first or last slab) is interior: its total is the lane's
    # pre-add accumulator at the slab after the run's end.
    q1 = torch.arange(1, NB + 1, device=dev, dtype=torch.int64).expand(rows, NB).contiguous()
    cnt = torch.searchsorted(kr_s.contiguous(), q1)  # digits <= d per row
    cnt_prev = torch.nn.functional.pad(cnt[:, :-1], (1, 0))
    starts = (row_base[:, None] + cnt_prev).reshape(n_seg)
    ends = (row_base[:, None] + cnt - 1).reshape(n_seg)
    interior = (ends >= starts) & (starts // L == ends // L) & (starts % L != 0) & (ends % L != L - 1)
    # a bucket spanning S lanes covers <= 2S consecutive boundary slots
    lane_span = ends // L - starts // L + 1
    merge_steps = (2 * max(int(lane_span.max()), 1) - 1).bit_length()

    table = torch.cat(
        [points_x.reshape(n, R), points_y.reshape(n, R)], dim=1
    )
    table = torch.cat([table, torch.zeros((1, 2 * R), dtype=table.dtype, device=dev)]).int().contiguous()
    tinf = torch.cat([points_inf.bool(), torch.ones(1, dtype=torch.bool, device=dev)]).contiguous()

    tbl = torch.zeros((3 * R, n_seg), dtype=torch.int32, device=dev)
    heads, tails = [], []
    for ci in range(n_chunks):
        kw = fb_s[ci * chunk : (ci + 1) * chunk].int()
        pw = pay_s[ci * chunk : (ci + 1) * chunk].int()
        emit, hk, hpt, tk, tpt = cuda_msm.window_scan(
            tag,
            kw.reshape(V, L).T.contiguous(),
            pw.reshape(V, L).T.contiguous(),
            table,
            tinf,
        )
        mine = torch.nonzero(interior & (ends // chunk == ci)).squeeze(1)
        e_loc = ends[mine] - ci * chunk
        tbl[:, mine] = emit.reshape(3 * R, chunk)[:, (e_loc % L + 1) * V + e_loc // L]
        heads.append((hk, hpt))
        tails.append((tk, tpt))

    # one global boundary sequence: (head, tail) per global lane, in order
    m2 = 2 * V * n_chunks
    bkeys = torch.stack(
        [torch.stack([h for h, _ in heads]), torch.stack([t for t, _ in tails])], dim=2
    ).reshape(m2)
    bkeys = torch.cummax(bkeys, dim=0).values.int().contiguous()  # fill -1/-2 sentinels
    bpts = torch.stack(
        [torch.stack([p for _, p in heads]), torch.stack([p for _, p in tails])], dim=3
    )  # (nc, 3R, V, 2)
    bpts = bpts.permute(1, 0, 2, 3).reshape(3 * R, m2).contiguous()
    merged = cuda_msm.boundary_merge(tag, bkeys, bpts, merge_steps)

    # overlay the cross-lane bucket totals from the merged segment leaders
    bclip = bkeys.long().clamp(0, n_seg)
    lpos = torch.full((n_seg + 1,), m2, dtype=torch.int64, device=dev).scatter_reduce(
        0, bclip, torch.arange(m2, device=dev), reduce="amin"
    )[:n_seg]
    has = torch.nonzero((lpos < m2) & ~interior).squeeze(1)
    tbl[:, has] = merged[:, lpos[has]]

    wins = cuda_msm.weighted_bucket_total(tag, tbl.reshape(3 * R, rows, NB))
    return planes_to_point(cuda_msm.horner_total(tag, wins, c), tag)
