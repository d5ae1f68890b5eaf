"""K4-K7: the MSM kernels' wrappers and their plain versions.

Each wrapper replaces one Pallas entry point of keyless_zk_tpu/ops/
pallas_msm.py and dispatches on its tensors' device only: a CPU tensor takes
the plain version (a torch port of its keyless_zk_tpu/ops/msm_sim.py
namesake, the executable contract), a CUDA tensor launches the CUDA kernel
or raises.

Layouts at this boundary: a point batch is a (3R, ...) int32 plane of
16-bit limb rows -- x rows, then y rows, then z rows, R = 16 for G1 ("fq")
and 32 for G2 ("fq2", c0 limbs then c1 limbs) -- with the batch axes after
the rows, so that neighbouring lanes are neighbouring addresses. Keys and
payloads are int32.

K4 `window_scan` and `window_scan_complete`, its two bodies
(csrc/msm_scan.cu), K5 `boundary_merge` (csrc/msm_merge.cu),
K6 `weighted_bucket_total` and K7 `horner_total` (csrc/msm_reduce.cu). K4
and K5 write the bucket table they are given in place.
"""

from __future__ import annotations

import functools

import torch

from ..curves.jacobian import G1_CURVE, G2_CURVE, JacPoint
from ..fields.limbs import NUM_LIMBS
from . import _build, warp_program


def rows_for(tag: str) -> int:
    return NUM_LIMBS if tag == "fq" else 2 * NUM_LIMBS


def curve_for(tag: str):
    return G1_CURVE if tag == "fq" else G2_CURVE


def rows_to_coord(a: torch.Tensor, tag: str) -> torch.Tensor:
    """(..., R) limb rows -> coordinate layout ((..., 16) or (..., 2, 16))."""
    return a if tag == "fq" else a.reshape(*a.shape[:-1], 2, NUM_LIMBS)


def coord_to_rows(a: torch.Tensor, tag: str) -> torch.Tensor:
    return a if tag == "fq" else a.reshape(*a.shape[:-2], 2 * NUM_LIMBS)


def planes_to_point(planes: torch.Tensor, tag: str) -> JacPoint:
    """(3R, ...) planes -> JacPoint with batch (...)."""
    R = rows_for(tag)
    return JacPoint(*(rows_to_coord(torch.movedim(planes[i * R : (i + 1) * R], 0, -1), tag) for i in range(3)))


def point_to_planes(p: JacPoint, tag: str) -> torch.Tensor:
    """JacPoint with batch (...) -> (3R, ...) contiguous planes."""
    return torch.cat([torch.movedim(coord_to_rows(c, tag), -1, 0) for c in p]).contiguous()


# ---- plain group sums (ports of msm.py helpers the contracts use) -----------

def _roll_batch(curve, p: JacPoint, sh: int) -> JacPoint:
    """Roll the last batch axis left by sh."""
    dim = -(curve.ops.coord_ndim + 1)
    return JacPoint(*(torch.roll(c, -sh, dims=dim) for c in p))


def suffix_sum_points(curve, pts: JacPoint) -> JacPoint:
    """Inclusive suffix sums along the last batch axis:
    out[..., i] = sum_{j >= i} pts[..., j] (Hillis-Steele, msm.py order)."""
    m = pts.x.shape[-(curve.ops.coord_ndim + 1)]
    idx = torch.arange(m, device=pts.x.device)
    for s in range(max(m - 1, 1).bit_length()):
        sh = 1 << s
        valid = (idx < m - sh).expand(pts.z.shape[: pts.z.dim() - curve.ops.coord_ndim])
        pts = curve.select(valid, curve.add(pts, _roll_batch(curve, pts, sh)), pts)
    return pts


def _take_batch(curve, p: JacPoint, i) -> JacPoint:
    dim = -(curve.ops.coord_ndim + 1)
    return JacPoint(*(c.select(dim, i) if isinstance(i, int) else c.narrow(dim, i.start, i.stop - i.start) for c in p))


def tree_reduce_points(curve, acc: JacPoint, m: int) -> JacPoint:
    """Sum over the first m entries of the last batch axis."""
    if m == 1:
        return _take_batch(curve, acc, 0)
    return _take_batch(curve, suffix_sum_points(curve, _take_batch(curve, acc, slice(0, m))), 0)


def _horner_windows(curve, wins: JacPoint, n_windows: int, c: int) -> JacPoint:
    """acc = 2^c * acc + W_w from the highest window down (msm._horner_windows)."""
    acc = _take_batch(curve, wins, n_windows - 1)
    for w in range(n_windows - 2, -1, -1):
        for _ in range(c):
            acc = curve.dbl(acc)
        acc = curve.add(acc, _take_batch(curve, wins, w))
    return acc


# ---- checks shared by the kernel paths ----------------------------------------

def _require_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _require_dtype(name: str, dtype, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---- K4: window scan ----------------------------------------------------------

def _scan_law(tag: str, assume_distinct: bool):
    """(start, step, to_jac) of the body that `window_scan_plain` stands for:
    a run's first accumulator, the mixed add that grows it, and its
    conversion to the Jacobian form the scan writes."""
    from . import cuda_curve  # it imports this module

    curve = curve_for(tag)
    if assume_distinct:
        return curve.from_affine, curve.add_mixed, lambda p: p
    if tag == "fq":
        return (functools.partial(cuda_curve.proj_start_plain, tag=tag),
                lambda p, x, y, inf: cuda_curve.madd_proj_plain(p, x, y, inf, tag),
                lambda p: cuda_curve.proj_to_jac_plain(p, tag))
    return curve.from_affine, lambda p, x, y, inf: cuda_curve.madd_plain(p, x, y, inf, tag), lambda p: p


def window_scan_plain(tag, keys, pay, table, tinf, tbl, assume_distinct=True):
    """The kernel's contract in torch: per step, the lanes whose run of a
    non-head bucket id < n_seg just ended write its total into that column
    of `tbl`. See `window_scan`.

    Every law is complete; `assume_distinct` picks the one whose
    coordinates are those of the body of that name, so that each body
    equals its plain version limb for limb:

    - True: curves/jacobian.py `add_mixed` (msm_sim.window_scan's), which
      doubles the Jacobian accumulator where P == Q and keeps it where the
      point is at infinity. The distinct body equals it wherever its
      precondition holds (no run's partial sum equals the run's next point).
    - False: the complete body's law. On G1, ops/cuda_curve.py
      `madd_proj_plain` (Renes-Costello-Batina Algorithm 8, branch-free)
      on a homogeneous projective accumulator that starts a run at
      (x2 : y2 : 1), or (0 : 1 : 0) at infinity, each run's total
      converted to Jacobian coordinates (X Z, Y Z^2, Z) where it leaves the
      lane (`proj_to_jac_plain`). On G2, `madd_plain` (pallas_ec.madd_core
      without `assume_distinct`: P == Q doubles the affine point) on the
      Jacobian accumulator.
    A run's first entry starts the accumulator and each later one is added
    onto the run's sum, so a lane meets P == Q only inside a run. The laws
    give the same points, not always the same coordinates."""
    curve = curve_for(tag)
    f = curve.ops
    R = rows_for(tag)
    L, V = keys.shape
    n_seg = tbl.shape[1]
    idx = (pay & ((1 << 30) - 1)).long()
    negs = ((pay >> 30) & 1) == 1
    rows = table[idx]  # (L, V, 2R)
    gx = rows_to_coord(rows[..., :R], tag)
    gy = rows_to_coord(rows[..., R:], tag)
    ginf = tinf[idx]
    dev = keys.device
    start, step, to_jac = _scan_law(tag, assume_distinct)
    zero = f.zeros((V,), dev)
    inf0 = start(zero, zero, torch.ones(V, dtype=torch.bool, device=dev))  # the law's infinity
    acc, head_pt = inf0, curve.infinity((V,), dev)
    cur_key = torch.zeros(V, dtype=torch.int32, device=dev)
    head_key = torch.full((V,), -2, dtype=torch.int32, device=dev)
    is_head = torch.ones(V, dtype=torch.bool, device=dev)
    for t in range(L):
        k, q_inf = keys[t], ginf[t]
        x2 = gx[t]
        y2 = f.select(negs[t], f.neg(gy[t]), gy[t])
        if t == 0:
            same = torch.zeros(V, dtype=torch.bool, device=dev)
        else:
            same = k == cur_key
            ended = ~same
            done = to_jac(acc)
            to_head = ended & is_head
            head_key = torch.where(to_head, cur_key, head_key)
            head_pt = curve.select(to_head, done, head_pt)
            inner = torch.nonzero(ended & ~is_head & (cur_key >= 0) & (cur_key < n_seg)).squeeze(1)
            tbl[:, cur_key[inner].long()] = point_to_planes(JacPoint(*(c[inner] for c in done)), tag)
            is_head = is_head & same
        # lanes that start a run add onto the law's infinity (their sum is
        # not used), so that only lanes inside a run meet P == Q
        grown = step(curve.select(same, acc, inf0), x2, y2, q_inf)
        acc = curve.select(same, grown, start(x2, y2, q_inf))
        cur_key = k
    last = to_jac(acc)
    tail_key = torch.where(is_head, -1, cur_key)
    tail_pt = curve.select(~is_head, last, curve.infinity((V,), dev))
    head_key = torch.where(is_head, cur_key, head_key)
    head_pt = curve.select(is_head, last, head_pt)
    return head_key, point_to_planes(head_pt, tag), tail_key.int(), point_to_planes(tail_pt, tag)


def _scan_launch(wrapper, complete: bool, tag, keys, pay, table, tinf, tbl):
    """Launch K4's body (`complete`: the one with the P == Q doubling) on
    CUDA tensors, counting the launch on `wrapper`."""
    name = "window_scan_complete" if complete else "window_scan"
    _require_cuda(name, keys, pay, table, tinf, tbl)
    _require_dtype(name, torch.int32, keys, pay, table, tbl)
    _require_dtype(name, torch.bool, tinf)
    R = rows_for(tag)
    L, V = keys.shape
    if (pay.shape != keys.shape or table.dim() != 2 or table.shape[1] != 2 * R
            or tinf.shape != (table.shape[0],) or tbl.dim() != 2 or tbl.shape[0] != 3 * R):
        raise ValueError(f"{name}: shape mismatch")
    if table.data_ptr() % 16:
        raise ValueError(f"{name}: the point table must be 16-byte aligned (the kernel reads rows as int4)")
    dev = keys.device
    hk = torch.empty(V, dtype=torch.int32, device=dev)
    tk = torch.empty(V, dtype=torch.int32, device=dev)
    hpt = torch.empty((3 * R, V), dtype=torch.int32, device=dev)
    tpt = torch.empty((3 * R, V), dtype=torch.int32, device=dev)
    lib = _build.library()
    wrapper.launches += 1
    err = lib.kzk_window_scan(
        keys.data_ptr(), pay.data_ptr(), table.data_ptr(), tinf.data_ptr(), tbl.data_ptr(), tbl.shape[1],
        hk.data_ptr(), hpt.data_ptr(), tk.data_ptr(), tpt.data_ptr(),
        L, V, int(tag == "fq2"), int(complete), _stream(keys),
    )
    _build.check(err, name)
    return hk, hpt, tk, tpt


@_build.counted
def window_scan(tag, keys, pay, table, tinf, tbl, assume_distinct=True):
    """Scan the sorted stream with V lanes; write the interior bucket totals
    into `tbl` in place.

    keys, pay: (L, V) int32, slab-major (entry t*V + l is slab t of lane l);
    keys are flat bucket ids, sorted along each lane and across lanes;
    pay = point-table row | negate << 30. table: (n+1, 2R) int32 affine
    x||y limb rows (Montgomery); tinf: (n+1,) bool. tbl: (3R, n_seg) int32
    bucket table, updated in place: a run that ends inside its lane and is
    not the lane's first run holds a whole bucket, and its total is written
    to column `key` (ids >= n_seg are skipped). Other columns are left as
    they were.

    Returns (head_key (V,); head (3R, V); tail_key (V,); tail (3R, V)). A
    lane's head is its first run (key -2 if it never ended inside the lane,
    then overwritten by the whole-lane run); its tail is its last run, or
    key -1 and infinity if one run spans the lane.

    With `assume_distinct` (the default) the kernel's body takes no P == Q
    doubling (csrc/ec.cuh madd_core). Its precondition: no run's partial
    sum equals the next point of its run, which holds for deduplicated
    tables of points with random discrete logs; where it fails the bucket
    is wrong and nothing is raised. `assume_distinct=False` takes the
    complete body, `window_scan_complete`, which has no precondition.
    """
    if not assume_distinct:
        return window_scan_complete(tag, keys, pay, table, tinf, tbl)
    if keys.device.type == "cpu":
        return window_scan_plain(tag, keys, pay, table, tinf, tbl)
    return _scan_launch(window_scan, False, tag, keys, pay, table, tinf, tbl)


@_build.counted
def window_scan_complete(tag, keys, pay, table, tinf, tbl):
    """`window_scan` with the complete body, for tables that may hold one
    point in several rows (no precondition). On G1 it adds by a complete
    law with no branch on a homogeneous projective accumulator (csrc/ec.cuh
    `madd_proj`) and writes each run's total in Jacobian coordinates; on G2
    by ec.cuh `madd_complete` (a partial sum equal to the incoming point
    takes the affine doubling). Its plain version is `window_scan_plain(...,
    assume_distinct=False)`, equal to it limb for limb. Its launches are
    counted apart from the distinct body's."""
    if keys.device.type == "cpu":
        return window_scan_plain(tag, keys, pay, table, tinf, tbl, assume_distinct=False)
    return _scan_launch(window_scan_complete, True, tag, keys, pay, table, tinf, tbl)


# ---- K5: boundary merge -------------------------------------------------------

# entries per tile (threads per block) of K5's segmented tree; each holds
# one point in shared memory (tools/kernel_variants.py times 128 / 256 / 512
# at G1, PERF.md)
_MERGE_TILE = {"fq": 256, "fq2": 128}
_PAD_KEY = (1 << 31) - 1  # past the sequence: sorts last, never a bucket


def merge_levels(m: int, tile: int) -> list[int]:
    """The sequence length at each of K5's launches: m, then two partials
    per tile of the level before, down to one tile."""
    assert tile >= 4 and tile & (tile - 1) == 0
    levels = [m]
    while m > tile:
        m = 2 * -(-m // tile)
        levels.append(m)
    return levels


def _take(curve, p: JacPoint, idx) -> JacPoint:
    dim = -(curve.ops.coord_ndim + 1)
    return JacPoint(*(c.index_select(dim, idx) for c in p))


def _put(curve, p: JacPoint, idx, v: JacPoint) -> JacPoint:
    dim = -(curve.ops.coord_ndim + 1)
    return JacPoint(*(c.index_copy(dim, idx, x) for c, x in zip(p, v)))


def _merge_level_plain(curve, tag, keys, planes, tbl, tile: int):
    """One launch of K5 in torch, every tile at once: the segmented halving
    tree, the complete segments' totals written into `tbl`, and (key,
    partial) pairs of each tile's first and last segments returned, or None
    at the last level, which writes those too."""
    n_seg = tbl.shape[1]
    n = keys.shape[0]
    T = -(-n // tile)
    k = torch.nn.functional.pad(keys, (0, T * tile - n), value=_PAD_KEY).reshape(T, tile).long()
    P = planes_to_point(torch.nn.functional.pad(planes, (0, T * tile - n)).reshape(planes.shape[0], T, tile), tag)
    dev = keys.device
    writes = []

    def writable(kk):
        return (kk >= 0) & (kk < n_seg)

    s = 1
    while s < tile:
        lo = torch.arange(0, tile, 2 * s, device=dev)
        mid, hi = lo + s, lo + 2 * s - 1
        kl, kr = k[:, mid - 1], k[:, mid]
        l_one, r_one = k[:, lo] == kl, kr == k[:, hi]
        p_lo, p_lm, p_mid, p_hi = (_take(curve, P, x) for x in (lo, mid - 1, mid, hi))
        l_last = curve.select(l_one, p_lo, p_lm)
        same = kl == kr
        m = curve.select(same & writable(kl), curve.add(l_last, p_mid), l_last)
        writes += [(same & ~l_one & ~r_one & writable(kl), kl, m),
                   (~same & ~l_one & writable(kl), kl, p_lm),
                   (~same & ~r_one & writable(kr), kr, p_mid)]
        new_lo = curve.select(same & l_one, m, p_lo)
        new_hi = curve.select(same & ~l_one & r_one, m, curve.select(~same & r_one, p_mid, p_hi))
        P = _put(curve, _put(curve, P, lo, new_lo), hi, new_hi)
        s *= 2
    zero = torch.zeros(1, dtype=torch.long, device=dev)
    kf, kl = k[:, 0], k[:, tile - 1]
    first = _take(curve, P, zero)
    last = _take(curve, P, zero + tile - 1)
    if T == 1:
        writes += [(writable(kf)[:, None], kf[:, None], first),
                   (((kl != kf) & writable(kl))[:, None], kl[:, None], last)]
    for mask, kk, pt in writes:
        tbl[:, kk[mask]] = point_to_planes(JacPoint(*(c[mask] for c in pt)), tag)
    if T == 1:
        return None
    last = curve.select((kl == kf)[:, None], curve.infinity((T, 1), dev), last)
    keys_out = torch.stack([kf, kl], dim=1).reshape(2 * T).int()
    pts_out = torch.stack([point_to_planes(first, tag), point_to_planes(last, tag)], dim=-1)
    return keys_out, pts_out.reshape(planes.shape[0], 2 * T)


def boundary_merge_plain(tag, keys, pts, tbl):
    """K5's schedule in torch, bit-equal to the kernel (see
    `boundary_merge`); the contract, msm_sim.boundary_merge, adds in
    another order and agrees as affine points."""
    curve = curve_for(tag)
    tile = _MERGE_TILE[tag]
    level = (keys, pts)
    for _ in merge_levels(keys.shape[0], tile) if keys.shape[0] else ():
        level = _merge_level_plain(curve, tag, *level, tbl, tile)


@_build.counted
def boundary_merge(tag, keys, pts, tbl):
    """Write each equal-key segment's total of the boundary sequence into the
    bucket table, in place.

    keys: (m,) int32, sorted (cummax-filled: negative sentinels lead);
    pts: (3R, m) int32 points; tbl: (3R, n_seg) int32. For every key k in
    [0, n_seg) the sum of its entries goes to column k; other keys are
    skipped and other columns left as they were. Tiles of `_MERGE_TILE`
    entries, one launch per level of `merge_levels` (three at the main
    path's sizes, each counted), no host sync."""
    if keys.device.type == "cpu":
        return boundary_merge_plain(tag, keys, pts, tbl)
    _require_cuda("boundary_merge", keys, pts, tbl)
    _require_dtype("boundary_merge", torch.int32, keys, pts, tbl)
    m = keys.shape[0]
    R3 = 3 * rows_for(tag)
    if keys.dim() != 1 or pts.shape != (R3, m) or tbl.dim() != 2 or tbl.shape[0] != R3:
        raise ValueError("boundary_merge: shape mismatch")
    tile = _MERGE_TILE[tag]
    lib = _build.library()
    dev = keys.device
    for n in merge_levels(m, tile) if m else ():
        n_out = 2 * -(-n // tile)
        keys_out = torch.empty(n_out, dtype=torch.int32, device=dev)
        pts_out = torch.empty((R3, n_out), dtype=torch.int32, device=dev)
        boundary_merge.launches += 1
        err = lib.kzk_boundary_merge_level(keys.data_ptr(), pts.data_ptr(), n, keys_out.data_ptr(),
                                           pts_out.data_ptr(), tbl.data_ptr(), tbl.shape[1], tile,
                                           int(tag == "fq2"), _stream(keys))
        _build.check(err, "boundary_merge")
        keys, pts = keys_out, pts_out


# ---- K6: weighted bucket total ------------------------------------------------

# lanes over all windows that K6's walk aims for, and the fewest buckets a
# lane walks; and the most threads of a sum block (its shared-memory tree
# holds one point per thread). More lanes shorten each thread's chain of
# adds but cost each lane log2(T) doublings for its weight: on the H100
# 2^15 lanes in all, four buckets or more per lane, timed best at the main
# path's shapes (16 x 32769 and 22 x 2049 buckets, G1 and G2;
# tools/kernel_variants.py, PERF.md).
_BUCKET_LANES = 1 << 15
_MIN_BUCKETS_PER_LANE = 4
_SUM_THREADS_MAX = {"fq": 256, "fq2": 128}


def bucket_threads(tag: str, wn: int, nb: int) -> int:
    """Lanes per window for K6: the largest power of two with at most
    `_BUCKET_LANES` lanes over all windows and `_MIN_BUCKETS_PER_LANE`
    buckets or more per lane (at least one lane)."""
    t = 1
    while t * 2 <= min(_BUCKET_LANES // max(wn, 1), nb // _MIN_BUCKETS_PER_LANE):
        t *= 2
    return t


def _sum_threads(tag: str, n: int) -> int:
    """Threads of one sum block over n points: a power of two."""
    return min(1 << max(n - 1, 0).bit_length(), _SUM_THREADS_MAX[tag])


def _sum_groups_plain(curve, tag, planes, wn: int, n: int):
    """(3R, wn * n) -> (3R, wn * ceil(n / J)): each group of J points (past n:
    infinity) summed by the kernel's halving tree."""
    cd = curve.ops.coord_ndim
    J = _sum_threads(tag, n)
    Q = -(-n // J)
    pts = planes.reshape(planes.shape[0], wn, n)
    pts = torch.nn.functional.pad(pts, (0, Q * J - n)).reshape(planes.shape[0], wn * Q, J)
    part = planes_to_point(pts, tag)
    s = J // 2
    while s:
        part = curve.add(
            JacPoint(*(c.narrow(-(cd + 1), 0, s) for c in part)),
            JacPoint(*(c.narrow(-(cd + 1), s, s) for c in part)),
        )
        s //= 2
    return point_to_planes(JacPoint(*(c.select(-(cd + 1), 0) for c in part)), tag), Q


def weighted_bucket_total_plain(tag, tbl):
    """sum_b b * B[w, b] by the kernel's own schedule, vectorized (see
    csrc/msm_reduce.cu): T interleaved lanes walk their slabs from the top
    keeping R_l and W_l, each forms T * W_l + l * R_l by the same joint
    double-and-add, and groups of J lanes are summed by halving trees until
    one point per window is left. Same adds in the same order as the
    kernels, so the two agree bit for bit; the contract
    (msm_sim.weighted_bucket_total) sums in another order and agrees as
    affine points."""
    curve = curve_for(tag)
    cd = curve.ops.coord_ndim
    rows3, wn, nb = tbl.shape
    T = bucket_threads(tag, wn, nb)
    S = -(-nb // T)
    dev = tbl.device
    # bucket s * T + l is slab s of lane l; the padded buckets are all-zero
    # infinity, which an add passes over exactly as the kernel's skip does
    pts = planes_to_point(torch.nn.functional.pad(tbl, (0, S * T - nb)).reshape(rows3, wn, S, T), tag)
    rs = curve.infinity((wn, T), dev)
    ws = curve.infinity((wn, T), dev)
    for s in range(S - 1, -1, -1):
        ws = curve.add(ws, rs)
        rs = curve.add(rs, JacPoint(*(c.select(-(cd + 2), s) for c in pts)))
    lane = torch.arange(T, device=dev).expand(wn, T)
    for bit in range(T.bit_length() - 2, -1, -1):
        ws = curve.dbl(ws)
        ws = curve.select(((lane >> bit) & 1) == 1, curve.add(ws, rs), ws)
    planes, n = point_to_planes(ws, tag).reshape(rows3, wn * T), T
    while n > 1:
        planes, n = _sum_groups_plain(curve, tag, planes, wn, n)
    return planes.reshape(rows3, wn)


@_build.counted
def weighted_bucket_total(tag, tbl):
    """Dense bucket tables (3R, Wn, NB) int32 -> per-window totals (3R, Wn)
    = sum_b b * B[w, b]. Bucket 0 carries weight 0. Each window is split
    over `bucket_threads` lanes. One launch of the bucket walk, then one
    sum launch per factor of up to 256 (G1) or 128 (G2) lanes: three at the
    main path's sizes, each counted."""
    if tbl.device.type == "cpu":
        return weighted_bucket_total_plain(tag, tbl)
    _require_cuda("weighted_bucket_total", tbl)
    _require_dtype("weighted_bucket_total", torch.int32, tbl)
    if tbl.dim() != 3 or tbl.shape[0] != 3 * rows_for(tag):
        raise ValueError("weighted_bucket_total: shape mismatch")
    rows3, wn, nb = tbl.shape
    T = bucket_threads(tag, wn, nb)
    g2 = int(tag == "fq2")
    lib = _build.library()
    cur = torch.empty((rows3, wn * T), dtype=torch.int32, device=tbl.device)
    weighted_bucket_total.launches += 1
    err = lib.kzk_bucket_walk(tbl.data_ptr(), cur.data_ptr(), wn, nb, T, T.bit_length() - 1, g2, _stream(tbl))
    _build.check(err, "weighted_bucket_total")
    n = T
    while n > 1:
        J = _sum_threads(tag, n)
        q = -(-n // J)
        out = torch.empty((rows3, wn * q), dtype=torch.int32, device=tbl.device)
        weighted_bucket_total.launches += 1
        err = lib.kzk_point_sum(cur.data_ptr(), out.data_ptr(), wn, n, J, g2, _stream(tbl))
        _build.check(err, "weighted_bucket_total")
        cur, n = out, q
    return cur.reshape(rows3, wn)


# ---- K7: horner over windows --------------------------------------------------

def horner_total_plain(tag, wins, c: int):
    """Port of msm_sim.horner_total, over every batch element at once (the
    same chain per element). The kernel runs each element's chain on one
    warp, each group op as a program of independent field operations
    (ops/warp_program.py); every field result is canonical, so the two agree
    bit for bit."""
    curve = curve_for(tag)
    tot = _horner_windows(curve, planes_to_point(wins, tag), wins.shape[-1], c)
    return point_to_planes(tot, tag)


@functools.lru_cache(maxsize=None)
def _horner_program(tag: str, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(warp_program.encode(tag)).to(device)


@_build.counted
def horner_total(tag, wins, c: int):
    """Window totals (3R, Wn) int32 -> (3R,) = sum_w 2^(c*w) W_w; or a batch
    of B MSMs' totals (3R, B, Wn) -> (3R, B), in one launch of B blocks."""
    if wins.device.type == "cpu":
        return horner_total_plain(tag, wins, c)
    _require_cuda("horner_total", wins)
    _require_dtype("horner_total", torch.int32, wins)
    if wins.dim() not in (2, 3) or wins.shape[0] != 3 * rows_for(tag):
        raise ValueError("horner_total: shape mismatch")
    B = wins.shape[1] if wins.dim() == 3 else 1
    out = torch.empty(wins.shape[:-1], dtype=torch.int32, device=wins.device)
    prog = _horner_program(tag, wins.device)
    lib = _build.library()
    horner_total.launches += 1
    err = lib.kzk_horner_total(wins.data_ptr(), out.data_ptr(), B, wins.shape[-1], c, prog.data_ptr(), prog.numel(),
                               int(tag == "fq2"), _stream(wins))
    _build.check(err, "horner_total")
    return out
