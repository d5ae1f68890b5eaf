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

K4 `window_scan` (csrc/msm_scan.cu), K5 `boundary_merge` (csrc/msm_merge.cu),
K6 `weighted_bucket_total` and K7 `horner_total` (csrc/msm_reduce.cu).
"""

from __future__ import annotations

import torch

from ..curves.jacobian import G1_CURVE, G2_CURVE, JacPoint
from ..fields.limbs import NUM_LIMBS
from . import _build


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

def window_scan_plain(tag, keys, pay, table, tinf):
    """Port of msm_sim.window_scan (the complete mixed add, which agrees
    with the kernel's wherever the kernel's precondition holds). See
    `window_scan`."""
    curve = curve_for(tag)
    f = curve.ops
    R = rows_for(tag)
    L, V = keys.shape
    idx = (pay & ((1 << 30) - 1)).long()
    negs = ((pay >> 30) & 1) == 1
    rows = table[idx]  # (L, V, 2R)
    gx = rows_to_coord(rows[..., :R], tag)
    gy = rows_to_coord(rows[..., R:], tag)
    ginf = tinf[idx]
    dev = keys.device
    inf0 = curve.infinity((V,), dev)
    acc, head_pt = inf0, inf0
    cur_key = torch.zeros(V, dtype=torch.int32, device=dev)
    head_key = torch.full((V,), -2, dtype=torch.int32, device=dev)
    is_head = torch.zeros(V, dtype=torch.bool, device=dev)
    emits = []
    for t in range(L):
        k, q_inf = keys[t], ginf[t]
        x2 = gx[t]
        y2 = f.select(negs[t], f.neg(gy[t]), gy[t])
        emits.append(acc)  # pre-add accumulator state
        if t == 0:
            same = torch.zeros(V, dtype=torch.bool, device=dev)
            head_key = torch.full((V,), -2, dtype=torch.int32, device=dev)
            head_pt = inf0
            is_head = torch.ones(V, dtype=torch.bool, device=dev)
        else:
            same = k == cur_key
            to_head = ~same & is_head
            head_key = torch.where(to_head, cur_key, head_key)
            head_pt = curve.select(to_head, acc, head_pt)
            is_head = is_head & same
        grown = curve.add_mixed(acc, x2, y2, q_inf)
        fresh = curve.from_affine(x2, y2, q_inf)
        acc = curve.select(same, grown, fresh)
        cur_key = k
    tail_key = torch.where(is_head, -1, cur_key)
    tail_pt = curve.select(~is_head, acc, curve.infinity((V,), dev))
    head_key = torch.where(is_head, cur_key, head_key)
    head_pt = curve.select(is_head, acc, head_pt)
    emit = JacPoint(*(torch.stack(c) for c in zip(*emits)))
    return (
        point_to_planes(emit, tag),
        head_key,
        point_to_planes(head_pt, tag),
        tail_key.int(),
        point_to_planes(tail_pt, tag),
    )


@_build.counted
def window_scan(tag, keys, pay, table, tinf):
    """Scan one chunk of the sorted stream with V lanes.

    keys, pay: (L, V) int32, slab-major (entry t*V + l is slab t of lane l);
    pay = point-table row | negate << 30. table: (n+1, 2R) int32 affine
    x||y limb rows (Montgomery); tinf: (n+1,) bool.

    Returns (emit (3R, L, V) -- slab t holds lane l's pre-add accumulator;
    head_key (V,); head (3R, V); tail_key (V,); tail (3R, V)). A lane's
    head is its first run (key -2 if it never ended inside the lane, then
    overwritten by the whole-lane run); its tail is its last run, or key -1
    and infinity if one run spans the lane.

    Precondition of the kernel: no run's partial sum equals the next point
    of its run (csrc/ec.cuh madd_core takes no P == Q doubling), which holds
    for deduplicated tables of points with random discrete logs.
    """
    if keys.device.type == "cpu":
        return window_scan_plain(tag, keys, pay, table, tinf)
    _require_cuda("window_scan", keys, pay, table, tinf)
    _require_dtype("window_scan", torch.int32, keys, pay, table)
    _require_dtype("window_scan", torch.bool, tinf)
    R = rows_for(tag)
    L, V = keys.shape
    if pay.shape != keys.shape or table.dim() != 2 or table.shape[1] != 2 * R or tinf.shape != (table.shape[0],):
        raise ValueError("window_scan: shape mismatch")
    dev = keys.device
    emit = torch.empty((3 * R, L, V), dtype=torch.int32, device=dev)
    hk = torch.empty(V, dtype=torch.int32, device=dev)
    tk = torch.empty(V, dtype=torch.int32, device=dev)
    hpt = torch.empty((3 * R, V), dtype=torch.int32, device=dev)
    tpt = torch.empty((3 * R, V), dtype=torch.int32, device=dev)
    lib = _build.library()
    window_scan.launches += 1
    err = lib.kzk_window_scan(
        keys.data_ptr(), pay.data_ptr(), table.data_ptr(), tinf.data_ptr(),
        emit.data_ptr(), hk.data_ptr(), hpt.data_ptr(), tk.data_ptr(), tpt.data_ptr(),
        L, V, int(tag == "fq2"), _stream(keys),
    )
    _build.check(err, "window_scan")
    return emit, hk, hpt, tk, tpt


# ---- K5: boundary merge -------------------------------------------------------

def boundary_merge_plain(tag, keys, pts, max_steps):
    """Port of msm_sim.boundary_merge: exactly min(max_steps, log2 m)
    segmented Hillis-Steele passes."""
    curve = curve_for(tag)
    m = keys.shape[0]
    acc = planes_to_point(pts, tag)
    idx = torch.arange(m, device=keys.device)
    for s in range(min(max_steps, max(m - 1, 1).bit_length())):
        sh = 1 << s
        valid = (torch.roll(keys, -sh) == keys) & (idx < m - sh)
        acc = curve.select(valid, curve.add(acc, _roll_batch(curve, acc, sh)), acc)
    return point_to_planes(acc, tag)


@_build.counted
def boundary_merge(tag, keys, pts, max_steps: int):
    """keys (m,) int32 (sorted, cummax-filled), points (3R, m) int32 ->
    (3R, m): after min(max_steps, log2 m) passes the first (leader) entry of
    every equal-key segment shorter than 2^max_steps holds its total."""
    if keys.device.type == "cpu":
        return boundary_merge_plain(tag, keys, pts, max_steps)
    _require_cuda("boundary_merge", keys, pts)
    _require_dtype("boundary_merge", torch.int32, keys, pts)
    m = keys.shape[0]
    if keys.dim() != 1 or pts.shape != (3 * rows_for(tag), m):
        raise ValueError("boundary_merge: shape mismatch")
    steps = min(int(max_steps), max(m - 1, 1).bit_length())
    lib = _build.library()
    cur = pts
    bufs = [torch.empty_like(pts), torch.empty_like(pts)]
    for s in range(steps):
        out = bufs[s % 2]
        boundary_merge.launches += 1
        err = lib.kzk_boundary_merge_pass(
            keys.data_ptr(), cur.data_ptr(), out.data_ptr(), m, 1 << s, int(tag == "fq2"), _stream(keys)
        )
        _build.check(err, "boundary_merge")
        cur = out
    return cur


# ---- K6: weighted bucket total ------------------------------------------------

# most threads per window of csrc/msm_reduce.cu bucket_total_kernel (its
# shared-memory tree holds one point per thread)
_BUCKET_THREADS_MAX = {"fq": 256, "fq2": 128}


def bucket_threads(tag: str, nb: int) -> int:
    """Threads (lanes) per window for K6: about 32 buckets per lane, a power
    of two, at most the kernel's tree size."""
    t = 1
    while t * 2 <= min(nb // 32, _BUCKET_THREADS_MAX[tag]):
        t *= 2
    return t


def weighted_bucket_total_plain(tag, tbl):
    """sum_b b * B[w, b] by the kernel's own schedule, vectorized: lane t of
    T walks buckets [t*seg, (t+1)*seg) from the top keeping the running sum
    and its integral, adds lo * (running sum) by double-and-add, and the
    lanes are summed by a halving tree. Same adds in the same order as the
    kernel, so the two agree bit for bit; the contract
    (msm_sim.weighted_bucket_total, a suffix scan) sums in another order
    and agrees as affine points."""
    curve = curve_for(tag)
    f = curve.ops
    cd = f.coord_ndim
    _, wn, nb = tbl.shape
    T = bucket_threads(tag, nb)
    seg = -(-nb // T)
    # infinity padding at the top of the last lanes is an exact no-op: the
    # running sums stay all-zero until the lane's first real bucket
    pts = planes_to_point(torch.nn.functional.pad(tbl, (0, T * seg - nb)).reshape(tbl.shape[0], wn, T, seg), tag)
    dev = tbl.device
    rs = curve.infinity((wn, T), dev)
    ws = curve.infinity((wn, T), dev)
    for j in range(seg - 1, -1, -1):
        ws = curve.add(ws, rs)
        rs = curve.add(rs, JacPoint(*(c.select(-(cd + 1), j) for c in pts)))
    lo = torch.arange(T, device=dev) * seg
    lo = torch.where(lo < nb, lo, 0)
    acc = curve.infinity((wn, T), dev)
    for bit in range(int(lo.max()).bit_length() - 1, -1, -1):
        acc = curve.dbl(acc)
        acc = curve.select((((lo >> bit) & 1) == 1).expand(wn, T), curve.add(acc, rs), acc)
    part = curve.add(ws, acc)
    s = T // 2
    while s:
        part = curve.add(
            JacPoint(*(c.narrow(-(cd + 1), 0, s) for c in part)),
            JacPoint(*(c.narrow(-(cd + 1), s, s) for c in part)),
        )
        s //= 2
    return point_to_planes(JacPoint(*(c.select(-(cd + 1), 0) for c in part)), tag)


@_build.counted
def weighted_bucket_total(tag, tbl):
    """Dense bucket tables (3R, Wn, NB) int32 -> per-window totals (3R, Wn)
    = sum_b b * B[w, b]. Bucket 0 carries weight 0."""
    if tbl.device.type == "cpu":
        return weighted_bucket_total_plain(tag, tbl)
    _require_cuda("weighted_bucket_total", tbl)
    _require_dtype("weighted_bucket_total", torch.int32, tbl)
    if tbl.dim() != 3 or tbl.shape[0] != 3 * rows_for(tag):
        raise ValueError("weighted_bucket_total: shape mismatch")
    _, wn, nb = tbl.shape
    out = torch.empty((tbl.shape[0], wn), dtype=torch.int32, device=tbl.device)
    lib = _build.library()
    weighted_bucket_total.launches += 1
    err = lib.kzk_weighted_bucket_total(
        tbl.data_ptr(), out.data_ptr(), wn, nb, bucket_threads(tag, nb), int(tag == "fq2"), _stream(tbl)
    )
    _build.check(err, "weighted_bucket_total")
    return out


# ---- K7: horner over windows --------------------------------------------------

def horner_total_plain(tag, wins, c: int):
    """Port of msm_sim.horner_total."""
    curve = curve_for(tag)
    tot = _horner_windows(curve, planes_to_point(wins, tag), wins.shape[1], c)
    return point_to_planes(tot, tag)


@_build.counted
def horner_total(tag, wins, c: int):
    """Window totals (3R, Wn) int32 -> (3R,) = sum_w 2^(c*w) W_w."""
    if wins.device.type == "cpu":
        return horner_total_plain(tag, wins, c)
    _require_cuda("horner_total", wins)
    _require_dtype("horner_total", torch.int32, wins)
    if wins.dim() != 2 or wins.shape[0] != 3 * rows_for(tag):
        raise ValueError("horner_total: shape mismatch")
    out = torch.empty((wins.shape[0],), dtype=torch.int32, device=wins.device)
    lib = _build.library()
    horner_total.launches += 1
    err = lib.kzk_horner_total(wins.data_ptr(), out.data_ptr(), wins.shape[1], c, int(tag == "fq2"), _stream(wins))
    _build.check(err, "horner_total")
    return out
