"""Plain versions of the port's MSM kernels (K4-K7) against their JAX
contracts, keyless_zk_tpu/ops/msm_sim.py.

On a CPU tensor each kernel wrapper runs its plain version, which is what
these tests call. The port's layouts at the kernel boundary (lane-contiguous
(3R, ...) planes, a point table gathered inside the scan) differ from the
TPU's (8, V/8) tiles; the tests convert. K4 and K7 agree with the contract
bit for bit; K4's bucket table equals the contract's emit gathered at the
interior run ends; K5 and K6 follow their CUDA kernels' schedules and agree
as affine points.

G1 runs every contract here; the G2 cases call the same checks from
test_torch_msm_kernels_g2.py (K4, K7), test_torch_msm_merge_g2.py (K5) and
test_torch_msm_reduce_g2.py (K6).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keyless_zk_tpu.ops import msm_sim
from keyless_zk_tpu_torch.curves.jacobian import JacPoint
from keyless_zk_tpu_torch.ops import cuda_msm
from torch_fixtures import GROUPS, points_with_dlogs

torch.set_num_threads(1)


def _u32(t):
    return jnp.asarray(t.numpy().astype(np.uint32))


def _eq(j, t):
    return np.array_equal(np.asarray(j).astype(np.int64), t.numpy().astype(np.int64))


def _table(tag, rng, n_pts):
    """(n+1, 2R) x||y table with some infinity rows and a sentinel row."""
    curve = cuda_msm.curve_for(tag)
    R = cuda_msm.rows_for(tag)
    pts, _ = points_with_dlogs(tag, n_pts, rng)
    pts[3] = None
    x, y, inf = curve.encode_affine(pts)
    table = torch.cat([x.reshape(n_pts, R), y.reshape(n_pts, R)], 1)
    table = torch.cat([table, torch.zeros((1, 2 * R), dtype=torch.int32)]).contiguous()
    tinf = torch.cat([inf, torch.ones(1, dtype=torch.bool)])
    return table, tinf


def _planes(tag, table, tinf, idx):
    """Table rows idx -> (3R, m) Jacobian planes (z = 1, or 0 at infinity)."""
    curve = cuda_msm.curve_for(tag)
    R = cuda_msm.rows_for(tag)
    m = idx.shape[0]
    z = curve.ops.select(tinf[idx], curve.ops.zeros((m,)), curve.ops.const(1, (m,)))
    p = JacPoint(cuda_msm.rows_to_coord(table[idx, :R], tag), cuda_msm.rows_to_coord(table[idx, R:], tag), z)
    return cuda_msm.point_to_planes(p, tag)


def _interior_totals(emit, fb, n_seg, L, V):
    """The old orchestrator's rule (ops/msm.py before K4 wrote its bucket
    table): a bucket whose run starts and ends inside one lane, at neither
    its first nor its last slab, is interior, and its total is the lane's
    pre-add accumulator at the slab after the run's end. emit: (3R, L * V)
    slab-major; fb: the (V * L,) lane-major sorted bucket ids. Returns
    (columns, totals (3R, columns))."""
    ids = np.arange(n_seg)
    starts = np.searchsorted(fb, ids, side="left")
    ends = np.searchsorted(fb, ids, side="right") - 1
    interior = (ends >= starts) & (starts // L == ends // L) & (starts % L != 0) & (ends % L != L - 1)
    mine = np.nonzero(interior)[0]
    e_loc = ends[mine]
    return torch.from_numpy(mine), emit[:, torch.from_numpy((e_loc % L + 1) * V + e_loc // L)]


def check_window_scan(tag, V=16, L=6, seed=1):
    """K4's bucket table and boundaries against msm_sim.window_scan: its
    emit gathered by the old interior rule, bit for bit. The ids hold
    one-slab runs, a run longer than a lane (one lane inside it whole) and,
    at the tail, sentinel ids >= n_seg."""
    rng = np.random.default_rng(seed)
    R = cuda_msm.rows_for(tag)
    n_pts = 40
    table, tinf = _table(tag, rng, n_pts)
    step = rng.random(V * L) < 0.4
    step[2 * L - 3 : 4 * L] = False  # one run over lane 2 whole, from lane 1 into lane 3
    fb = np.cumsum(step).astype(np.int32)  # sorted bucket ids
    fb[V * L // 2 :] += 3
    n_seg = int(fb[-L - 2])  # the last entries are sentinels
    assert (fb >= n_seg).sum() > 1 and (fb[2 * L : 3 * L] == fb[2 * L]).all()
    idx = rng.integers(0, n_pts + 1, V * L).astype(np.int32)
    neg = (rng.random(V * L) < 0.5).astype(np.int32)
    keys = torch.from_numpy(fb.reshape(V, L).T.copy())
    pay = torch.from_numpy((idx | (neg << 30)).reshape(V, L).T.copy())
    tbl = torch.full((3 * R, n_seg), 7, dtype=torch.int32)
    hk, hpt, tk, tpt = cuda_msm.window_scan(tag, keys, pay, table, tinf, tbl)

    ord_sm = torch.from_numpy(idx.reshape(V, L).T.copy()).long()
    g = table[ord_sm]  # (L, V, 2R)
    flags = tinf[ord_sm].int() | (torch.from_numpy(neg.reshape(V, L).T.copy()) << 1)
    shape = (L, 8, V // 8)
    px = torch.movedim(g[..., :R], -1, 0).reshape(R, *shape)
    py = torch.movedim(g[..., R:], -1, 0).reshape(R, *shape)
    out = msm_sim.window_scan(
        tag, jnp.asarray(keys.numpy().reshape(shape)), jnp.asarray(flags.numpy().reshape(shape)),
        _u32(px), _u32(py), V=V,
    )
    ex, ey, ez, jhk, hx, hy, hz, jtk, tx, ty, tz = out
    emit = torch.cat([torch.from_numpy(np.asarray(e).astype(np.int64).reshape(R, L * V)) for e in (ex, ey, ez)])
    cols, totals = _interior_totals(emit, fb, n_seg, L, V)
    assert cols.numel() > 3
    want = torch.full((3 * R, n_seg), 7, dtype=torch.int64)
    want[:, cols] = totals
    assert torch.equal(tbl.long(), want)
    for i, e in enumerate((hx, hy, hz)):
        assert _eq(e, hpt[i * R : (i + 1) * R].reshape(R, 1, 8, V // 8))
    for i, e in enumerate((tx, ty, tz)):
        assert _eq(e, tpt[i * R : (i + 1) * R].reshape(R, 1, 8, V // 8))
    assert _eq(jhk, hk.reshape(1, 8, V // 8)) and _eq(jtk, tk.reshape(1, 8, V // 8))


# K5 sequences of 32 entries: run lengths of keys -1 (leading sentinels),
# 0, 1, ... in order; with n_seg = 8 the keys 8 and 9 are no buckets.
# "mixed" has runs that cross tiles of 4 and 8 and one of 11 entries;
# "bucket last" ends on a bucket, which the last level writes; "one" is one
# key over the whole sequence.
MERGE_RUNS = {"mixed": [3, 2, 1, 11, 1, 2, 5, 1, 3, 2, 1], "bucket last": [3, 2, 1, 11, 1, 2, 5, 1, 6],
              "one": [0, 0, 0, 32]}
MERGE_N_SEG = 8


def check_boundary_merge(tag, tile, pattern, monkeypatch):
    """K5's tile schedule (tiles shrunk to `tile` entries, so that the
    sequence takes two or three levels) against msm_sim.boundary_merge: the
    table's column k holds, as an affine point, the contract's leader total
    of key k for every key in [0, n_seg); every other column is untouched."""
    rng = np.random.default_rng(2)
    R = cuda_msm.rows_for(tag)
    curve = cuda_msm.curve_for(tag)
    monkeypatch.setitem(cuda_msm._MERGE_TILE, tag, tile)
    m, n_pts = 32, 24
    table, tinf = _table(tag, rng, n_pts)
    keys = np.repeat(np.arange(-1, len(MERGE_RUNS[pattern]) - 1), MERGE_RUNS[pattern]).astype(np.int32)
    assert keys.shape == (m,) and len(cuda_msm.merge_levels(m, tile)) > 1
    pts = _planes(tag, table, tinf, torch.from_numpy(rng.integers(0, n_pts + 1, m)))
    tbl = torch.full((3 * R, MERGE_N_SEG), 7, dtype=torch.int32)
    cuda_msm.boundary_merge(tag, torch.from_numpy(keys), pts, tbl)
    want = msm_sim.boundary_merge(tag, jnp.asarray(keys[None]), *(_u32(pts[i * R : (i + 1) * R][None]) for i in range(3)))
    want = torch.cat([torch.from_numpy(np.asarray(w[0]).astype(np.int32)) for w in want])
    cols = [k for k in range(MERGE_N_SEG) if (keys == k).any()]
    leaders = [int(np.argmax(keys == k)) for k in cols]
    assert curve.decode_jacobian(cuda_msm.planes_to_point(tbl[:, cols], tag)) == curve.decode_jacobian(
        cuda_msm.planes_to_point(want[:, leaders], tag))
    rest = [k for k in range(MERGE_N_SEG) if k not in cols]
    assert (tbl[:, rest] == 7).all()


def check_weighted_bucket_total(tag, lanes=None, sum_threads=None, monkeypatch=None):
    """K6's schedule against msm_sim.weighted_bucket_total as affine points
    and against the discrete-log oracle. 129 buckets per window, some of
    them infinity; `lanes` per window (None: bucket_threads' own choice, 32
    here) comes from the lanes over all windows, `sum_threads` caps the sum
    block's threads so that the lanes are summed in more than one round, as
    on the card."""
    rng = np.random.default_rng(3)
    R = cuda_msm.rows_for(tag)
    curve = cuda_msm.curve_for(tag)
    wn, nb = 2, 129
    if lanes is not None:
        monkeypatch.setattr(cuda_msm, "_BUCKET_LANES", wn * lanes)
    assert cuda_msm.bucket_threads(tag, wn, nb) == (lanes or 32)
    if sum_threads is not None:
        monkeypatch.setitem(cuda_msm._SUM_THREADS_MAX, tag, sum_threads)
    pts, dlogs = points_with_dlogs(tag, wn * nb, rng)
    for i in (0, 5, nb + 64, 2 * nb - 1):  # bucket 0, inner buckets and the top one
        pts[i], dlogs[i] = None, 0
    x, y, inf = curve.encode_affine(pts)
    p = curve.from_affine(x, y, inf)
    tbl = cuda_msm.point_to_planes(p, tag).reshape(3 * R, wn, nb)
    got = cuda_msm.weighted_bucket_total(tag, tbl)
    want = msm_sim.weighted_bucket_total(tag, *(_u32(tbl[i * R : (i + 1) * R].permute(1, 0, 2)) for i in range(3)))
    want_pt = JacPoint(*(cuda_msm.rows_to_coord(torch.from_numpy(np.asarray(w).astype(np.int32)), tag) for w in want))
    dec = curve.decode_jacobian(cuda_msm.planes_to_point(got, tag))
    assert dec == curve.decode_jacobian(want_pt)
    group, gen = GROUPS[tag]
    for w in range(wn):
        k = sum(b * dlogs[w * nb + b] for b in range(nb))
        assert dec[w] == group.mul(gen, k)


def check_horner_total(tag, wn=5, c=4, rows=None):
    """K7 against msm_sim.horner_total, bit for bit; `rows` picks the
    window totals' table rows (the last row is infinity)."""
    rng = np.random.default_rng(4)
    R = cuda_msm.rows_for(tag)
    table, tinf = _table(tag, rng, 8)
    rows = rng.integers(0, 9, wn) if rows is None else np.asarray(rows)
    wins = _planes(tag, table, tinf, torch.from_numpy(rows))
    got = cuda_msm.horner_total(tag, wins, c)
    want = msm_sim.horner_total(tag, *(_u32(wins[i * R : (i + 1) * R].T) for i in range(3)), c)
    for i in range(3):
        assert _eq(want[i], got[i * R : (i + 1) * R])


def test_window_scan_matches_contract():
    check_window_scan("fq")


def test_window_scan_matches_contract_long_lanes():
    """Eight lanes of 13 slabs: the whole-lane run covers lane 2 and more."""
    check_window_scan("fq", V=8, L=13)


@pytest.mark.parametrize("tag,tile,pattern", [
    pytest.param("fq", 4, "mixed", id="fq"),
    pytest.param("fq", 8, "mixed", id="fq-tile8"),
    pytest.param("fq", 4, "one", id="fq-one-segment"),
    pytest.param("fq", 4, "bucket last", id="fq-bucket-last"),
])
def test_boundary_merge_matches_contract(tag, tile, pattern, monkeypatch):
    check_boundary_merge(tag, tile, pattern, monkeypatch)


def test_merge_levels_at_main_path_sizes():
    """Three launches of K5 per MSM at the main path's boundary sequences:
    2^16 entries (the witness MSMs, G1 tiles of 256 and G2 of 128) and
    67,584 (the H MSM's 33,792 lanes); one launch for a single tile."""
    assert cuda_msm.merge_levels(1 << 16, 256) == [1 << 16, 512, 4]
    assert cuda_msm.merge_levels(1 << 16, 128) == [1 << 16, 1024, 16]
    assert cuda_msm.merge_levels(67_584, 256) == [67_584, 528, 6]
    assert cuda_msm.merge_levels(256, 256) == [256]


@pytest.mark.parametrize("tag", ["fq"])
def test_weighted_bucket_total_matches_contract(tag):
    check_weighted_bucket_total(tag)


@pytest.mark.parametrize("lanes,sum_threads", [(1, None), (2, None), (32, 4)])
def test_weighted_bucket_total_lane_schedules(lanes, sum_threads, monkeypatch):
    """One lane per window, two lanes (NB not a multiple of either), and 32
    lanes summed in two rounds of blocks of four."""
    check_weighted_bucket_total("fq", lanes, sum_threads, monkeypatch)


def test_bucket_threads_fill_the_card():
    """The main path's shapes: at the H MSM's 16 windows of 32769 buckets,
    K6's walk runs 2048 lanes per window (256 blocks of 128 threads on the
    card's 132 SMs); at the witness MSMs' 22 windows of 2049, 512 lanes of
    four buckets or more; a window of three buckets, one lane."""
    assert cuda_msm.bucket_threads("fq", 16, 32769) == 2048
    assert cuda_msm.bucket_threads("fq", 22, 2049) == 512
    assert cuda_msm.bucket_threads("fq2", 22, 2049) == 512
    assert cuda_msm.bucket_threads("fq", 2, 3) == 1


def test_horner_total_matches_contract():
    check_horner_total("fq")


def test_horner_total_windows_at_infinity():
    """Wn 3, c 1: the top and the middle window totals at infinity (row 8),
    then the top alone."""
    check_horner_total("fq", 3, 1, [5, 8, 8])
    check_horner_total("fq", 3, 1, [5, 2, 8])
