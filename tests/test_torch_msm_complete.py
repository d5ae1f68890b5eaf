"""The port's complete MSM (`msm`/`msm_batch(..., assume_distinct=False)`,
whose scan takes K4's complete body) against the JAX package's on tables
with duplicate points, and the complete scan's plain version against the
JAX contract on streams with P == Q and P == -Q runs.

Tables are built as tests/test_prover_dedup.py builds its G1 table: about
half the rows copy earlier rows and ~10% are infinity. A third of the
copies copy the row just before and share its scalar, so the two land next
to each other in a bucket run in every window and the scan adds P + P. On
the CPU the scan runs its plain version (`cuda_msm.window_scan_plain`) with
the complete body's law; the JAX `msm` runs its XLA Pippenger. Exact
integers: results are compared as affine points, with no tolerance. G1
here; G2 in test_torch_msm_complete_g2.py and
test_torch_msm_batch_complete_g2.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keyless_zk_tpu.curves import jacobian as jjac
from keyless_zk_tpu.ops import msm as jmsm
from keyless_zk_tpu.ops import msm_sim
from keyless_zk_tpu_torch.curves.jacobian import G1_CURVE, G2_CURVE, JacPoint
from keyless_zk_tpu_torch.ops import cuda_curve, cuda_msm, msm
from test_torch_msm_kernels import _interior_totals, _table, _u32
from torch_fixtures import GROUPS, limbs_t, rand_ints

torch.set_num_threads(1)

CURVES = {"fq": (G1_CURVE, jjac.G1_CURVE), "fq2": (G2_CURVE, jjac.G2_CURVE)}


def table_with_dups(tag, n, seed, batch=1):
    """Host points with duplicates and infinity rows, and `batch` scalar
    vectors in which a row that copies the row before takes its scalar."""
    rng = np.random.default_rng(seed)
    group, gen = GROUPS[tag]
    pts = [group.mul(gen, int(k)) for k in rng.integers(1, 1 << 30, n)]
    vecs = [rand_ints(rng, n) for _ in range(batch)]
    adjacent = 0
    for i in range(1, n):
        if rng.random() < 0.5:
            j = i - 1 if rng.random() < 1 / 3 else int(rng.integers(0, i))
            pts[i] = pts[j]
            if j == i - 1:
                adjacent += 1
                for v in vecs:
                    v[i] = v[j]
    for i in np.flatnonzero(rng.random(n) < 0.1):
        pts[i] = None
    assert adjacent > 10 and len(set(pts)) < 0.7 * n
    return pts, vecs


@functools.lru_cache(maxsize=None)
def case(tag, n, seed, batch):
    """(points, scalar vectors, the JAX msm_batch(assume_distinct=False) of
    them as host points)."""
    pts, vecs = table_with_dups(tag, n, seed, batch)
    jc = CURVES[tag][1]
    jx, jy, jinf = jc.encode_affine(pts)
    sc = [jnp.asarray(limbs_t(v).numpy().astype(np.uint32)) for v in vecs]
    if batch == 1:
        out = jmsm.msm(jx, jy, jinf, sc[0], curve=jc, assume_distinct=False)
        want = jc.decode_jacobian(jjac.JacPoint(*(c[None] for c in out)))
    else:
        want = jc.decode_jacobian(jmsm.msm_batch(jx, jy, jinf, jnp.stack(sc), curve=jc, assume_distinct=False))
    return pts, vecs, want


def port_msm(tag, pts, vecs, monkeypatch):
    """The port's msm (one vector) or msm_batch, assume_distinct=False, as
    host points; asserts that the complete scan added P + P: on G2 its law
    took the affine doubling, on G1 its branch-free projective law met an
    accumulator equal to the incoming point (X == x2 Z, Y == y2 Z, Z != 0)."""
    curve = CURVES[tag][0]
    x, y, inf = curve.encode_affine(pts)
    doublings = []
    real = cuda_curve._dbl_affine
    monkeypatch.setattr(cuda_curve, "_dbl_affine", lambda *a: doublings.append(1) or real(*a))
    real_proj = cuda_curve.madd_proj_plain
    f = G1_CURVE.ops

    def proj(p, qx, qy, q_inf, tag_):
        same = ((f.mul(qx, p.z) == p.x).all(-1) & (f.mul(qy, p.z) == p.y).all(-1) & ~f.is_zero(p.z) & ~q_inf)
        if bool(same.any()):
            doublings.append(1)
        return real_proj(p, qx, qy, q_inf, tag_)

    monkeypatch.setattr(cuda_curve, "madd_proj_plain", proj)
    if len(vecs) == 1:
        out = msm.msm(x, y, inf, limbs_t(vecs[0]), curve=curve, assume_distinct=False)
        got = curve.decode_jacobian(JacPoint(*(c[None] for c in out)))
    else:
        out = msm.msm_batch(x, y, inf, torch.stack([limbs_t(v) for v in vecs]), curve=curve, assume_distinct=False)
        got = curve.decode_jacobian(out)
    assert doublings, "no bucket run of the complete scan added P + P"
    return got


def check_msm_complete(tag, n, batch, monkeypatch):
    pts, vecs, want = case(tag, n, 40 + n, batch)
    group = GROUPS[tag][0]
    assert want == [group.msm(v, pts) for v in vecs]  # host double-and-add
    assert port_msm(tag, pts, vecs, monkeypatch) == want


def test_msm_complete_g1_matches_jax(monkeypatch):
    check_msm_complete("fq", 200, 1, monkeypatch)


def test_msm_batch_complete_g1_matches_jax(monkeypatch):
    check_msm_complete("fq", 200, 2, monkeypatch)


def planted_stream(tag, V=16, L=6, seed=3):
    """A sorted stream whose runs are planted, in turn: one point repeated
    (P + P at the run's first add), P then -P then another point, A, B, -B,
    A (P == Q against an accumulator with z != 1), and P then -P then a
    point at infinity (both at infinity after the cancellation). Returns
    (table, tinf, keys, pay, fb, idx, neg, n_seg)."""
    rng = np.random.default_rng(seed)
    n_pts = 40
    table, tinf = _table(tag, rng, n_pts)  # row 3 and row n_pts are at infinity
    m = V * L
    step = rng.random(m) < 0.2
    step[0] = False
    fb = np.cumsum(step).astype(np.int32)
    idx = rng.integers(4, n_pts, m).astype(np.int32)
    neg = (rng.random(m) < 0.5).astype(np.int32)
    starts = np.flatnonzero(np.r_[True, fb[1:] != fb[:-1]])
    planted = {0: 0, 1: 0, 2: 0, 3: 0}
    for r, (s, e) in enumerate(zip(starts, np.r_[starts[1:], m])):
        kind = r % 4
        if kind == 0 and e - s >= 2:
            idx[s:e], neg[s:e] = idx[s], neg[s]
        elif kind in (1, 3) and e - s >= 3:
            idx[s + 1], neg[s + 1] = idx[s], 1 - neg[s]
            if kind == 3:
                idx[s + 2] = n_pts
        elif kind == 2 and e - s >= 4:
            idx[s + 2], neg[s + 2] = idx[s + 1], 1 - neg[s + 1]
            idx[s + 3], neg[s + 3] = idx[s], neg[s]
        else:
            continue
        planted[kind] += (s // L == (s + 3) // L)  # the pattern lies inside one lane
    assert all(v > 0 for v in planted.values()), planted
    n_seg = int(fb[-L - 2])  # the last entries are sentinels
    keys = torch.from_numpy(fb.reshape(V, L).T.copy())
    pay = torch.from_numpy((idx | (neg << 30)).reshape(V, L).T.copy())
    return table, tinf, keys, pay, fb, idx, neg, n_seg


def _affine(tag, planes):
    return cuda_msm.curve_for(tag).decode_jacobian(cuda_msm.planes_to_point(planes, tag))


def check_scan_contract(tag, assume_distinct, V=16, L=6):
    """window_scan_plain (both laws) against msm_sim.window_scan(...,
    assume_distinct=False) on a planted stream: the distinct body's law
    bit for bit; the complete body's law, whose doubling and
    both-at-infinity representatives differ, as affine points. Both write
    the same columns and the same keys."""
    R = cuda_msm.rows_for(tag)
    table, tinf, keys, pay, fb, idx, neg, n_seg = planted_stream(tag, V, L)
    tbl = torch.full((3 * R, n_seg), 7, dtype=torch.int32)
    hk, hpt, tk, tpt = cuda_msm.window_scan_plain(tag, keys, pay, table, tinf, tbl, assume_distinct=assume_distinct)

    ord_sm = torch.from_numpy(idx.reshape(V, L).T.copy()).long()
    g = table[ord_sm]
    flags = tinf[ord_sm].int() | (torch.from_numpy(neg.reshape(V, L).T.copy()) << 1)
    shape = (L, 8, V // 8)
    px = torch.movedim(g[..., :R], -1, 0).reshape(R, *shape)
    py = torch.movedim(g[..., R:], -1, 0).reshape(R, *shape)
    out = msm_sim.window_scan(tag, jnp.asarray(keys.numpy().reshape(shape)), jnp.asarray(flags.numpy().reshape(shape)),
                              _u32(px), _u32(py), V=V, assume_distinct=False)
    ex, ey, ez, jhk, hx, hy, hz, jtk, tx, ty, tz = out

    def planes(*coords, cols):
        return torch.cat([torch.from_numpy(np.asarray(c).astype(np.int64).reshape(R, cols)) for c in coords]).int()

    emit = planes(ex, ey, ez, cols=L * V)
    cols, totals = _interior_totals(emit, fb, n_seg, L, V)
    assert torch.equal(hk, torch.from_numpy(np.array(jhk).reshape(V)))
    assert torch.equal(tk, torch.from_numpy(np.array(jtk).reshape(V)))
    written = (tbl != 7).any(dim=0)
    assert torch.equal(torch.nonzero(written).squeeze(1), cols)
    want_head, want_tail = planes(hx, hy, hz, cols=V), planes(tx, ty, tz, cols=V)
    if assume_distinct:
        assert torch.equal(tbl[:, cols], totals) and torch.equal(hpt, want_head) and torch.equal(tpt, want_tail)
    else:
        assert _affine(tag, tbl[:, cols]) == _affine(tag, totals)
        assert _affine(tag, hpt) == _affine(tag, want_head) and _affine(tag, tpt) == _affine(tag, want_tail)


@pytest.mark.parametrize("assume_distinct", [True, False], ids=["distinct_law", "complete_law"])
def test_scan_plain_matches_contract_planted(assume_distinct):
    check_scan_contract("fq", assume_distinct)
