"""Synthetic inputs: random points and scalars, and a proving key of the
keyless circuit's published shapes with known discrete logs.

Port of keyless_zk_tpu/ops/testgen.py (`random_points`, `random_scalars`)
plus `synthetic_key`, which the full-width run uses: the keyless circuit
cannot be built or set up without the JAX package, so its key is replaced
by one of the same sizes whose every point is k*G for a known random k.
A proof under such a key can be checked without a pairing: each of
pi_a, pi_b, pi_c must equal the generator times a scalar the host computes
from the discrete logs, the witness, r, s and the h scalars
(`expected_proof`).

Points come from a windowed fixed-base ladder: a host table of
d * 2^(8j) * G (j < 32, d < 256), then 32 batched complete mixed adds
through the port's group law, then one batched inversion to affine.
`random_points` draws its discrete logs as the JAX package does (uniform
in [1, r) or [1, 2^bits)), so a seed gives the same points in both
packages; `synthetic_key` draws its own below r. Either way partial bucket
sums never meet a table point w.h.p.: the MSM scan's precondition (no
P == Q inside a bucket run) holds on these tables.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import device as devices
from ..curves import ref_curve
from ..curves.jacobian import G1_CURVE, G2_CURVE, JacobianCurve
from ..fields import bn254
from ..fields.limbs import NUM_LIMBS, ints_to_limbs, limbs_to_ints
from ..fields.torch_field import FR
from ..groth16.zkey import G1Table, G2Table, ProvingKey
from .msm import SCALAR_BITS

R = bn254.R_SCALAR

# points per ladder pass: bounds the group law's int64 temporaries on the card
_GEN_CHUNK = 1 << 20

# the full keyless circuit (BASELINE.md of the JAX package; prover.py there)
KEYLESS_SHAPE = dict(
    n_vars=1_377_553,
    n_public=1,
    domain_pow=21,
    n_distinct_a=1_194_986,
    n_distinct_b=796_854,
    n_coefs=42_700_000,
)


@functools.lru_cache(maxsize=4)
def _ladder_table_host(g2: bool):
    """[d * 2^(8j) * G for j < 32 for d < 256] as host affine points."""
    grp, gen = (ref_curve.G2, ref_curve.G2_GEN) if g2 else (ref_curve.G1, ref_curve.G1_GEN)
    out = []
    base = gen
    for _ in range(32):
        row = [None]
        for _ in range(255):
            row.append(grp.add(row[-1], base))
        out.extend(row)
        base = grp.add(row[-1], base)  # 256 * base
    return out


def fixed_base_points(k_limbs: torch.Tensor, curve: JacobianCurve):
    """k_i * G for standard-form scalar limbs (n, 16) on any device ->
    affine (x, y, inf) on that device."""
    dev = k_limbs.device
    tx, ty, tinf = curve.encode_affine(_ladder_table_host(curve is G2_CURVE), device=dev)
    xs, ys, infs = [], [], []
    for s in range(0, k_limbs.shape[0], _GEN_CHUNK):
        k = k_limbs[s : s + _GEN_CHUNK].long()
        acc = curve.infinity((k.shape[0],), dev)
        for j in range(32):
            byte = (k[:, j // 2] >> (8 * (j % 2))) & 0xFF
            idx = j * 256 + byte
            acc = curve.add_mixed(acc, tx[idx], ty[idx], tinf[idx])
        x, y, inf = curve.to_affine(acc)
        xs.append(x)
        ys.append(y)
        infs.append(inf)
    return torch.cat(xs), torch.cat(ys), torch.cat(infs)


def _random_below_r(rng: np.random.Generator, n: int) -> np.ndarray:
    """(n, 16) uint32 limbs of random values < r (top limb below r's)."""
    limbs = rng.integers(0, 1 << 16, size=(n, NUM_LIMBS), dtype=np.uint32)
    limbs[:, -1] = rng.integers(0, R >> 240, size=n, dtype=np.uint32)
    return limbs


def _draws(seed: int, n: int) -> list[int]:
    """n little-endian 256-bit values from np.random.default_rng(seed): what
    n calls of rng.bytes(32) give (the JAX package's draw), taken in one
    call, which yields the same bytes ~8x faster."""
    buf = np.random.default_rng(seed).bytes(32 * n)
    return [int.from_bytes(buf[i : i + 32], "little") for i in range(0, 32 * n, 32)]


def random_dlogs(n: int, seed: int = 0, bits: int = SCALAR_BITS) -> list[int]:
    """The discrete logs `random_points` draws: 1 + (32 random bytes mod
    (r - 1)), or mod (2^bits - 1) for bits < 254, from
    np.random.default_rng(seed) (keyless_zk_tpu/ops/testgen.py's draw)."""
    mod = ((1 << bits) if bits < SCALAR_BITS else R) - 1
    return [1 + v % mod for v in _draws(seed, n)]


def random_points(
    n: int,
    seed: int = 0,
    curve: JacobianCurve | None = None,
    bits: int = SCALAR_BITS,
    device=devices.DEFAULT,
):
    """n random affine points k_i * G with k_i = random_dlogs(n, seed,
    bits)[i]: (x, y, inf). The same points as the JAX package's
    random_points for the same (n, seed, curve, bits)."""
    curve = curve or G1_CURVE
    k = ints_to_limbs(random_dlogs(n, seed, bits))
    return fixed_base_points(torch.from_numpy(k.astype(np.int32)).to(devices.resolve(device)), curve)


def random_scalars(n: int, seed: int = 1, device=devices.DEFAULT) -> torch.Tensor:
    """Uniform [0, r) scalars as (n, 16) int32 limbs; the same values as the
    JAX package's random_scalars for the same seed."""
    dev = devices.resolve(device)
    vals = [v % FR.p for v in _draws(seed, n)]
    return torch.from_numpy(ints_to_limbs(vals).astype(np.int32)).to(dev)


# ---- a keyless-shape key with known discrete logs -----------------------------

@dataclass
class SyntheticKey:
    pk: ProvingKey
    witness: np.ndarray  # (n_vars, 16) uint32
    dlog_a: list  # per table row; 0 for infinity rows
    dlog_b: list  # shared by B1 and B2
    dlog_c: list
    dlog_h: list
    alpha: int
    beta: int
    delta: int


def _table_rows(rng, n_rows: int, n_distinct: int, n_inf: int):
    """Row -> distinct-point index map: n_distinct distinct rows, n_inf
    infinity rows (-1), the rest duplicates of distinct rows, shuffled."""
    src = np.concatenate([
        np.arange(n_distinct),
        np.full(n_inf, -1),
        rng.integers(0, n_distinct, n_rows - n_distinct - n_inf),
    ])
    return rng.permutation(src)


def _witness(rng, n_vars: int) -> np.ndarray:
    """w[0] = 1; ~94% bit-valued wires, most of the rest < 2^16, a few full."""
    w = np.zeros((n_vars, NUM_LIMBS), np.uint32)
    kind = rng.random(n_vars)
    w[:, 0] = rng.integers(0, 2, n_vars)
    small = kind >= 0.94
    w[small, 0] = rng.integers(0, 1 << 16, int(small.sum()))
    full = kind >= 0.994
    w[full] = _random_below_r(rng, int(full.sum()))
    w[0] = 0
    w[0, 0] = 1
    return w


def coef_table_of_lengths(lengths, n_vars: int, seed: int, device=devices.DEFAULT, items: int | None = None):
    """A coefficient table (ops/cuda_eval_ab.py `CoefTable`) whose row d holds
    lengths[d] entries, its witness rows and its stored values (below r)
    drawn on `device` from `seed`: the planted shapes of the coefficient
    evaluation's checks (empty rows, rows past a block's share of the
    kernel's merge path, a dense last row)."""
    from .cuda_eval_ab import ITEMS_PER_THREAD, WORDS, CoefTable, merge_path_starts, pack_words

    dev = devices.resolve(device)
    row_ptr = np.concatenate([[0], np.cumsum(np.asarray(lengths, np.int64))])
    nnz = int(row_ptr[-1])
    items = ITEMS_PER_THREAD if items is None else items
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    src = torch.randint(0, n_vars, (nnz,), generator=gen, dtype=torch.int32, device=dev)
    val = torch.empty((nnz, WORDS), dtype=torch.int32, device=dev)
    for e0 in range(0, nnz, 1 << 22):
        limbs = torch.randint(0, 1 << 16, (min(1 << 22, nnz - e0), NUM_LIMBS), generator=gen, dtype=torch.int32,
                              device=dev)
        limbs[:, -1] = torch.randint(0, R >> 240, (limbs.shape[0],), generator=gen, dtype=torch.int32, device=dev)
        val[e0 : e0 + limbs.shape[0]] = pack_words(limbs)
    row_ptr = torch.from_numpy(row_ptr.astype(np.int32)).to(dev)
    return CoefTable(
        n_src=n_vars, row_ptr=row_ptr, src=src, val=val, part_row=merge_path_starts(row_ptr, items), items=items
    )


def witness_near_r(n_vars: int, seed: int, device=devices.DEFAULT) -> torch.Tensor:
    """(n_vars, 16) int32 limbs: a quarter of the rows r - 1 - k (k < 2^16),
    a quarter zero, a quarter 0 or 1, the rest uniform below r."""
    rng = np.random.default_rng(seed)
    w = _random_below_r(rng, n_vars)
    kind = rng.integers(0, 4, n_vars)
    near = np.flatnonzero(kind == 0)
    w[near] = ints_to_limbs([R - 1 - int(k) for k in rng.integers(0, 1 << 16, near.shape[0])])
    w[kind == 1] = 0
    bits = kind == 2
    w[bits] = 0
    w[bits, 0] = rng.integers(0, 2, int(bits.sum()))
    return torch.from_numpy(w.astype(np.int32)).to(devices.resolve(device))


def synthetic_key(
    seed: int,
    *,
    n_vars: int,
    n_public: int,
    domain_pow: int,
    n_distinct_a: int,
    n_distinct_b: int,
    n_coefs: int,
    device=devices.DEFAULT,
) -> SyntheticKey:
    """A proving key with random tables of the given shapes and known dlogs,
    plus a witness of keyless shape. Points are built on `device` (the card
    unless the caller asks for the CPU)."""
    device = devices.resolve(device)
    rng = np.random.default_rng(seed)
    n = 1 << domain_pow
    alpha, beta, gamma, delta = (int(v) for v in limbs_to_ints(_random_below_r(rng, 4)))
    g1, g2 = ref_curve.G1, ref_curve.G2
    G1g, G2g = ref_curve.G1_GEN, ref_curve.G2_GEN

    rows_a = _table_rows(rng, n_vars, n_distinct_a, 0)
    # B: the distinct triples include the infinity row; most absent wires
    # are infinity, the remaining rows duplicate
    n_inf_b = (n_vars - n_distinct_b + 1) * 4 // 5
    rows_b = _table_rows(rng, n_vars, n_distinct_b - 1, n_inf_b)
    n_c = n_vars - n_public - 1

    ka = _random_below_r(rng, n_distinct_a)
    kb = _random_below_r(rng, n_distinct_b - 1)
    kc = _random_below_r(rng, n_c)
    kh = _random_below_r(rng, n)

    def g1_table(k, rows=None):
        x, y, inf = (t.cpu().numpy() for t in fixed_base_points(torch.from_numpy(k.astype(np.int32)).to(device), G1_CURVE))
        if rows is not None:
            x, y, inf = x[rows], y[rows], inf[rows]
            x[rows < 0] = 0
            y[rows < 0] = 0
            inf = inf | (rows < 0)
        return G1Table(x.astype(np.uint32), y.astype(np.uint32), inf)

    kb_t = torch.from_numpy(kb.astype(np.int32)).to(device)
    b2x, b2y, b2inf = (t.cpu().numpy() for t in fixed_base_points(kb_t, G2_CURVE))
    b2x, b2y, b2inf = b2x[rows_b], b2y[rows_b], b2inf[rows_b] | (rows_b < 0)
    b2x[rows_b < 0] = 0
    b2y[rows_b < 0] = 0

    coef_c = rng.integers(0, n, n_coefs, dtype=np.uint32)
    coef_m = rng.integers(0, 2, n_coefs, dtype=np.uint32)
    coef_s = rng.integers(0, n_vars, n_coefs, dtype=np.uint32)
    pk = ProvingKey(
        n8q=32, n8r=32, q=bn254.Q, r=R,
        n_vars=n_vars, n_public=n_public, domain_size=n, n_coefs=n_coefs,
        vk_alpha1=g1.mul(G1g, alpha), vk_beta1=g1.mul(G1g, beta), vk_beta2=g2.mul(G2g, beta),
        vk_gamma2=g2.mul(G2g, gamma), vk_delta1=g1.mul(G1g, delta), vk_delta2=g2.mul(G2g, delta),
        coef_m=coef_m, coef_c=coef_c, coef_s=coef_s, coef_val=_random_below_r(rng, n_coefs),
        points_a=g1_table(ka, rows_a),
        points_b1=g1_table(kb, rows_b),
        points_b2=G2Table(b2x.astype(np.uint32), b2y.astype(np.uint32), b2inf),
        points_c=g1_table(kc),
        points_h=g1_table(kh),
    )

    def per_row(k, rows):
        ints = limbs_to_ints(k)
        return [0 if i < 0 else ints[i] for i in rows]

    return SyntheticKey(
        pk=pk,
        witness=_witness(rng, n_vars),
        dlog_a=per_row(ka, rows_a),
        dlog_b=per_row(kb, rows_b),
        dlog_c=limbs_to_ints(kc),
        dlog_h=limbs_to_ints(kh),
        alpha=alpha,
        beta=beta,
        delta=delta,
    )


def _dot(ws: list, ks: list) -> int:
    return sum(w * k for w, k in zip(ws, ks) if w) % R


def expected_proof(key: SyntheticKey, h: list, r: int, s: int):
    """(pi_a, pi_b, pi_c) the prover must return for key.witness, blinding
    (r, s) and h scalars `h`, from the key's discrete logs alone."""
    w = limbs_to_ints(key.witness)
    pad = key.pk.n_vars - len(key.dlog_c)
    a = (_dot(w, key.dlog_a) + key.alpha + r * key.delta) % R
    b = (_dot(w, key.dlog_b) + key.beta + s * key.delta) % R
    c = (_dot(w[pad:], key.dlog_c) + _dot(h, key.dlog_h) + s * a + r * b - r * s * key.delta) % R
    g1, g2 = ref_curve.G1, ref_curve.G2
    return g1.mul(ref_curve.G1_GEN, a), g2.mul(ref_curve.G2_GEN, b), g1.mul(ref_curve.G1_GEN, c)
