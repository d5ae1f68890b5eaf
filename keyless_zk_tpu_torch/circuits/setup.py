"""Groth16 setup: R1CS -> proving key + verification key (PyTorch).

Port of keyless_zk_tpu/circuits/setup.py. A 1-party untrusted ceremony, as
the reference's testing setup: the toxic scalars (tau, alpha, beta, gamma,
delta) are sampled locally, or pinned by the caller for reproducible tests.

The host parts (Lagrange values over the domain, the u/v/w evaluations, the
IC / C / H scalars, the coefficient table, the vk) are the JAX package's,
line for line. The heavy part, ~5 n_vars + domain fixed-base scalar
multiplications, runs on the setup's device (the card unless the caller
asks for the CPU) with the JAX package's schedule: 254 MSB-first steps of a
batched doubling, a batched complete mixed add of the generator and a
select by the scalar's bit, each step one launch of kernel K3's `dbl` and
`madd` (ops/cuda_curve.py) over a whole chunk; then one batched inversion
to affine. On the CPU the same wrappers run their plain versions.

The tables stay Montgomery limb arrays from the device to the returned
`ProvingKey`: the JAX package's decode -> Python int -> Montgomery re-encode
round trip is not carried over. The values are the same (the to-affine
output is canonical Montgomery form, infinity rows are zero).

See the JAX module's docstring for the representation bookkeeping
(coefficients stored as c*R^2, the factor-free H basis over the eta-coset).
"""

from __future__ import annotations

import secrets
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import device as devices
from ..curves import ref_curve
from ..curves.jacobian import G1_CURVE, G2_CURVE
from ..fields import bn254
from ..fields.limbs import LIMB_BITS, NUM_LIMBS, ints_to_limbs
from ..groth16.zkey import G1Table, G2Table, ProvingKey
from ..ops import cuda_curve

P = bn254.R_SCALAR
R256 = 1 << 256
NBITS = 254  # scalar bits the ladder walks, MSB first

# Points per ladder pass. The JAX package's 2^15 was sized for TPU memory
# and would mean ~290k launches at the 2^21 domain; a 2^21-point G2 pass
# holds ~2.4 GB of Jacobian coordinates on the card, so a table of the
# keyless circuit's size takes one or two passes.
_CHUNK = 1 << 21


def _batch_inv(xs: list[int]) -> list[int]:
    """Montgomery batch inversion: one modular inverse for the whole list."""
    n = len(xs)
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = prefix[i] * x % P
    inv = pow(prefix[n], -1, P)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv % P
        inv = inv * xs[i] % P
    return out


def _mont_q(x: int) -> int:
    return x * R256 % bn254.Q


def _host_table(pts, group: str):
    """Host affine points (None = infinity) -> (x, y, inf) Montgomery limb
    arrays, (n, 16) for G1 and (n, 2, 16) for G2, zero rows at infinity."""
    n = len(pts)
    if group == "g1":
        xs = [0 if p is None else _mont_q(p[0]) for p in pts]
        ys = [0 if p is None else _mont_q(p[1]) for p in pts]
        shape = (n, NUM_LIMBS)
    else:
        xs = [c for p in pts for c in ((0, 0) if p is None else (_mont_q(p[0][0]), _mont_q(p[0][1])))]
        ys = [c for p in pts for c in ((0, 0) if p is None else (_mont_q(p[1][0]), _mont_q(p[1][1])))]
        shape = (n, 2, NUM_LIMBS)
    inf = np.asarray([p is None for p in pts], dtype=bool)
    return ints_to_limbs(xs).reshape(shape), ints_to_limbs(ys).reshape(shape), inf


def _ladder(k: torch.Tensor, gen, tag: str):
    """k_i * G for (n, 16) int32 standard-form scalar limbs: 254 MSB-first
    steps of dbl, complete madd with G and a select by the bit."""
    curve = G1_CURVE if tag == "fq" else G2_CURVE
    gx, gy, ginf = gen
    acc = curve.infinity((k.shape[0],), k.device)
    for i in range(NBITS - 1, -1, -1):
        acc = cuda_curve.curve_dbl(acc, tag)
        added = cuda_curve.curve_madd(acc, gx, gy, ginf, tag)
        bit = ((k[:, i // LIMB_BITS] >> (i % LIMB_BITS)) & 1).bool()
        acc = curve.select(bit, added, acc)
    return acc


def _device_points(limbs: np.ndarray, group: str, device, chunk: int):
    """[k_i * G] for (n, 16) standard-form scalar limbs, batched on `device`
    in `chunk`-point ladder passes: (x, y, inf) host Montgomery limb arrays,
    zero rows at infinity."""
    tag = "fq" if group == "g1" else "fq2"
    curve = G1_CURVE if group == "g1" else G2_CURVE
    g = curve.encode_affine([ref_curve.G1_GEN if group == "g1" else ref_curve.G2_GEN], device=device)
    xs, ys, infs = [], [], []
    for start in range(0, limbs.shape[0], chunk):
        k = torch.from_numpy(limbs[start : start + chunk]).to(device)
        x, y, inf = curve.to_affine(_ladder(k, g, tag))
        zero = torch.zeros_like(x)
        xs.append(curve.ops.select(inf, zero, x).cpu().numpy())
        ys.append(curve.ops.select(inf, zero, y).cpu().numpy())
        infs.append(inf.cpu().numpy())
    return np.concatenate(xs).astype(np.uint32), np.concatenate(ys).astype(np.uint32), np.concatenate(infs)


def _fixed_base_points(jobs, device, device_threshold: int = 512, chunk: int = _CHUNK):
    """[k * G] tables for the G1/G2 generator, one per (scalars, group) job,
    as (x, y, inf) host Montgomery limb arrays, and the seconds spent in
    the device ladders. A table of at most `device_threshold` scalars is
    computed with host ints; the larger ones of a group run as one batched
    ladder on `device` (fewer, fuller passes than one ladder per table),
    then are split again."""
    out = [None] * len(jobs)
    seconds = 0.0
    for group in ("g1", "g2"):
        big = [i for i, (sc, g) in enumerate(jobs) if g == group and len(sc) > device_threshold]
        for i, (sc, g) in enumerate(jobs):
            if g == group and i not in big:
                ops, gen = (ref_curve.G1, ref_curve.G1_GEN) if g == "g1" else (ref_curve.G2, ref_curve.G2_GEN)
                out[i] = _host_table([ops.mul(gen, k) for k in sc], group)
        if not big:
            continue
        limbs = ints_to_limbs([k % P for i in big for k in jobs[i][0]]).astype(np.int32)
        t0 = time.perf_counter()
        x, y, inf = _device_points(limbs, group, device, chunk)
        seconds += time.perf_counter() - t0
        start = 0
        for i in big:
            end = start + len(jobs[i][0])
            out[i] = (x[start:end], y[start:end], inf[start:end])
            start = end
    return out, seconds


def _affine_ints(table, group: str) -> list:
    """(x, y, inf) Montgomery limb arrays -> host affine points (None = inf)."""
    ops = G1_CURVE.ops if group == "g1" else G2_CURVE.ops
    x, y, inf = table
    xs = ops.decode(torch.from_numpy(x.astype(np.int32)))
    ys = ops.decode(torch.from_numpy(y.astype(np.int32)))
    return [None if i else (a, b) for a, b, i in zip(xs, ys, inf)]


@dataclass
class SetupResult:
    pk: ProvingKey
    vk: dict
    toxic: dict  # tau/alpha/beta/gamma/delta, exposed for tests only
    seconds: dict = field(default_factory=dict)  # {"host": s, "device": s}


def _g1_json(p):
    return ["0", "1", "0"] if p is None else [str(p[0]), str(p[1]), "1"]


def _g2_json(p):
    if p is None:
        return [["0", "0"], ["1", "0"], ["0", "0"]]
    return [[str(p[0][0]), str(p[0][1])], [str(p[1][0]), str(p[1][1])], ["1", "0"]]


def groth16_setup(
    r1cs,
    *,
    rng=None,
    toxic: dict | None = None,
    device_threshold: int = 512,
    device=devices.DEFAULT,
) -> SetupResult:
    """Run a 1-party Groth16 setup over an R1CS instance (`r1cs_from_cs`
    for ConstraintSystems). `toxic` pins the secret scalars for
    reproducible tests. The fixed-base tables are built on `device`."""
    dev = devices.resolve(device)
    t_start = time.perf_counter()
    if r1cs.prime != P:
        raise ValueError("setup requires the BN254 scalar field")
    npub = r1cs.n_public
    m0 = r1cs.n_constraints
    n_vars = r1cs.n_wires

    sample = (lambda: secrets.randbelow(P - 1) + 1) if rng is None else (lambda: rng.randrange(1, P))
    tox = toxic or {}
    tau = tox.get("tau") or sample()
    alpha = tox.get("alpha") or sample()
    beta = tox.get("beta") or sample()
    gamma = tox.get("gamma") or sample()
    delta = tox.get("delta") or sample()

    # domain covers the constraints plus the nPublic+1 binding rows snarkjs
    # appends so public wires occur in A (malleability guard)
    domain_pow = max(1, (m0 + npub + 1 - 1).bit_length())
    n = 1 << domain_pow
    omega = bn254.fr_root_of_unity(domain_pow)
    eta = bn254.fr_root_of_unity(domain_pow + 1)  # eta^2 == omega, eta^n == -1

    # ---- Lagrange values L_q(tau) over the omega domain -------------------
    w_pows = [1] * n
    for q in range(1, n):
        w_pows[q] = w_pows[q - 1] * omega % P
    z_tau = (pow(tau, n, P) - 1) % P
    if z_tau == 0:
        raise ValueError("tau landed in the evaluation domain; resample")
    denom_inv = _batch_inv([n * (tau - wq) % P for wq in w_pows])
    lag = [z_tau * wq % P * dq % P for wq, dq in zip(w_pows, denom_inv)]

    # ---- u_i(tau), v_i(tau), w_i(tau) --------------------------------------
    u = [0] * n_vars
    v = [0] * n_vars
    w = [0] * n_vars
    for q, row in enumerate(r1cs.A):
        for i, coef in row.items():
            u[i] = (u[i] + coef * lag[q]) % P
    for q, row in enumerate(r1cs.B):
        for i, coef in row.items():
            v[i] = (v[i] + coef * lag[q]) % P
    for q, row in enumerate(r1cs.C):
        for i, coef in row.items():
            w[i] = (w[i] + coef * lag[q]) % P
    for s in range(npub + 1):  # binding rows: A[m0+s][s] = 1
        u[s] = (u[s] + lag[m0 + s]) % P

    gamma_inv = pow(gamma, -1, P)
    delta_inv = pow(delta, -1, P)

    ic_scalars = [(beta * u[i] + alpha * v[i] + w[i]) % P * gamma_inv % P for i in range(npub + 1)]
    c_scalars = [(beta * u[i] + alpha * v[i] + w[i]) % P * delta_inv % P for i in range(npub + 1, n_vars)]

    # ---- H basis over the eta-coset ----------------------------------------
    t2 = tau * pow(eta, -1, P) % P
    z2 = (pow(t2, n, P) - 1) % P
    if z2 == 0:
        raise ValueError("tau/eta landed in the evaluation domain; resample")
    d2_inv = _batch_inv([n * (t2 - wq) % P for wq in w_pows])
    coset_vanish = (pow(eta, n, P) - 1) % P  # == -2
    h_common = z_tau * delta_inv % P * pow(coset_vanish, -1, P) % P
    h_scalars = [z2 * wq % P * dq % P * h_common % P for wq, dq in zip(w_pows, d2_inv)]

    # ---- point tables (batched fixed-base ladders) ---------------------------
    (pts_a, pts_b1, pts_b2, pts_c, pts_h, pts_ic), t_dev = _fixed_base_points(
        [(u, "g1"), (v, "g1"), (v, "g2"), (c_scalars, "g1"), (h_scalars, "g1"), (ic_scalars, "g1")],
        dev,
        device_threshold,
    )

    g1, g2 = ref_curve.G1, ref_curve.G2
    vk_alpha1 = g1.mul(ref_curve.G1_GEN, alpha)
    vk_beta1 = g1.mul(ref_curve.G1_GEN, beta)
    vk_beta2 = g2.mul(ref_curve.G2_GEN, beta)
    vk_gamma2 = g2.mul(ref_curve.G2_GEN, gamma)
    vk_delta1 = g1.mul(ref_curve.G1_GEN, delta)
    vk_delta2 = g2.mul(ref_curve.G2_GEN, delta)

    # ---- coefficient table (zkey section 4 semantics) -----------------------
    ms, cs_, ss, vals = [], [], [], []
    for q, row in enumerate(r1cs.A):
        for i, coef in row.items():
            ms.append(0), cs_.append(q), ss.append(i), vals.append(coef)
    for s in range(npub + 1):
        ms.append(0), cs_.append(m0 + s), ss.append(s), vals.append(1)
    for q, row in enumerate(r1cs.B):
        for i, coef in row.items():
            ms.append(1), cs_.append(q), ss.append(i), vals.append(coef)
    stored = {c: c * R256 % P * R256 % P for c in set(vals)}  # c*R^2, once per distinct c

    pk = ProvingKey(
        n8q=32,
        n8r=32,
        q=bn254.Q,
        r=P,
        n_vars=n_vars,
        n_public=npub,
        domain_size=n,
        n_coefs=len(ms),
        vk_alpha1=vk_alpha1,
        vk_beta1=vk_beta1,
        vk_beta2=vk_beta2,
        vk_gamma2=vk_gamma2,
        vk_delta1=vk_delta1,
        vk_delta2=vk_delta2,
        coef_m=np.asarray(ms, dtype=np.uint32),
        coef_c=np.asarray(cs_, dtype=np.uint32),
        coef_s=np.asarray(ss, dtype=np.uint32),
        coef_val=ints_to_limbs([stored[c] for c in vals]),
        points_a=G1Table(*pts_a),
        points_b1=G1Table(*pts_b1),
        points_b2=G2Table(*pts_b2),
        points_c=G1Table(*pts_c),
        points_h=G1Table(*pts_h),
    )

    vk = {
        "protocol": "groth16",
        "curve": "bn128",
        "nPublic": npub,
        "vk_alpha_1": _g1_json(vk_alpha1),
        "vk_beta_2": _g2_json(vk_beta2),
        "vk_gamma_2": _g2_json(vk_gamma2),
        "vk_delta_2": _g2_json(vk_delta2),
        "IC": [_g1_json(p) for p in _affine_ints(pts_ic, "g1")],
    }
    total = time.perf_counter() - t_start
    return SetupResult(
        pk=pk,
        vk=vk,
        toxic={"tau": tau, "alpha": alpha, "beta": beta, "gamma": gamma, "delta": delta},
        seconds={"host": total - t_dev, "device": t_dev},
    )
