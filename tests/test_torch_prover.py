"""The port's Groth16 prover against the JAX package's, on keys from the
JAX package's own setup (converted with `from_jax_proving_key`): the
coefficient evaluation and the h scalars agree bit for bit, proofs verify
under the JAX package's pairing verifier, and duplicate table rows merge
exactly as the JAX prover merges them."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keyless_zk_tpu.groth16 import verify_groth16
from keyless_zk_tpu.groth16.prover import Groth16Prover as JaxProver
from keyless_zk_tpu.groth16.prover import _dedup_point_table as jax_dedup
from keyless_zk_tpu_torch.curves.jacobian import G1_CURVE, JacPoint
from keyless_zk_tpu_torch.groth16 import Groth16Prover, from_jax_proving_key
from keyless_zk_tpu_torch.groth16.prover import _dedup_point_table
from keyless_zk_tpu_torch.ops.msm import msm

torch.set_num_threads(1)


def native_setup():
    """The native ConstraintSystem of the JAX package's end-to-end test
    (a == b^3 + b + 5, b secret), set up with pinned toxic waste."""
    from keyless_zk_tpu.circuits import ConstraintSystem, groth16_setup
    from keyless_zk_tpu.circuits.r1cs_file import r1cs_from_cs

    cs = ConstraintSystem()
    a = cs.public_wire()
    cs.set_input_hint([a], "a")
    b = cs.new_wire()
    cs.set_input_hint([b], "b")
    b2 = cs.mul(cs.lc(b), cs.lc(b))
    b3 = cs.mul(cs.lc(b2), cs.lc(b))
    cs.constrain_eq(cs.lc(b3) + cs.lc(b) + cs.const(5), cs.lc(a))
    w = cs.compute_witness(a=3**3 + 3 + 5, b=3)
    res = groth16_setup(r1cs_from_cs(cs), toxic={"tau": 999, "alpha": 3, "beta": 4, "gamma": 5, "delta": 6})
    return res, cs.witness_np(w), [w[a]]


@pytest.fixture(scope="module")
def native():
    return native_setup()


def _eq(j, t):
    return np.array_equal(np.asarray(j).astype(np.int64), t.numpy().astype(np.int64))


def test_eval_ab_and_h_scalars_match_jax(native):
    res, wit, _ = native
    jp = JaxProver(res.pk)
    tp = Groth16Prover(from_jax_proving_key(res.pk), device="cpu")
    jw = jnp.asarray(wit)
    tw = torch.from_numpy(wit.astype(np.int32))
    assert _eq(jp._eval_ab(jw), tp._eval_ab(tw))
    assert _eq(jp._h_scalars(jw), tp._h_scalars(tw))


def test_proof_verifies(native):
    res, wit, pub = native
    proof = Groth16Prover(from_jax_proving_key(res.pk), device="cpu").prove(wit, r=7, s=8)
    assert verify_groth16(res.vk, pub, proof.to_json_dict())
    assert not verify_groth16(res.vk, [pub[0] + 1], proof.to_json_dict())


def test_witness_limbs_are_checked(native):
    res, wit, _ = native
    bad = wit.astype(np.int64)
    bad[2, 3] = 1 << 16
    with pytest.raises(ValueError):
        Groth16Prover(from_jax_proving_key(res.pk), device="cpu").prove(bad, r=1, s=1)


def _random_table_with_dups(n, seed):
    """G1 table where ~half the rows duplicate earlier rows and a few are
    infinity (tests/test_prover_dedup.py builds the same shape)."""
    from keyless_zk_tpu.curves import ref_curve

    rng = np.random.default_rng(seed)
    base = [ref_curve.G1.mul(ref_curve.G1_GEN, int(k)) for k in rng.integers(1, 1 << 30, n)]
    x, y, inf = (t.numpy().copy() for t in G1_CURVE.encode_affine(base))
    src = rng.integers(0, n, n)
    dup = rng.random(n) < 0.5
    x[dup], y[dup] = x[src[dup]], y[src[dup]]
    infm = rng.random(n) < 0.1
    x[infm] = 0
    y[infm] = 0
    inf[infm] = True
    return x.astype(np.uint32), y.astype(np.uint32), inf


def test_dedup_and_merge_match_jax():
    from keyless_zk_tpu.ops.testgen import random_scalars
    from keyless_zk_tpu_torch.ops import testgen

    n = 150
    x, y, inf = _random_table_with_dups(n, seed=7)
    (ux, uy, uinf), merge = _dedup_point_table(x, y, inf)
    (jux, juy, juinf), jmerge = jax_dedup(x, y, inf)
    assert np.array_equal(ux, jux) and np.array_equal(uy, juy) and np.array_equal(uinf, juinf)
    order, bounds, nu = merge
    assert np.array_equal(order, jmerge[0]) and np.array_equal(bounds, jmerge[1]) and nu == jmerge[2]

    scalars = np.asarray(random_scalars(n, seed=8))
    assert np.array_equal(scalars.astype(np.int64), testgen.random_scalars(n, seed=8, device="cpu").numpy())
    jm = JaxProver._merge_scalars(jnp.asarray(scalars), (jnp.asarray(jmerge[0]), jnp.asarray(jmerge[1]), nu))
    tm = Groth16Prover._merge_scalars(
        torch.from_numpy(scalars.astype(np.int32)), (torch.from_numpy(order), torch.from_numpy(bounds), nu)
    )
    assert _eq(jm, tm)
    # MSM over the unique rows with merged scalars == MSM over the raw table
    out = msm(torch.from_numpy(ux.astype(np.int32)), torch.from_numpy(uy.astype(np.int32)),
              torch.from_numpy(uinf), tm, curve=G1_CURVE)
    got = G1_CURVE.decode_jacobian(JacPoint(*(c[None] for c in out)))[0]
    from keyless_zk_tpu.curves import ref_curve

    xs, ys = G1_CURVE.ops.decode(torch.from_numpy(x.astype(np.int32))), G1_CURVE.ops.decode(torch.from_numpy(y.astype(np.int32)))
    pts = [None if i else (a, b) for a, b, i in zip(xs, ys, inf)]
    sc = [int(v) for v in G1_CURVE.ops.decode(torch.from_numpy(scalars.astype(np.int32)), mont=False)]
    want = None
    for p, s in zip(pts, sc):
        want = ref_curve.G1.add(want, ref_curve.G1.mul(p, s) if p is not None else None)
    assert got == want


def test_prove_with_duplicated_rows_verifies(native):
    """A key whose A/B1/B2/C rows are all duplicated, with each witness
    scalar split across the two copies (test_prover_dedup.py's
    construction): the merged proof still verifies."""
    from test_prover_dedup import _dup_pk_and_split_witness

    res, wit, pub = native
    pk2, wit2 = _dup_pk_and_split_witness(res.pk, wit)
    prover = Groth16Prover(from_jax_proving_key(pk2), device="cpu")
    assert prover._merge_a is not None
    # the coefficient table reads witness[s]: evaluate with the true witness
    true_w = torch.from_numpy(wit.astype(np.int32))
    orig = prover._eval_ab
    prover._eval_ab = lambda _w: orig(true_w)
    proof = prover.prove(wit2, r=111, s=222)
    assert verify_groth16(res.vk, pub, proof.to_json_dict())
