"""The port's random_points against the JAX package's.

Both packages draw the discrete logs from np.random.default_rng(seed) the
same way (1 + 32 random bytes mod (r - 1), or mod (2^bits - 1)), so the
same (n, seed, curve, bits) gives the same affine points: the port's by
its fixed-base ladder on the CPU, the JAX package's by its double-and-add
on XLA:CPU. Affine Montgomery coordinates are canonical, so equal points
have equal limbs. One n for every case keeps the JAX side at one compiled
shape per (curve, bits).
"""

import numpy as np
import pytest

from keyless_zk_tpu.curves import jacobian as jjac
from keyless_zk_tpu.ops import testgen as jtestgen
from keyless_zk_tpu_torch.curves import jacobian as tjac
from keyless_zk_tpu_torch.curves import ref_curve
from keyless_zk_tpu_torch.ops import testgen

N = 6


@pytest.mark.parametrize("bits", [None, 48], ids=["bits254", "bits48"])
@pytest.mark.parametrize("seed", [42, 44])
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_random_points_equal_the_jax_package(g2, seed, bits):
    kw = {} if bits is None else {"bits": bits}
    jx, jy, jinf = jtestgen.random_points(N, seed=seed, curve=jjac.G2_CURVE if g2 else jjac.G1_CURVE, **kw)
    tx, ty, tinf = testgen.random_points(N, seed=seed, curve=tjac.G2_CURVE if g2 else tjac.G1_CURVE,
                                         device="cpu", **kw)
    assert not np.asarray(jinf).any() and not tinf.any()
    np.testing.assert_array_equal(tx.numpy().astype(np.int64), np.asarray(jx).astype(np.int64))
    np.testing.assert_array_equal(ty.numpy().astype(np.int64), np.asarray(jy).astype(np.int64))


@pytest.mark.parametrize("seed", [1, 43])
def test_random_scalars_equal_the_jax_package(seed):
    np.testing.assert_array_equal(testgen.random_scalars(37, seed=seed, device="cpu").numpy().astype(np.int64),
                                  np.asarray(jtestgen.random_scalars(37, seed=seed)).astype(np.int64))


@pytest.mark.parametrize("bits", [254, 48])
def test_random_points_are_their_dlogs_times_g(bits):
    """Each point is random_dlogs(n, seed, bits)[i] * G (host curve)."""
    ks = testgen.random_dlogs(N, seed=42, bits=bits)
    assert all(1 <= k < min(1 << bits, ref_curve.bn254.R_SCALAR) for k in ks)
    x, y, inf = testgen.random_points(N, seed=42, bits=bits, device="cpu")
    got = tjac.G1_CURVE.decode_jacobian(tjac.G1_CURVE.from_affine(x, y, inf))
    assert got == [ref_curve.G1.mul(ref_curve.G1_GEN, k) for k in ks]
