"""Field layer of the PyTorch port against the JAX package, bit for bit.

Inputs come from a seeded numpy generator and go to both packages as numpy
arrays; outputs are canonical limbs, so equality is exact. The JAX side
runs as its own CPU tests run it (`_mont_mul_xla` under `mont_mul`, since
the Pallas kernel is TPU-only). Batches of 600 elements take the port's
limb-major large-batch path, smaller ones its vectorized path.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keyless_zk_tpu.fields import jax_field as jf
from keyless_zk_tpu_torch.fields import torch_field as tf
from keyless_zk_tpu_torch.fields.limbs import ints_to_limbs, limbs_to_ints
from keyless_zk_tpu_torch.ops import cuda_field

torch.set_num_threads(1)

SPECS = [(jf.FR, tf.FR), (jf.FQ, tf.FQ)]
IDS = ["fr", "fq"]


def _vals(rng, p, n):
    edge = [0, 1, p - 1, p - 2, (1 << 255) % p, 2]
    rand = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n - len(edge))]
    return edge + rand


def _both(vals):
    arr = ints_to_limbs(vals)
    return jnp.asarray(arr), torch.from_numpy(arr.astype(np.int32))


def _eq(j, t):
    return np.array_equal(np.asarray(j).astype(np.int64), t.numpy().astype(np.int64))


@pytest.mark.parametrize("n", [40, 600])
@pytest.mark.parametrize("jspec,tspec", SPECS, ids=IDS)
def test_add_sub_neg_mul(jspec, tspec, n):
    rng = np.random.default_rng(n)
    xs, ys = _vals(rng, tspec.p, n), _vals(rng, tspec.p, n)[::-1]
    ja, ta = _both(xs)
    jb, tb = _both(ys)
    assert _eq(jf.add(ja, jb, jspec), tf.add(ta, tb, tspec))
    assert _eq(jf.sub(ja, jb, jspec), tf.sub(ta, tb, tspec))
    assert _eq(jf.sub(jb, ja, jspec), tf.sub(tb, ta, tspec))
    assert _eq(jf.neg(ja, jspec), tf.neg(ta, tspec))
    assert _eq(jf._mont_mul_xla(ja, jb, jspec), tf.mont_mul(ta, tb, tspec))
    assert _eq(jf.is_zero(ja), tf.is_zero(ta))
    mask = np.arange(n) % 3 == 0
    assert _eq(jf.select(jnp.asarray(mask), ja, jb), tf.select(torch.from_numpy(mask), ta, tb))
    # values, not only agreement
    R_inv = pow(1 << 256, -1, tspec.p)
    got = limbs_to_ints(tf.mont_mul(ta, tb, tspec).numpy())
    assert got == [x * y * R_inv % tspec.p for x, y in zip(xs, ys)]


@pytest.mark.parametrize("jspec,tspec", SPECS, ids=IDS)
def test_mont_mul_broadcasts(jspec, tspec):
    """The main path's broadcasts: coset shift (3, n) x (n,), butterfly
    twiddles (.., 2^d, half) x (half,), and one constant row."""
    rng = np.random.default_rng(5)
    a = ints_to_limbs(_vals(rng, tspec.p, 3 * 64)).reshape(3, 64, 16)
    b = ints_to_limbs(_vals(rng, tspec.p, 64))
    ja, ta = jnp.asarray(a), torch.from_numpy(a.astype(np.int32))
    jb, tb = jnp.asarray(b), torch.from_numpy(b.astype(np.int32))
    assert _eq(jf._mont_mul_xla(ja, jb, jspec), tf.mont_mul(ta, tb, tspec))
    tw = ta.reshape(3, 4, 16, 16)
    assert _eq(jf._mont_mul_xla(ja.reshape(3, 4, 16, 16), jb[:16], jspec), tf.mont_mul(tw, tb[:16], tspec))
    assert _eq(jf._mont_mul_xla(ja, jb[7], jspec), tf.mont_mul(ta, tb[7], tspec))
    # the plain version of K1 is what a CPU tensor runs
    assert torch.equal(cuda_field.mont_mul(ta.reshape(-1, 16), tb[:1], tspec), cuda_field.mont_mul_plain(ta.reshape(-1, 16), tb[:1], tspec))


@pytest.mark.parametrize("jspec,tspec", SPECS, ids=IDS)
def test_mont_conversions_pow_inv(jspec, tspec):
    rng = np.random.default_rng(9)
    xs = _vals(rng, tspec.p, 8)
    ja, ta = _both(xs)
    assert _eq(jf.to_mont(ja, jspec), tf.to_mont(ta, tspec))
    assert _eq(jf.from_mont(ja, jspec), tf.from_mont(ta, tspec))
    assert _eq(jf.mont_pow(ja, 13, jspec), tf.mont_pow(ta, 13, tspec))
    assert _eq(jf.mont_inv(ja, jspec), tf.mont_inv(ta, tspec))
    inv = tf.decode_ints(tf.mont_inv(ta, tspec), tspec, mont=True)
    want = [pow(tspec.from_mont_int(x), -1, tspec.p) if x else 0 for x in xs]
    assert inv == want


@pytest.mark.parametrize("n", [50, 700])
@pytest.mark.parametrize("jspec,tspec", SPECS, ids=IDS)
def test_split8_and_segment_sums(jspec, tspec, n):
    rng = np.random.default_rng(n + 1)
    xs = _vals(rng, tspec.p, n)
    ja, ta = _both(xs)
    jlo, jhi = jf.split8(ja)
    tlo, thi = tf.split8(ta)
    assert _eq(jlo, tlo) and _eq(jhi, thi)
    bounds = np.array(sorted({0, n, 3, 3, n // 2, n - 1, *rng.integers(0, n, 6).tolist()}), np.int32)
    got = tf.sorted_segment_sum_mod(ta, torch.from_numpy(bounds), tspec)
    assert _eq(jf.sorted_segment_sum_mod(ja, jnp.asarray(bounds), jspec), got)
    R_inv = pow(1 << 256, -1, tspec.p)
    want = [sum(xs[s:e]) * R_inv % tspec.p for s, e in zip(bounds[:-1], bounds[1:])]
    assert limbs_to_ints(got.numpy()) == want
    # fold of large column sums (up to 2^31 per column), on both sides of
    # the limb-major threshold
    for rows in (5, 600):
        slo = rng.integers(0, 1 << 31, (rows, 16)).astype(np.uint32)
        shi = rng.integers(0, 1 << 31, (rows, 16)).astype(np.uint32)
        assert _eq(
            jf.fold_split8_mod(jnp.asarray(slo), jnp.asarray(shi), jspec),
            tf.fold_split8_mod(torch.from_numpy(slo.astype(np.int64)), torch.from_numpy(shi.astype(np.int64)), tspec),
        )


@pytest.mark.parametrize("jspec,tspec", SPECS, ids=IDS)
def test_encode_decode(jspec, tspec):
    rng = np.random.default_rng(3)
    xs = _vals(rng, tspec.p, 10) + [tspec.p + 5]
    for mont in (False, True):
        je = jf.encode_ints(xs, jspec, mont=mont)
        te = tf.encode_ints(xs, tspec, mont=mont)
        assert _eq(je, te)
        assert tf.decode_ints(te, tspec, mont=mont) == jf.decode_ints(je, jspec, mont=mont)
