"""The port's Montgomery power (K1's `mont_pow`) against the JAX package,
bit for bit, and its wrapper's dispatch.

On CPU tensors `tf.mont_pow` / `tf.mont_inv` take the wrapper's plain
version (`cuda_field.mont_pow_plain`); the JAX side runs its own
`mont_pow` (a `lax.fori_loop` of `_mont_mul_xla` on the CPU). Inputs come
from a seeded numpy generator with 0, 1 and p - 1 planted; outputs are
canonical limbs, so equality is exact.
"""

import ctypes
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keyless_zk_tpu.fields import jax_field as jf
from keyless_zk_tpu_torch.fields import torch_field as tf
from keyless_zk_tpu_torch.fields.limbs import ints_to_limbs
from keyless_zk_tpu_torch.ops import _build, cuda_field

torch.set_num_threads(1)

SPECS = {"fr": (jf.FR, tf.FR), "fq": (jf.FQ, tf.FQ)}
# exponents by name: p - 2 is the Fermat inverse; "random" a 254-bit one
EXPONENTS = ["0", "1", "2", "13", "p-2", "random"]


def _exponent(name: str, p: int) -> int:
    if name == "p-2":
        return p - 2
    if name == "random":
        rng = np.random.default_rng(254)
        return int.from_bytes(rng.bytes(32), "little") % (1 << 254) | (1 << 253)
    return int(name)


def _inputs(p: int, n: int, seed: int):
    """n <= 16 elements: 0, 1 and p - 1 planted, the rest random < p, as
    (jax, torch) limb arrays."""
    rng = np.random.default_rng(seed)
    vals = [0, 1, p - 1] + [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n - 3)]
    arr = ints_to_limbs(vals)
    return jnp.asarray(arr), torch.from_numpy(arr.astype(np.int32)), vals


def _eq(j, t) -> bool:
    return np.array_equal(np.asarray(j).astype(np.int64), t.numpy().astype(np.int64))


@pytest.mark.parametrize("ename", EXPONENTS)
@pytest.mark.parametrize("field", ["fr", "fq"])
def test_mont_pow_equals_jax(field, ename):
    jspec, tspec = SPECS[field]
    e = _exponent(ename, tspec.p)
    ja, ta, vals = _inputs(tspec.p, 13, seed=len(ename) + 7 * (field == "fq"))
    got = tf.mont_pow(ta, e, tspec)
    assert got.dtype == torch.int32 and got.shape == ta.shape
    assert _eq(jf.mont_pow(ja, e, jspec), got)
    # the values, with the inputs read as Montgomery forms
    want = [pow(tspec.from_mont_int(v), e, tspec.p) for v in vals]
    assert tf.decode_ints(got, tspec, mont=True) == want
    if ename == "p-2":
        inv = tf.mont_inv(ta, tspec)
        assert _eq(jf.mont_inv(ja, jspec), inv)
        assert torch.equal(inv, got)
        assert not inv[0].any()  # 0 maps to 0


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_mont_pow_shapes(field):
    """Leading dims are batch dims (to_affine's (4, 16) and an Fq2 norm's
    (1, 16)); e = 0 gives the Montgomery one everywhere, 0 included."""
    _, tspec = SPECS[field]
    _, ta, _ = _inputs(tspec.p, 16, seed=3)
    one = tf.consts(tspec, tspec.r_mod_p, (16,))
    assert torch.equal(tf.mont_pow(ta, 0, tspec), one)
    for shape in [(4, 4), (2, 2, 4)]:
        got = tf.mont_pow(ta.reshape(*shape, 16), 13, tspec)
        assert torch.equal(got, tf.mont_pow(ta, 13, tspec).reshape(*shape, 16))
    assert torch.equal(tf.mont_pow(ta[:1], tspec.p - 2, tspec), tf.mont_inv(ta, tspec)[:1])


def test_mont_pow_wrapper_dispatches_on_device_only():
    """A CPU tensor takes the plain version (no launch is counted); a tensor
    on another device, or of another dtype there, is refused, never
    computed by the plain version; so is an exponent of 2^256 or more.
    K1's product refuses operands on two devices."""
    _, ta, _ = _inputs(tf.FQ.p, 8, seed=5)
    before = (cuda_field.mont_pow.launches, cuda_field.mont_mul.launches)
    assert torch.equal(cuda_field.mont_pow(ta, 13, tf.FQ), cuda_field.mont_pow_plain(ta, 13, tf.FQ))
    assert torch.equal(tf.mont_inv(ta, tf.FQ), cuda_field.mont_pow_plain(ta, tf.FQ.p - 2, tf.FQ))
    assert (cuda_field.mont_pow.launches, cuda_field.mont_mul.launches) == before
    with pytest.raises(ValueError):
        cuda_field.mont_pow(ta.to("meta"), 13, tf.FQ)
    with pytest.raises(TypeError):
        cuda_field.mont_pow(ta.long().to("meta"), 13, tf.FQ)
    with pytest.raises(ValueError):
        cuda_field.mont_mul(ta, ta.to("meta"), tf.FQ)
    with pytest.raises(ValueError):
        cuda_field.mont_mul(ta.to("meta"), ta, tf.FQ)


def test_mont_pow_in_the_kernel_table(monkeypatch):
    """`_build.load` declares `kzk_mont_pow`'s argument types: two device
    pointers, the count, the exponent's words, its bit length, the field,
    the stream."""
    class FakeLib:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    lib = _build.load("libkzk_kernels.so")
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    assert lib.kzk_mont_pow.argtypes == [P, P, LL, ctypes.POINTER(ctypes.c_uint32), I, I, P]
    assert lib.kzk_mont_pow.restype is ctypes.c_int
    # the words the wrapper hands over convert to that pointer type
    words = (ctypes.c_uint32 * 8)(*range(8))
    assert ctypes.cast(words, ctypes.POINTER(ctypes.c_uint32))[7] == 7
