"""K8's plain versions (ops/cuda_redc.py `redc_columns`, `redc_twiddle_plain`)
against the JAX package: `mxu_ntt.redc_columns` and the Pallas kernel's own
bodies (`pallas_redc._redc_core`, `_mont_mul_rows`) evaluated as plain jnp
on the CPU. Inputs: random byte-weighted columns below 2^28, all-(2^28 - 1)
columns, and accumulators T (as canonical bytes) whose reduction lands at
r + e or just below r before the conditional subtract. The values are exact
integers: equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keyless_zk_tpu.ops import mxu_ntt as jax_mxu
from keyless_zk_tpu.ops import pallas_redc
from keyless_zk_tpu_torch.fields import torch_field as tf
from keyless_zk_tpu_torch.ops import cuda_redc
from torch_fixtures import limbs_t, rand_ints

torch.set_num_threads(1)

N = 96
P = tf.FR.p


def _columns(kind: str, rng) -> np.ndarray:
    """(63, N) int32 byte columns of T."""
    if kind == "random":
        return rng.integers(0, 1 << 28, size=(63, N), dtype=np.int64).astype(np.int32)
    if kind == "max":
        return np.full((63, N), (1 << 28) - 1, dtype=np.int32)
    # the conditional subtract's edge, as canonical bytes: T = e 2^320 + d r
    # leaves (T + m r) / 2^320 = r + e before it (m = 2^320 - d), and
    # T = (r - 1 - e) 2^320 mod r leaves r - 1 - e
    ts = []
    for i in range(N):
        e, d = i // 4, int(rng.integers(1, 1 << 60))
        ts.append(e * (1 << 320) + d * P if i % 2 else ((P - 1 - e) << 320) % P)
    return np.array([[(t >> (8 * j)) & 0xFF for t in ts] for j in range(63)], dtype=np.int32)


def _t_value(cols: np.ndarray) -> list[int]:
    return [sum(int(cols[k, e]) << (8 * k) for k in range(63)) for e in range(cols.shape[1])]


@pytest.mark.parametrize("kind", ["random", "max", "csub_edge"])
def test_redc_columns_matches_jax(kind):
    rng = np.random.default_rng(["random", "max", "csub_edge"].index(kind))
    cols = _columns(kind, rng)
    got = cuda_redc.redc_columns(torch.from_numpy(cols))
    # the JAX plain reduction takes (N, 63) element-major columns
    want = jax_mxu.redc_columns(jnp.asarray(cols.T.astype(np.uint32)))
    assert np.array_equal(np.asarray(want).astype(np.int64), got.numpy().astype(np.int64))
    # and the Pallas kernel body, as plain jnp on (63,) rows of N lanes
    body = pallas_redc._redc_core([jnp.asarray(cols[k].astype(np.uint32)) for k in range(63)])
    assert np.array_equal(np.stack([np.asarray(v) for v in body], axis=-1).astype(np.int64), got.numpy().astype(np.int64))
    # the value: T * 2^-320 mod r, canonical
    inv = pow(1 << 320, -1, P)
    assert tf.decode_ints(got, tf.FR) == [t * inv % P for t in _t_value(cols)]


def test_redc_twiddle_matches_pallas_fused_body():
    rng = np.random.default_rng(7)
    cols = _columns("random", rng)
    tw = tf.to_mont(limbs_t(rand_ints(rng, N, P)), tf.FR)
    got = cuda_redc.redc_twiddle_plain(torch.from_numpy(cols), tw)
    red = pallas_redc._redc_core([jnp.asarray(cols[k].astype(np.uint32)) for k in range(63)])
    twr = [jnp.asarray(tw[:, i].numpy().astype(np.uint32)) for i in range(16)]
    body = pallas_redc._mont_mul_rows(red, twr)
    assert np.array_equal(np.stack([np.asarray(v) for v in body], axis=-1).astype(np.int64), got.numpy().astype(np.int64))
    # = redc then the mxu path's separate twiddle product
    want = jax_mxu._mm(jax_mxu.redc_columns(jnp.asarray(cols.T.astype(np.uint32))), jnp.asarray(tw.numpy().astype(np.uint32)))
    assert np.array_equal(np.asarray(want).astype(np.int64), got.numpy().astype(np.int64))


def test_redc_wrappers_dispatch_on_device_only():
    """CPU tensors take the plain versions (no launch counted); a tensor on
    another device is refused."""
    rng = np.random.default_rng(8)
    wide = torch.from_numpy(_columns("random", rng))
    tw = tf.to_mont(limbs_t(rand_ints(rng, N, P)), tf.FR)
    before = (cuda_redc.redc.launches, cuda_redc.redc_twiddle.launches)
    assert torch.equal(cuda_redc.redc(wide), cuda_redc.redc_columns(wide))
    assert torch.equal(cuda_redc.redc_twiddle(wide, tw), cuda_redc.redc_twiddle_plain(wide, tw))
    assert (cuda_redc.redc.launches, cuda_redc.redc_twiddle.launches) == before
    with pytest.raises(ValueError):
        cuda_redc.redc(wide.to("meta"))
    with pytest.raises(ValueError):
        cuda_redc.redc_twiddle(wide.to("meta"), tw.to("meta"))
