"""The port's butterfly NTT plan against the JAX package's, bit for bit:
forward and inverse transforms of a batched (3, n) input and the coset
powers, at domains 2^4 to 2^8."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keyless_zk_tpu.ops.ntt import NTTPlan as JaxPlan
from keyless_zk_tpu_torch.fields import torch_field as tf
from keyless_zk_tpu_torch.ops.ntt import NTTPlan
from torch_fixtures import limbs_t, rand_ints

torch.set_num_threads(1)


@pytest.mark.parametrize("domain_pow", [4, 5, 6, 7, 8])
def test_ntt_intt_coset_bitwise(domain_pow):
    n = 1 << domain_pow
    rng = np.random.default_rng(domain_pow)
    x = tf.to_mont(limbs_t(rand_ints(rng, 3 * n, tf.FR.p)), tf.FR).reshape(3, n, 16)
    jplan = JaxPlan(domain_pow, cache=False)
    plan = NTTPlan(domain_pow, device="cpu")
    jx = jnp.asarray(x.numpy().astype(np.uint32))

    def eq(j, t):
        return np.array_equal(np.asarray(j).astype(np.int64), t.numpy().astype(np.int64))

    assert eq(jplan.ntt(jx), plan.ntt(x))
    assert eq(jplan.intt(jx), plan.intt(x))
    assert eq(jplan.coset_powers(), plan.coset_powers())
    assert torch.equal(plan.intt(plan.ntt(x)), x)
