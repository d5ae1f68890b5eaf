"""The port's matmul NTT (ops/mxu_ntt.py) against the JAX package's, bit for
bit: `factorize`, `digit_reverse_perm`, the plan tables (the banded
byte-plane matrix W_BIG, its row sums, the inter-pass twiddles) at 2^8, and
the batched (3, n) forward and inverse transforms and coset powers at 2^7
(one radix-128 pass) and 2^8 (128 x a tail of 2), which must also equal the
port's butterfly plan. The 128 x 8 class (2^10) is in
test_torch_mxu_ntt_tail.py, so that the runner spreads the JAX side's
XLA:CPU compiles over two files."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keyless_zk_tpu.ops import mxu_ntt as jax_mxu
from keyless_zk_tpu_torch.fields import torch_field as tf
from keyless_zk_tpu_torch.ops import mxu_ntt
from keyless_zk_tpu_torch.ops.ntt import NTTPlan
from torch_fixtures import limbs_t, rand_ints

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def jax_plan(domain_pow):
    return jax_mxu.MxuNTTPlan(domain_pow, cache=False)


def _eq(j, t) -> bool:
    return np.array_equal(np.asarray(j).astype(np.int64), t.numpy().astype(np.int64))


def check_transforms(domain_pow: int) -> None:
    """ntt / intt / coset_powers of a batched (3, n) input: the port's matmul
    plan == the JAX matmul plan == the port's butterfly plan."""
    n = 1 << domain_pow
    rng = np.random.default_rng(domain_pow)
    x = tf.to_mont(limbs_t(rand_ints(rng, 3 * n, tf.FR.p)), tf.FR).reshape(3, n, 16)
    plan = mxu_ntt.MxuNTTPlan(domain_pow, device="cpu")
    butterfly = NTTPlan(domain_pow, device="cpu")
    jplan = jax_plan(domain_pow)
    jx = jnp.asarray(x.numpy().astype(np.uint32))
    fwd, inv = plan.ntt(x), plan.intt(x)
    assert _eq(jplan.ntt(jx), fwd)
    assert _eq(jplan.intt(jx), inv)
    assert _eq(jplan.coset_powers(), plan.coset_powers())
    assert torch.equal(fwd, butterfly.ntt(x))
    assert torch.equal(inv, butterfly.intt(x))
    assert torch.equal(plan.coset_powers(), butterfly.coset_powers())
    assert torch.equal(plan.intt(fwd), x)


@pytest.mark.parametrize("n", [2, 8, 64, 128, 256, 1 << 10, 1 << 14, 1 << 15, 1 << 21])
def test_factorize_and_digit_reverse_perm_match_jax(n):
    assert mxu_ntt.factorize(n) == jax_mxu.factorize(n)
    if n <= 1 << 15:
        f = mxu_ntt.factorize(n)
        assert np.array_equal(mxu_ntt.digit_reverse_perm(f), jax_mxu.digit_reverse_perm(f))


def test_plan_tables_match_jax():
    plan = mxu_ntt.MxuNTTPlan(8, device="cpu")
    jplan = jax_plan(8)
    assert plan.factors == jplan.factors == [128, 2]
    assert np.array_equal(plan.perm.numpy(), np.asarray(jplan.perm))
    for mine, theirs in ((plan.tables, jplan.tables), (plan.tables_inv, jplan.tables_inv)):
        assert len(mine) == len(theirs)
        for (w_big, rowsum, tw), (jw_big, jrowsum, jtw) in zip(mine, theirs):
            assert w_big.dtype == torch.int8 and _eq(jw_big, w_big)
            assert _eq(jrowsum, rowsum)
            assert (tw is None) == (jtw is None)
            if tw is not None:
                assert _eq(jtw, tw)
    assert _eq(jplan.n_inv_mont, plan.n_inv_mont)


@pytest.mark.parametrize("domain_pow", [7, 8])
def test_transforms_match_jax_and_butterfly(domain_pow):
    check_transforms(domain_pow)
