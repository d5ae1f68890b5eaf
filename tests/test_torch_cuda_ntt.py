"""K10 (ops/cuda_ntt.py) on the CPU, where every pass runs its plain
version: a walk of the kernel's own split, twiddle tables, stage order and
bit-reversed positions in a line. The plan's NTT and iNTT against the JAX
package's (keyless_zk_tpu/ops/ntt.py), bit for bit, on batched (3, n)
inputs with 0, 1 and r - 1 planted, at the plan's own split and with the
split limit lowered to force one, two or three passes; the passes'
tables against the roots they stand for; the fused h chain
(`CudaNTTPlan.h_scalars`, through `Groth16Prover._h_scalars`) against the
JAX package's `_h_scalars` on a key with the keyless key's layout; the
wrapper's checks."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keyless_zk_tpu.ops.ntt import NTTPlan as JaxPlan
from keyless_zk_tpu_torch.fields import bn254
from keyless_zk_tpu_torch.fields import torch_field as tf
from keyless_zk_tpu_torch.fields.limbs import NUM_LIMBS, limbs_to_ints
from keyless_zk_tpu_torch.groth16 import Groth16Prover, from_jax_proving_key
from keyless_zk_tpu_torch.ops import cuda_eval_ab, cuda_ntt
from keyless_zk_tpu_torch.ops.cuda_ntt import IN_AB, IN_LIMBS, IN_WORDS, OUT_H, OUT_LIMBS, OUT_WORDS
from keyless_zk_tpu_torch.ops.ntt import NTTPlan
from test_torch_eval_ab import DOMAIN, planted_key
from torch_fixtures import limbs_t, rand_ints

torch.set_num_threads(1)

R = bn254.R_SCALAR


def batch_input(domain_pow: int) -> torch.Tensor:
    """(3, n, 16) canonical limbs, seeded, with 0, 1 and r - 1 planted at
    the ends of the first vector (n >= 8) or across the vectors."""
    n = 1 << domain_pow
    vals = rand_ints(np.random.default_rng(100 + domain_pow), 3 * n)
    edge = [0, 1, R - 1]
    if n >= 8:
        vals[:3] = edge
        vals[n - 3 : n] = edge
    else:
        vals[0], vals[n], vals[2 * n] = edge
    return limbs_t(vals).reshape(3, n, NUM_LIMBS)


@functools.lru_cache(maxsize=None)
def jax_transforms(domain_pow: int) -> tuple[np.ndarray, np.ndarray]:
    plan = JaxPlan(domain_pow, cache=False)
    x = jnp.asarray(batch_input(domain_pow).numpy().astype(np.uint32))
    return (np.asarray(plan.ntt(x)).astype(np.int64), np.asarray(plan.intt(x)).astype(np.int64))


@pytest.mark.parametrize("domain_pow,max_log,passes", [
    (1, 11, 1), (2, 11, 1), (7, 11, 1), (10, 11, 1), (11, 11, 1), (12, 11, 2), (16, 11, 2),
    (12, 12, 1),  # one pass where the kernel's limit takes two
    (7, 4, 2), (11, 6, 2),  # two
    (7, 3, 3), (10, 4, 3), (12, 5, 3), (16, 6, 3),  # three
])
def test_plan_matches_jax(domain_pow, max_log, passes):
    plan = cuda_ntt.CudaNTTPlan(domain_pow, device="cpu", max_log=max_log)
    assert len(plan.passes) == passes == len(cuda_ntt.split(domain_pow, max_log))
    x = batch_input(domain_pow)
    want_ntt, want_intt = jax_transforms(domain_pow)
    got = plan.ntt(x)
    assert np.array_equal(got.numpy().astype(np.int64), want_ntt)
    assert np.array_equal(plan.intt(x).numpy().astype(np.int64), want_intt)
    assert torch.equal(plan.intt(got), x)
    # one vector alone, as four_step_ntt and the bench hand it over
    assert np.array_equal(plan.ntt(x[1]).numpy().astype(np.int64), want_ntt[1])


@pytest.mark.parametrize("domain_pow,max_log", [(0, 11), (21, 11), (22, 11), (25, 11), (28, 11), (9, 2)])
def test_split(domain_pow, max_log):
    logs = cuda_ntt.split(domain_pow, max_log)
    assert sum(logs) == domain_pow and max(logs) <= max_log and len(logs) == max(1, -(-domain_pow // max_log))
    assert max(logs) - min(logs) <= 1 and logs == sorted(logs, reverse=True)


def test_keyless_split_and_tables():
    """At 2^21 (the keyless domain): two passes of 2^11 and 2^10 points,
    each table holding the powers of the root it stands for."""
    domain_pow = 21
    w = bn254.fr_root_of_unity(domain_pow)
    passes = cuda_ntt.build_passes(domain_pow, w, "cpu")
    assert [p.log_line for p in passes] == [11, 10] and [p.log_stride for p in passes] == [10, 0]
    assert [p.final for p in passes] == [False, True] and (passes[1].la, passes[1].lb) == (11, 0)

    def ints(words, idx):
        return tf.decode_ints(cuda_eval_ab.unpack_words(words[idx]), tf.FR, mont=True)

    first, last = passes
    idx = [0, 1, 2, 777, 1023]
    assert ints(first.line, idx) == [pow(w, (1 << 10) * i, R) for i in idx]
    assert ints(last.line, [0, 1, 511]) == [pow(w, (1 << 11) * i, R) for i in [0, 1, 511]]
    assert first.lo_bits == 11 and first.lo.shape == (1 << 11, 8) and first.hi.shape == (1 << 10, 8)
    assert ints(first.lo, [0, 5, 2047]) == [pow(w, i, R) for i in [0, 5, 2047]]
    assert ints(first.hi, [1, 1023]) == [pow(w, i << 11, R) for i in [1, 1023]]


@pytest.fixture(scope="module")
def planted():
    pk, witness = planted_key()
    return pk, witness, Groth16Prover(from_jax_proving_key(pk), device="cpu")


def test_h_chain_matches_jax(planted):
    """The fused chain (c = a*b in the first load, n^-1 and the coset in the
    iNTT's last store, h = A*B - C out of Montgomery form in the NTT's last
    store) at one, two and three passes, through the prover, whose plan is
    K10's on the CPU too, against the JAX package's h scalars; the
    butterfly plan's unfused chain agrees."""
    from keyless_zk_tpu.groth16.prover import Groth16Prover as JaxProver

    pk, witness, prover = planted
    want = np.asarray(JaxProver(pk)._h_scalars(jnp.asarray(witness))).astype(np.int64)
    w = torch.from_numpy(witness.astype(np.int32))
    k10 = prover.plan
    assert isinstance(k10, cuda_ntt.CudaNTTPlan)
    assert np.array_equal(prover._h_scalars(w).numpy().astype(np.int64), want)
    domain_pow = DOMAIN.bit_length() - 1
    butterfly = NTTPlan(domain_pow, device="cpu")
    ab = prover._eval_ab(w)
    a, b = ab[:DOMAIN], ab[DOMAIN:]
    abc = butterfly.intt(torch.stack([a, b, tf.mont_mul(a, b, tf.FR)]))
    abc = butterfly.ntt(tf.mont_mul(abc, butterfly.coset_powers(), tf.FR))
    h = tf.from_mont(tf.sub(tf.mont_mul(abc[0], abc[1], tf.FR), abc[2], tf.FR), tf.FR)
    assert np.array_equal(h.numpy().astype(np.int64), want)
    try:
        for max_log, passes in ((11, 1), (3, 2), (2, 3)):
            prover.plan = cuda_ntt.CudaNTTPlan(domain_pow, device="cpu", max_log=max_log)
            assert len(prover.plan.passes) == passes
            assert torch.equal(prover.plan.coset_powers(), butterfly.coset_powers())
            assert np.array_equal(prover._h_scalars(w).numpy().astype(np.int64), want)
    finally:
        prover.plan = k10


def test_h_chain_planted_edges():
    """a and b with 0, 1 and r - 1 planted: the chain equals its unfused
    steps through the butterfly plan, and h is canonical."""
    from keyless_zk_tpu_torch.ops.ntt import NTTPlan

    domain_pow = 7
    n = 1 << domain_pow
    x = batch_input(domain_pow)
    ab = torch.cat([x[0], x[2]])
    plan = cuda_ntt.CudaNTTPlan(domain_pow, device="cpu", max_log=3)
    ref = NTTPlan(domain_pow, device="cpu")
    a, b = ab[:n], ab[n:]
    abc = ref.intt(torch.stack([a, b, tf.mont_mul(a, b, tf.FR)]))
    abc = ref.ntt(tf.mont_mul(abc, ref.coset_powers(), tf.FR))
    want = tf.from_mont(tf.sub(tf.mont_mul(abc[0], abc[1], tf.FR), abc[2], tf.FR), tf.FR)
    got = plan.h_scalars(ab)
    assert torch.equal(got, want)
    assert max(limbs_to_ints(got.numpy())) < R


def test_wrapper_checks():
    domain_pow = 7
    plan = cuda_ntt.CudaNTTPlan(domain_pow, device="cpu", max_log=4)
    first, last = plan.passes
    x = batch_input(domain_pow)
    n = 1 << domain_pow
    with pytest.raises(TypeError):
        cuda_ntt.ntt_pass(x.long(), first, 3, IN_LIMBS, OUT_WORDS)
    with pytest.raises(ValueError, match="shape"):
        cuda_ntt.ntt_pass(x[:, :-1].contiguous(), first, 3, IN_LIMBS, OUT_WORDS)
    with pytest.raises(ValueError, match="shape"):
        cuda_ntt.ntt_pass(x, first, 3, IN_WORDS, OUT_WORDS)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_ntt.ntt_pass(x.transpose(0, 1).contiguous().transpose(0, 1), first, 3, IN_LIMBS, OUT_WORDS)
    with pytest.raises(ValueError, match="tables on"):
        cuda_ntt.ntt_pass(torch.empty(x.shape, dtype=torch.int32, device="meta"), first, 3, IN_LIMBS, OUT_WORDS)
    with pytest.raises(ValueError, match="batch of 3"):
        cuda_ntt.ntt_pass(torch.cat([x[0], x[1]])[None].reshape(2, n, NUM_LIMBS), last, 2, IN_LIMBS, OUT_H)
    with pytest.raises(ValueError, match="last pass"):
        cuda_ntt.ntt_pass(x, first, 3, IN_LIMBS, OUT_H)
    with pytest.raises(ValueError, match="scale"):
        cuda_ntt.ntt_pass(x, first, 3, IN_LIMBS, OUT_WORDS, plan.n_inv)
    with pytest.raises(ValueError, match="scale"):
        cuda_ntt.ntt_pass(cuda_eval_ab.pack_words(x), last, 3, IN_WORDS, OUT_LIMBS, plan.n_inv[:, :4].contiguous())
    before = cuda_ntt.ntt_pass.launches
    mid = cuda_ntt.ntt_pass(torch.cat([x[0], x[1]]), first, 3, IN_AB, OUT_WORDS)  # the plain version
    assert mid.shape == (3, n, 8) and mid.is_contiguous()
    assert cuda_ntt.ntt_pass(mid, last, 3, IN_WORDS, OUT_H).shape == (n, NUM_LIMBS)
    assert cuda_ntt.ntt_pass.launches == before


def test_domain_too_big():
    with pytest.raises(ValueError, match="too big"):
        cuda_ntt.CudaNTTPlan(bn254.TWO_ADICITY + 1, device="cpu")
