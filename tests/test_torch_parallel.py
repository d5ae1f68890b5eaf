"""The port's parallel/ package over two gloo ranks on the CPU, against the
JAX package and the port's single-process code.

Two processes are spawned on 127.0.0.1 with a free port
(tests/torch_parallel_worker.py); each joins the group through
`distributed.initialize` and runs, on the same inputs:

- `sharded_msm` (G1, 64 points: 32 per rank, each rank's local MSM, the
  partials all-gathered and summed by K3's add): equal to the host MSM and
  to the JAX package's `msm`, as affine points;
- `four_step_ntt` forward and inverse at 2^6 (n1 = n2 = 8, one
  all-to-all) and `sharded_ntt_batch` of two 2^6 polynomials: equal to the
  JAX package's `NTTPlan`, bit for bit;
- `ShardedGroth16Prover.prove(w, 7, 8)` on the chain circuit a == b^101
  (domain 128): equal to the port's single prover, and verifying; its
  `prove_batch([w, w], rs=[(7, 8), (9, 10)])` (sharded MSMs, one element
  at a time): equal to the single prover's proofs with the same r and s.

Without an address, `distributed.initialize()` returns False and the mesh
is one process."""

import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax.numpy as jnp

from keyless_zk_tpu.curves import jacobian as jjac
from keyless_zk_tpu.curves import ref_curve
from keyless_zk_tpu.ops import msm as jmsm
from keyless_zk_tpu.ops.ntt import get_plan
from keyless_zk_tpu_torch.curves.jacobian import G1_CURVE
from keyless_zk_tpu_torch.fields import torch_field as tf
from keyless_zk_tpu_torch.groth16 import Groth16Prover, from_jax_proving_key, verify_groth16
from keyless_zk_tpu_torch.parallel import distributed, make_mesh
from test_torch_batch_prover import chain_setup
from torch_fixtures import limbs_t, points_with_dlogs, rand_ints

import torch_parallel_worker

torch.set_num_threads(1)

WORLD = 2
DOMAIN_POW = 6


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the two ranks once; returns (inputs, [rank 0's, rank 1's
    outputs], the chain setup). The single prover's proof is computed here
    while the ranks run."""
    d = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(21)
    pts, _ = points_with_dlogs("fq", 64, rng)
    pts[9] = None
    sc = rand_ints(rng, 64)
    sc[3] = 0
    x, y, inf = G1_CURVE.encode_affine(pts)
    vals = rand_ints(rng, 3 << DOMAIN_POW)
    ntt_in = tf.encode_ints(vals[: 1 << DOMAIN_POW], tf.FR, mont=True)
    polys = tf.encode_ints(vals[1 << DOMAIN_POW :], tf.FR, mont=True).reshape(2, 1 << DOMAIN_POW, 16)
    res, wits, publics = chain_setup()
    pk = from_jax_proving_key(res.pk)
    inputs = {"msm": (x, y, inf, limbs_t(sc)), "ntt": (ntt_in, DOMAIN_POW), "polys": polys, "prover": (pk, wits[0])}
    torch.save(inputs, d / "inputs.pt")
    ctx = mp.spawn(torch_parallel_worker.run, args=(WORLD, _free_port(), str(d / "inputs.pt"), str(d / "out")),
                   nprocs=WORLD, join=False)
    port = Groth16Prover(pk, device="cpu")
    single = port.prove(wits[0], r=7, s=8).to_json_dict()
    single_9_10 = port.prove(wits[0], r=9, s=10).to_json_dict()
    while not ctx.join(timeout=600):
        pass
    outs = [torch.load(f"{d / 'out'}.{r}", weights_only=False) for r in range(WORLD)]
    return {"pts": pts, "sc": sc, "ntt": ntt_in, "polys": polys, "single": single, "single_9_10": single_9_10,
            "vk": res.vk, "public": publics[0]}, outs


def test_sharded_msm_matches_host_and_jax(ranks):
    case, outs = ranks
    want = ref_curve.G1.msm(case["sc"], case["pts"])
    jx, jy, jinf = jjac.G1_CURVE.encode_affine(case["pts"])
    j = jmsm.msm(jx, jy, jinf, jnp.asarray(limbs_t(case["sc"]).numpy().astype(np.uint32)), curve=jjac.G1_CURVE)
    assert jjac.G1_CURVE.decode_jacobian(jjac.JacPoint(*(c[None] for c in j)))[0] == want
    assert [o["msm"] for o in outs] == [want] * WORLD


def _jax(t):
    return jnp.asarray(t.numpy().astype(np.uint32))


def _same(j, t):
    return np.array_equal(np.asarray(j).astype(np.int64), t.numpy().astype(np.int64))


def test_four_step_ntt_matches_jax_plan(ranks):
    case, outs = ranks
    plan = get_plan(DOMAIN_POW)
    for o in outs:
        assert _same(plan.ntt(_jax(case["ntt"])), o["ntt"])
        assert _same(plan.intt(_jax(case["ntt"])), o["intt"])


def test_sharded_ntt_batch_matches_jax_plan(ranks):
    case, outs = ranks
    want = get_plan(DOMAIN_POW).ntt(_jax(case["polys"]))
    for o in outs:
        assert _same(want, o["ntt_batch"])


def test_sharded_prover_equals_single_prover(ranks):
    case, outs = ranks
    for o in outs:
        assert o["proof"] == case["single"]
    assert verify_groth16(case["vk"], case["public"], case["single"])
    assert [o["slice"] for o in outs] == [(0, 3), (3, 5)]


def test_sharded_prover_proves_a_batch(ranks):
    case, outs = ranks
    for o in outs:
        assert o["batch"] == [case["single"], case["single_9_10"]]


def test_single_process_fallback():
    assert distributed.initialize() is False  # no address configured
    mesh = distributed.global_mesh()
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None) and make_mesh() == mesh
    assert distributed.local_batch_slice(10) == (0, 10)
