"""One rank of tests/test_torch_parallel.py: joins a gloo group on
127.0.0.1 through the port's `distributed.initialize`, runs the sharded
kernels and the sharded prover (one proof and a batch) on the inputs the test wrote, and saves
what it computed. Imports the port only (no JAX)."""

import torch
import torch.distributed as dist

from keyless_zk_tpu_torch.curves.jacobian import G1_CURVE, JacPoint
from keyless_zk_tpu_torch.parallel import distributed, make_mesh, sharded_msm, sharded_ntt_batch
from keyless_zk_tpu_torch.parallel.sharded import four_step_ntt
from keyless_zk_tpu_torch.parallel.sharded_prover import ShardedGroth16Prover


def run(rank: int, world: int, port: int, inputs: str, outputs: str) -> None:
    torch.set_num_threads(1)
    assert distributed.initialize(f"tcp://127.0.0.1:{port}", world_size=world, rank=rank, device="cpu")
    try:
        case = torch.load(inputs, weights_only=False)
        mesh = make_mesh()
        assert (mesh.size, mesh.rank) == (world, rank)
        out = {"slice": distributed.local_batch_slice(5)}
        px, py, pinf, sc = case["msm"]
        pt = sharded_msm(px, py, pinf, sc, curve=G1_CURVE, mesh=mesh)
        out["msm"] = G1_CURVE.decode_jacobian(JacPoint(*(c[None] for c in pt)))[0]
        x, dp = case["ntt"]
        out["ntt"] = four_step_ntt(x, domain_pow=dp, mesh=mesh)
        out["intt"] = four_step_ntt(x, domain_pow=dp, mesh=mesh, inverse=True)
        out["ntt_batch"] = sharded_ntt_batch(case["polys"], domain_pow=dp, mesh=mesh)
        pk, wit = case["prover"]
        sharded = ShardedGroth16Prover(pk, mesh, device="cpu")
        out["proof"] = sharded.prove(wit, r=7, s=8).to_json_dict()
        out["batch"] = [p.to_json_dict() for p in sharded.prove_batch([wit, wit], rs=[(7, 8), (9, 10)])]
        torch.save(out, f"{outputs}.{rank}")
    finally:
        dist.destroy_process_group()
