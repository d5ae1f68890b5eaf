"""Batched and multi-process proving (PyTorch port of keyless_zk_tpu.parallel):
the batch prover, and the sharded MSM and NTTs over a torch.distributed
process group (NCCL between cards, gloo on the CPU)."""

from .sharded import make_mesh, sharded_msm, sharded_ntt_batch

__all__ = ["make_mesh", "sharded_msm", "sharded_ntt_batch"]
