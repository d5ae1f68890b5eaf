"""The port's plain G2 boundary merge (K5) against its JAX contract,
msm_sim.boundary_merge, bit for bit (see test_torch_msm_kernels.py)."""

import torch

from test_torch_msm_kernels import check_boundary_merge

torch.set_num_threads(1)


def test_boundary_merge_matches_contract_g2():
    check_boundary_merge("fq2")
