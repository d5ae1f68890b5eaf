"""The port's plain G2 boundary merge (K5) against its JAX contract,
msm_sim.boundary_merge, as affine points (see test_torch_msm_kernels.py)."""

import pytest
import torch

from test_torch_msm_kernels import check_boundary_merge

torch.set_num_threads(1)


def test_boundary_merge_matches_contract_g2(monkeypatch):
    check_boundary_merge("fq2", 4, "mixed", monkeypatch)


@pytest.mark.parametrize("tile,pattern", [(8, "mixed"), (4, "one")])
def test_boundary_merge_tiles_g2(tile, pattern, monkeypatch):
    check_boundary_merge("fq2", tile, pattern, monkeypatch)
