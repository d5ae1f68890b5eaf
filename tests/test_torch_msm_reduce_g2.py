"""The port's plain G2 bucket reduction (K6) against its JAX contract,
msm_sim.weighted_bucket_total, as affine points, and against the
discrete-log oracle (see test_torch_msm_kernels.py)."""

import pytest
import torch

from test_torch_msm_kernels import check_weighted_bucket_total

torch.set_num_threads(1)


def test_weighted_bucket_total_matches_contract_g2():
    check_weighted_bucket_total("fq2")


@pytest.mark.parametrize("lanes,sum_threads", [(1, None), (8, 2)])
def test_weighted_bucket_total_lane_schedules_g2(lanes, sum_threads, monkeypatch):
    check_weighted_bucket_total("fq2", lanes, sum_threads, monkeypatch)
