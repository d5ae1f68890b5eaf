"""G2 cases of tests/test_torch_msm_complete.py: the port's
`msm(..., assume_distinct=False)` at n = 129 (its flat-stream Pippenger,
the JAX package's XLA Pippenger on the CPU) on a table with duplicate
points, and the complete scan's plain version against the JAX contract on
a planted stream."""

import pytest
import torch

from test_torch_msm_complete import check_msm_complete, check_scan_contract

torch.set_num_threads(1)


def test_msm_complete_g2_matches_jax(monkeypatch):
    check_msm_complete("fq2", 129, 1, monkeypatch)


@pytest.mark.parametrize("assume_distinct", [True, False], ids=["distinct_law", "complete_law"])
def test_scan_plain_matches_contract_planted_g2(assume_distinct):
    check_scan_contract("fq2", assume_distinct)
