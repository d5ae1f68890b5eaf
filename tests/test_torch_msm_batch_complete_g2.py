"""G2 case of tests/test_torch_msm_complete.py for `msm_batch(...,
assume_distinct=False)`: B = 2 scalar vectors at n = 129 over a table with
duplicate points, against the JAX package's msm_batch (one XLA Pippenger
per element on the CPU, the longest part of this file)."""

import torch

from test_torch_msm_complete import check_msm_complete

torch.set_num_threads(1)


def test_msm_batch_complete_g2_matches_jax(monkeypatch):
    check_msm_complete("fq2", 129, 2, monkeypatch)
