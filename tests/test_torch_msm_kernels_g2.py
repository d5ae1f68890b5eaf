"""G2 halves of test_torch_msm_kernels.py: the port's plain scan (K4) and
Horner sum (K7) against their JAX contracts, bit for bit. The G2 boundary
merge (K5) and bucket reduction (K6) sit in files of their own: compiling
their JAX contracts takes about a minute each on XLA:CPU, and the test
runner spreads files, not tests, over its workers."""

import torch

from test_torch_msm_kernels import check_horner_total, check_window_scan

torch.set_num_threads(1)


def test_window_scan_matches_contract_g2():
    check_window_scan("fq2")


def test_horner_total_matches_contract_g2():
    check_horner_total("fq2")
