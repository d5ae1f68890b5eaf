"""The matmul NTT's 128 x tail class at 2^10 (a radix-128 pass, then a
radix-8 pass without twiddles) against the JAX package's plan and the
port's butterfly plan; see test_torch_mxu_ntt.py."""

import torch

from test_torch_mxu_ntt import check_transforms

torch.set_num_threads(1)


def test_transforms_match_jax_and_butterfly_128x8():
    check_transforms(10)
