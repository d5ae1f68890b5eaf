"""The port's MSM dispatcher on G2 against the discrete-log oracle (see
test_torch_msm.py for the method): the direct path, and the Pippenger in
dense and compacted modes across the 128 < n < 400 range where the JAX
package's fused path asserts."""

import pytest
import torch

from test_torch_msm import _case, _oracle, _run

torch.set_num_threads(1)


@pytest.mark.parametrize("n,mode", [
    (100, "dense"), (129, "sparse"), (200, "dense"), (256, "sparse"), (1000, "sparse"), (2065, "sparse"),
])
def test_msm_g2_matches_oracle(n, mode):
    pts, dlogs, sc = _case("fq2", n, mode, n)
    assert _run("fq2", pts, sc) == _oracle("fq2", dlogs, sc)
