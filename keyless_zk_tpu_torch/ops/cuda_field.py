"""K1: the batched Montgomery multiply, its plain version and its wrapper.

The kernel (csrc/mont_mul.cu) replaces keyless_zk_tpu/ops/pallas_field.py
`mont_mul_pallas`. `mont_mul` dispatches on the tensor's device and nothing
else: a CPU tensor takes `mont_mul_plain`, a CUDA tensor launches the kernel
or raises. fields/torch_field.mont_mul arranges the operands first.
"""

from __future__ import annotations

import torch

from ..fields.limbs import NUM_LIMBS
from ..fields.torch_field import FR, FieldSpec, mont_mul_limbs
from . import _build


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """a*b*R^-1 mod p in plain torch: the port of jax_field._mont_mul_xla
    (full 16x16-limb product, normalize, REDC). Broadcasts like torch."""
    return mont_mul_limbs(a, b, spec)


@_build.counted
def mont_mul(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """a: (..., 16) int32 contiguous; b: (..., 16) int32 contiguous whose rows
    repeat over a's leading rows (b's shape is a suffix of a's)."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mont_mul_plain(a, b, spec)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"mont_mul: tensors on {a.device} and {b.device}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError("mont_mul: limb tensors must be int32")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("mont_mul: operands must be contiguous")
    if a.shape[-1] != NUM_LIMBS or b.shape[-1] != NUM_LIMBS:
        raise ValueError("mont_mul: last dim must be 16 limbs")
    n = a.numel() // NUM_LIMBS
    nb = b.numel() // NUM_LIMBS
    if tuple(a.shape[a.dim() - b.dim():]) != tuple(b.shape) or nb == 0 or n % nb:
        raise ValueError(f"mont_mul: b {tuple(b.shape)} does not repeat over a {tuple(a.shape)}")
    out = torch.empty_like(a)
    lib = _build.library()
    mont_mul.launches += 1
    err = lib.kzk_mont_mul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), n, nb, 0 if spec == FR else 1,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    _build.check(err, "mont_mul")
    return out
