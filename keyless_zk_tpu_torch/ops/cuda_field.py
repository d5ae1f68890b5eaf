"""K1: the batched Montgomery multiply and the batched Montgomery power,
their plain versions and their wrappers.

The kernels (csrc/mont_mul.cu) replace keyless_zk_tpu/ops/pallas_field.py
`mont_mul_pallas`, alone (`mont_mul`) and as the chain of products that
jax_field.mont_pow runs under one `lax.fori_loop` (`mont_pow`: the whole
square-and-multiply in one launch). Each wrapper dispatches on the
tensor's device and nothing else: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel or raises. fields/torch_field.mont_mul
arranges the operands first.
"""

from __future__ import annotations

import ctypes

import torch

from ..fields.limbs import NUM_LIMBS
from ..fields.torch_field import FR, FieldSpec, consts, mont_mul_limbs
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


def mont_pow_plain(a: torch.Tensor, e: int, spec: FieldSpec) -> torch.Tensor:
    """a^e with a in Montgomery form (output Montgomery) in plain torch: the
    MSB-first square-and-multiply of jax_field.mont_pow from the Montgomery
    one, one `mont_mul_plain` per step; a clear bit skips its product (the
    JAX loop computes it and discards it). e = 0 gives the Montgomery one."""
    nbits = max(e.bit_length(), 1)
    acc = consts(spec, spec.r_mod_p, a.shape[:-1], a.device).contiguous()
    for i in range(nbits):
        acc = mont_mul_plain(acc, acc, spec)
        if (e >> (nbits - 1 - i)) & 1:
            acc = mont_mul_plain(acc, a, spec)
    return acc


@_build.counted
def mont_pow(a: torch.Tensor, e: int, spec: FieldSpec) -> torch.Tensor:
    """a: (..., 16) int32 contiguous, Montgomery form; e: a host int,
    0 <= e < 2^256. The kernel runs the whole chain in one launch."""
    if a.device.type == "cpu":
        return mont_pow_plain(a, e, spec)
    if a.dtype != torch.int32:
        raise TypeError("mont_pow: limb tensors must be int32")
    if a.device.type != "cuda":
        raise ValueError(f"mont_pow: tensor on {a.device}")
    if not a.is_contiguous() or a.data_ptr() % 16:
        raise ValueError("mont_pow: the operand must be contiguous and start on a 16-byte boundary")
    if a.shape[-1] != NUM_LIMBS:
        raise ValueError("mont_pow: last dim must be 16 limbs")
    if not 0 <= e < 1 << 256:
        raise ValueError("mont_pow: the exponent must lie in [0, 2^256)")
    words = (ctypes.c_uint32 * 8)(*((e >> (32 * k)) & 0xFFFFFFFF for k in range(8)))
    out = torch.empty_like(a)
    lib = _build.library()
    mont_pow.launches += 1
    err = lib.kzk_mont_pow(
        a.data_ptr(), out.data_ptr(), a.numel() // NUM_LIMBS, words, max(e.bit_length(), 1),
        0 if spec == FR else 1, torch.cuda.current_stream(a.device).cuda_stream,
    )
    _build.check(err, "mont_pow")
    return out
