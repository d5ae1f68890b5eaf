"""K8: the matmul NTT's lazy Montgomery reduction, its plain versions and
its wrappers.

The kernel (csrc/redc.cu) replaces keyless_zk_tpu/ops/pallas_redc.py
`redc_pallas` with both of its bodies: `redc` the plain reduction
(`_redc_kernel`), `redc_twiddle` the reduction followed by a Montgomery
product with a twiddle (`_redc_tw_kernel`). Each dispatches on its tensors'
device only: a CPU tensor takes the plain version, a CUDA tensor launches
the kernel or raises.

Layout at this boundary: `wide` is (63, N) int32, row k holding byte column
k of each element's accumulator T = sum_k wide[k] * 2^(8k) (each entry in
[0, 2^28), so T < 2^524), which is the int8 product's own output read as
(63, r * cb); twiddles and results are (N, 16) int32 rows of 16-bit limbs.

The reduction divides by 2^320, not by the Montgomery radix 2^256: T can
reach 128 * r^2 > r * 2^256, and the DFT matrix is pre-scaled by 2^64 so
that the Montgomery form survives (keyless_zk_tpu/ops/mxu_ntt.py:44-48).
"""

from __future__ import annotations

import torch

from ..fields.limbs import NUM_LIMBS
from ..fields.torch_field import FR, _csub_rows
from . import _build
from .cuda_field import mont_mul_plain

NB = 32  # byte planes per 256-bit element
WIDE_COLS = 2 * NB - 1  # byte columns of a byte-plane product
RED_BITS = 320
RED_BYTES = RED_BITS // 8  # 40
T_BYTES = 66  # bytes of T, with a carry margin

P_INT = FR.p
MU = (-pow(P_INT, -1, 1 << RED_BITS)) % (1 << RED_BITS)  # -r^-1 mod 2^320
P_BYTES = [(P_INT >> (8 * i)) & 0xFF for i in range(NB)]
MU_BYTES = [(MU >> (8 * i)) & 0xFF for i in range(RED_BYTES)]


def _ripple8(cols: torch.Tensor) -> torch.Tensor:
    """(k, n) int64 byte-weighted columns -> canonical bytes mod 2^(8k)."""
    out = torch.empty_like(cols)
    c = 0
    for i in range(cols.shape[0]):
        v = cols[i] + c
        out[i] = v & 0xFF
        c = v >> 8
    return out


def redc_columns(wide: torch.Tensor) -> torch.Tensor:
    """(63, N) byte columns of T -> (N, 16) int32 canonical limbs of
    T * 2^-320 mod r: the plain version of K8, a port of
    keyless_zk_tpu/ops/mxu_ntt.py `redc_columns` (its byte pipeline), held
    limb-major."""
    w = wide.long()
    n = w.shape[1]
    dev = w.device
    # 1. the canonical bytes of T
    tb = _ripple8(torch.cat([w, torch.zeros((T_BYTES - WIDE_COLS, n), dtype=torch.int64, device=dev)]))
    # 2. m = (T mod 2^320) * mu mod 2^320
    mu = torch.tensor(MU_BYTES, dtype=torch.int64, device=dev)[:, None]
    mcols = torch.zeros((RED_BYTES, n), dtype=torch.int64, device=dev)
    for i in range(RED_BYTES):
        mcols[i:] += tb[i] * mu[: RED_BYTES - i]
    mb = _ripple8(mcols)
    # 3. S = T + m*r; S mod 2^320 == 0 and S / 2^320 < 2r
    p = torch.tensor(P_BYTES, dtype=torch.int64, device=dev)[:, None]
    s = torch.zeros((max(T_BYTES, RED_BYTES + NB) + 1, n), dtype=torch.int64, device=dev)
    s[:T_BYTES] = tb
    for i in range(RED_BYTES):
        s[i : i + NB] += mb[i] * p
    res = _ripple8(s)[RED_BYTES : RED_BYTES + NB]
    limbs = res[0::2] | (res[1::2] << 8)  # (16, N) 16-bit limbs
    return _csub_rows(limbs, FR).T.contiguous().int()


def redc_twiddle_plain(wide: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """redc_columns, then the Montgomery product with tw (N, 16)."""
    return mont_mul_plain(redc_columns(wide), tw, FR)


def _check(name: str, wide: torch.Tensor, tw: torch.Tensor | None) -> None:
    tensors = [wide] if tw is None else [wide, tw]
    for t in tensors:
        if t.device.type != "cuda" or t.device != wide.device:
            raise ValueError(f"{name}: all tensors must be on one CUDA device, got {t.device}")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"{name}: tensors must be contiguous int32")
    if wide.dim() != 2 or wide.shape[0] != WIDE_COLS:
        raise ValueError(f"{name}: wide must be ({WIDE_COLS}, N), got {tuple(wide.shape)}")
    if tw is not None and tw.shape != (wide.shape[1], NUM_LIMBS):
        raise ValueError(f"{name}: tw must be ({wide.shape[1]}, {NUM_LIMBS}), got {tuple(tw.shape)}")


def _launch(wide: torch.Tensor, tw: torch.Tensor | None) -> torch.Tensor:
    n = wide.shape[1]
    out = torch.empty((n, NUM_LIMBS), dtype=torch.int32, device=wide.device)
    err = _build.library().kzk_redc(
        wide.data_ptr(), None if tw is None else tw.data_ptr(), out.data_ptr(), n,
        torch.cuda.current_stream(wide.device).cuda_stream,
    )
    _build.check(err, "redc")
    return out


@_build.counted
def redc(wide: torch.Tensor) -> torch.Tensor:
    """(63, N) int32 byte columns -> (N, 16) int32, T * 2^-320 mod r."""
    if wide.device.type == "cpu":
        return redc_columns(wide)
    _check("redc", wide, None)
    redc.launches += 1
    return _launch(wide, None)


@_build.counted
def redc_twiddle(wide: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """(63, N) int32 byte columns, (N, 16) int32 Montgomery twiddles ->
    (N, 16) int32, (T * 2^-320 mod r) * tw * 2^-256 mod r."""
    if wide.device.type == "cpu" and tw.device.type == "cpu":
        return redc_twiddle_plain(wide, tw)
    _check("redc_twiddle", wide, tw)
    redc_twiddle.launches += 1
    return _launch(wide, tw)
