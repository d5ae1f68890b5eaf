"""Matmul NTT over BN254 Fr (PyTorch): port of keyless_zk_tpu/ops/mxu_ntt.py.

The transform is the JAX package's, value for value: a mixed-radix
decimation-in-frequency chain with radix 128 (n = 128^a * tail), each pass
a DFT_r along one axis, then the inter-pass twiddles and one digit-reverse
gather. A pass is one int8 matrix product: the inputs' 32 byte planes
against the banded byte-plane matrix W_BIG[k*r + q, j*r + s] =
byte_{k-j}(W[q, s]) (W the Montgomery DFT matrix, pre-scaled by 2^64), so
output row (k, q) holds byte column k of T_q = sum_s W[q, s] x_s; then one
lazy reduction per output element, T * 2^-320 mod r (see ops/cuda_redc.py).
128 products share one reduction, where the butterfly plan (ops/ntt.py)
reduces every product.

In the port:

- the product is `torch._int_mm` (int8 x int8 -> int32, exact: each output
  sums at most 32 * 128 byte products, < 2^28), a library call where the
  JAX package left its `dot_general` to XLA. Its operands are W_BIG
  row-major and the byte planes column-major (each DFT column's 32 * r
  bytes contiguous), the layout the CUDA int8 GEMM takes; the column count
  is padded to a multiple of 8 for it;
- the +-128 offsets of the int8 operands are undone by two in-place adds
  of the row and column sums (plain torch);
- the reduction is kernel K8 (ops/cuda_redc.py), fused with the twiddle
  product on every pass that has one (`redc_twiddle`), plain on the last
  (`redc`). The values equal the JAX package's, whose twiddle product runs
  after its reduction: it is the same Montgomery product.

`_CHUNK`, the DFT columns per product, is sized for the H100's 80 GB: at
2^21 the batched (3, n) transform has 49,152 columns per pass, whose int32
accumulator is 8064 * 4 bytes = 32 KB per column, 1.6 GB in all. One chunk
of 2^16 columns takes a whole pass (the JAX package's 4096 was sized for
TPU memory).

Tables are built on the plan's device (twiddle rows by the port's
`mont_mul`, K1 on the card). There is no on-disk plan cache.

All values are Fr in Montgomery form, shape (..., n, 16) int32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import device as devices
from ..fields import bn254
from ..fields import torch_field as tf
from ..fields.limbs import NUM_LIMBS, ints_to_limbs
from ..fields.torch_field import FR
from . import cuda_redc
from .cuda_redc import NB, P_INT, WIDE_COLS
from .ntt import geometric_powers

SCALE = (1 << 64) % P_INT  # the DFT matrix's pre-scale (see cuda_redc)

_CHUNK = 1 << 16  # DFT columns per int8 product


def factorize(n: int) -> list[int]:
    """n = prod(factors), greedy radix-128 then the power-of-two tail."""
    fs = []
    while n >= 128:
        fs.append(128)
        n //= 128
    if n > 1:
        fs.append(n)
    return fs


def digit_reverse_perm(factors: list[int]) -> np.ndarray:
    """Output index permutation for the DIF pass chain: pass q-digits are
    stored big-endian but the true frequency index reads them little-endian."""
    n = int(np.prod(factors))
    idx = np.arange(n)
    digits = []
    rest = idx
    block = n
    for f in factors:  # storage digits, most-significant first
        block //= f
        digits.append(rest // block)
        rest = rest % block
    true = np.zeros_like(idx)
    mult = 1
    for f, d in zip(factors, digits):
        true = true + d * mult
        mult *= f
    out = np.zeros_like(idx)
    out[true] = idx
    return out


def _dft_matrix_mont(r: int, w_r: int) -> np.ndarray:
    """(r, r, 16) uint32: W[q, s] = mont(w_r^(q*s)) * 2^64."""
    vals = [pow(w_r, q * s, P_INT) * FR.r_mod_p % P_INT * SCALE % P_INT for q in range(r) for s in range(r)]
    return ints_to_limbs(vals).reshape(r, r, NUM_LIMBS)


def _to_byte_planes(x: torch.Tensor) -> torch.Tensor:
    """(..., 16) 16-bit limbs -> (..., 32) int32 byte values 0..255."""
    return torch.stack([x & 0xFF, x >> 8], dim=-1).reshape(*x.shape[:-1], NB).int()


def _dft_mod_chunk(w_big, w_rowsum, x: torch.Tensor, tw: torch.Tensor | None) -> torch.Tensor:
    """DFT_r over one chunk: x (cb, r, 16) Montgomery -> (cb, r, 16), each
    output times its twiddle tw (r, cb, 16) when given."""
    cb, r, _ = x.shape
    pad = -cb % 8
    # column c of the right operand: row j*r + s holds byte j of x[c, s]
    planes = _to_byte_planes(x).transpose(1, 2).reshape(cb, NB * r)
    if pad:  # zero bytes: their wide columns come out exactly 0
        planes = F.pad(planes, (0, 0, 0, pad))
    colsum = planes.sum(1, dtype=torch.int32)
    d = torch._int_mm(w_big, (planes - 128).to(torch.int8).t())  # (63r, cb + pad)
    # undo the offsets (A = A' + 128, B = B' + 128): AB = A'B' + 128 rowsum(A')
    # + 128 colsum(B), the two 128^2 K terms cancelling
    d.add_(128 * w_rowsum[:, None]).add_(128 * colsum[None, :])
    wide = d.view(WIDE_COLS, r * (cb + pad))  # element q * (cb + pad) + c
    if tw is None:
        out = cuda_redc.redc(wide)
    else:
        if pad:
            tw = F.pad(tw, (0, 0, 0, pad))
        out = cuda_redc.redc_twiddle(wide, tw.reshape(r * (cb + pad), NUM_LIMBS))
    return out.view(r, cb + pad, NUM_LIMBS)[:, :cb].transpose(0, 1)


def _dft_mod(w_big, w_rowsum, x: torch.Tensor, tw: torch.Tensor | None, m: int) -> torch.Tensor:
    """DFT_r along axis 1 of x ((rows, r, 16), row = (block, t) with t < m)
    in _CHUNK-row slices; the output at (row, q) is multiplied by tw[q, t]
    when tw (r, m, 16) is given."""
    rows, r, _ = x.shape
    out = torch.empty_like(x)
    for c0 in range(0, rows, _CHUNK):
        c1 = min(rows, c0 + _CHUNK)
        twc = None
        if tw is not None:
            t = torch.arange(c0, c1, device=x.device) % m
            twc = tw.index_select(1, t)
        out[c0:c1] = _dft_mod_chunk(w_big, w_rowsum, x[c0:c1], twc)
    return out


def _transform(x: torch.Tensor, perm: torch.Tensor, factors: list[int], tables) -> torch.Tensor:
    """Mixed-radix DIF pass chain + digit-reverse gather; x (..., n, 16)."""
    batch = x.shape[:-2]
    n = x.shape[-2]
    b = 1
    m_rest = n
    for (w_big, w_rowsum, tw), r in zip(tables, factors):
        m = m_rest // r
        v = x.reshape(*batch, b, r, m, NUM_LIMBS).movedim(-2, -3)  # (..., b, m, r, 16)
        g = _dft_mod(w_big, w_rowsum, v.reshape(-1, r, NUM_LIMBS), tw, m)
        g = g.reshape(*batch, b, m, r, NUM_LIMBS).movedim(-2, -3)  # (..., b, r, m, 16)
        x = g.reshape(*batch, n, NUM_LIMBS)
        b *= r
        m_rest = m
    return x.index_select(-2, perm)


class MxuNTTPlan:
    """The matmul NTT for one 2^domain_pow domain, tables resident on
    `device` (the card unless the caller asks for the CPU); the same
    interface as ops.ntt.NTTPlan."""

    def __init__(self, domain_pow: int, device=devices.DEFAULT):
        if domain_pow > bn254.TWO_ADICITY:
            raise ValueError("domain size too big for the curve")
        self.domain_pow = domain_pow
        self.n = 1 << domain_pow
        self.device = devices.resolve(device)
        self.factors = factorize(self.n)
        w = bn254.fr_root_of_unity(domain_pow)
        self.n_inv_mont = tf.encode_ints([pow(self.n, -1, P_INT)], FR, mont=True, device=self.device)[0]
        self.perm = torch.from_numpy(digit_reverse_perm(self.factors)).to(self.device)
        self._coset = None
        self.tables = self._build(w)
        self.tables_inv = self._build(pow(w, -1, P_INT))

    def _build(self, w: int):
        """Per pass: (W_BIG int8 (63r, 32r), its row sums int32 (63r,),
        twiddles (r, m, 16) or None)."""
        dev = self.device
        passes = []
        m_rest = self.n
        for r in self.factors:
            m = m_rest // r
            w_block = pow(w, self.n // m_rest, P_INT)  # primitive (r*m)-th root
            wmat = _dft_matrix_mont(r, pow(w_block, m, P_INT)).astype(np.int64)
            wb = np.stack([wmat & 0xFF, wmat >> 8], axis=-1).reshape(r, r, NB).transpose(2, 0, 1)
            wbig = np.zeros((WIDE_COLS, r, NB, r), dtype=np.int16)
            for k in range(WIDE_COLS):
                for j in range(max(0, k - NB + 1), min(NB, k + 1)):
                    wbig[k, :, j, :] = wb[k - j]
            wbig = wbig.reshape(WIDE_COLS * r, NB * r) - 128
            w_big = torch.from_numpy(wbig.astype(np.int8)).to(dev)
            w_rowsum = torch.from_numpy(wbig.astype(np.int64).sum(axis=1).astype(np.int32)).to(dev)
            tw = None
            if m > 1:  # w_block^(q*t), q < r, t < m
                base = geometric_powers(tf.encode_ints([w_block], FR, mont=True, device=dev)[0], m)
                rows = [tf.encode_ints([1] * m, FR, mont=True, device=dev)]
                cur = base
                for _ in range(1, r):
                    rows.append(cur)
                    cur = tf.mont_mul(cur, base, FR)
                tw = torch.stack(rows)
            passes.append((w_big, w_rowsum, tw))
            m_rest = m
        return passes

    def ntt(self, x: torch.Tensor) -> torch.Tensor:
        return _transform(x, self.perm, self.factors, self.tables)

    def intt(self, x: torch.Tensor) -> torch.Tensor:
        return tf.mont_mul(_transform(x, self.perm, self.factors, self.tables_inv), self.n_inv_mont, FR)

    def coset_powers(self) -> torch.Tensor:
        """eta^i for i < n, eta the 2^(domain_pow+1)-th root of unity. Memoized."""
        if self._coset is None:
            eta = bn254.fr_root_of_unity(self.domain_pow + 1)
            self._coset = geometric_powers(tf.encode_ints([eta], FR, mont=True, device=self.device)[0], self.n)
        return self._coset


@functools.lru_cache(maxsize=4)
def get_mxu_plan(domain_pow: int, device=devices.DEFAULT) -> MxuNTTPlan:
    return MxuNTTPlan(domain_pow, device)
