"""Number-theoretic transform over BN254 Fr (PyTorch): the butterfly plan.

Port of keyless_zk_tpu/ops/ntt.py `NTTPlan`: iterative
decimation-in-frequency levels of whole-array adds, subs and twiddle
products, then one bit-reversal gather. The convention matches the JAX
package (and the reference, fft.cpp): ``ntt(x)[k] = sum_j x[j] w^(jk)``
with w = nqr^((r-1)/2^s); ``intt`` uses w^-1 and scales by n^-1; the
Groth16 coset shift multiplies by powers of the 2^(s+1)-th root.

The twiddle products go through fields/torch_field.mont_mul (kernel K1 on
the card). There is no on-disk plan cache: the tables are built on the
plan's device at construction, by log-doubling geometric products.

All values are Fr in Montgomery form, shape (..., n, 16) int32.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as devices
from ..fields import bn254
from ..fields import torch_field as tf
from ..fields.torch_field import FR


def _bit_reverse_perm(domain_pow: int) -> np.ndarray:
    n = 1 << domain_pow
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros_like(idx)
    for b in range(domain_pow):
        rev |= ((idx >> b) & 1) << (domain_pow - 1 - b)
    return rev.astype(np.int64)


def geometric_powers(base_mont: torch.Tensor, n: int) -> torch.Tensor:
    """[1, g, g^2, ..., g^(n-1)] in Montgomery form, built by log-doubling."""
    assert n & (n - 1) == 0
    pows = tf.encode_ints([FR.r_mod_p], FR, device=base_mont.device)  # mont(1)
    cur = base_mont.reshape(1, 16)
    while pows.shape[0] < n:
        pows = torch.cat([pows, tf.mont_mul(pows, cur, FR)])
        cur = tf.mont_mul(cur, cur, FR)
    return pows


class NTTPlan:
    """Twiddle tables for one 2^domain_pow domain, resident on `device`
    (the card unless the caller asks for the CPU)."""

    def __init__(self, domain_pow: int, device=devices.DEFAULT):
        if domain_pow > bn254.TWO_ADICITY:
            raise ValueError("domain size too big for the curve")  # fft.cpp:80-83
        self.domain_pow = domain_pow
        self.n = 1 << domain_pow
        self.device = devices.resolve(device)
        w = bn254.fr_root_of_unity(domain_pow)
        self.n_inv_mont = tf.encode_ints([pow(self.n, -1, FR.p)], FR, mont=True, device=self.device)[0]
        # level d needs (w^(2^d))^c for c < n / 2^(d+1)
        self.twiddles = self._build(w)
        self.twiddles_inv = self._build(pow(w, -1, FR.p))
        self.perm = torch.from_numpy(_bit_reverse_perm(domain_pow)).to(self.device)
        self._coset = None

    def _build(self, w: int) -> list[torch.Tensor]:
        tables = []
        for d in range(self.domain_pow):
            base = tf.encode_ints([pow(w, 1 << d, FR.p)], FR, mont=True, device=self.device)[0]
            tables.append(geometric_powers(base, self.n >> (d + 1)))
        return tables

    def _transform(self, x: torch.Tensor, tables) -> torch.Tensor:
        """DIF butterflies + bit-reversal gather; x shape (..., n, 16)."""
        batch = x.shape[:-2]
        n = self.n
        for d, tw in enumerate(tables):
            half = n >> (d + 1)
            v = x.reshape(*batch, 1 << d, 2, half, 16)
            e = v[..., 0, :, :]
            o = v[..., 1, :, :]
            lo = tf.add(e, o, FR)
            hi = tf.mont_mul(tf.sub(e, o, FR), tw, FR)
            x = torch.stack([lo, hi], dim=-3).reshape(*batch, n, 16)
        return x.index_select(-2, self.perm)

    def ntt(self, x: torch.Tensor) -> torch.Tensor:
        return self._transform(x, self.twiddles)

    def intt(self, x: torch.Tensor) -> torch.Tensor:
        return tf.mont_mul(self._transform(x, self.twiddles_inv), self.n_inv_mont, FR)

    def coset_powers(self) -> torch.Tensor:
        """eta^i for i < n, eta the 2^(domain_pow+1)-th root of unity: the
        shift between iNTT and NTT (groth16.cpp:182-190). Memoized."""
        if self._coset is None:
            eta = bn254.fr_root_of_unity(self.domain_pow + 1)
            base = tf.encode_ints([eta], FR, mont=True, device=self.device)[0]
            self._coset = geometric_powers(base, self.n)
        return self._coset
