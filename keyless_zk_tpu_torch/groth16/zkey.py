"""Groth16 proving key: host numpy tables (the dataclasses of
keyless_zk_tpu/groth16/zkey.py, without its file parser).

Point tables are Montgomery-form 16-bit limb arrays, as the JAX package
holds them; the prover uploads them to its device. `from_jax_proving_key`
converts a JAX-package key (reading its attributes only, so this module
imports no JAX) so that both packages prove under the same key.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class G1Table:
    """(n, 16) uint32 Montgomery limb arrays + infinity mask (host numpy)."""

    x: np.ndarray
    y: np.ndarray
    inf: np.ndarray


@dataclass
class G2Table:
    """(n, 2, 16) uint32 Montgomery limb arrays + infinity mask."""

    x: np.ndarray
    y: np.ndarray
    inf: np.ndarray


@dataclass
class ProvingKey:
    n8q: int
    n8r: int
    q: int
    r: int
    n_vars: int
    n_public: int
    domain_size: int
    n_coefs: int
    # vk points as standard-form host ints
    vk_alpha1: tuple
    vk_beta1: tuple
    vk_beta2: tuple
    vk_gamma2: tuple
    vk_delta1: tuple
    vk_delta2: tuple
    # coefficient table
    coef_m: np.ndarray  # (nCoefs,) uint32, 0 -> a, 1 -> b
    coef_c: np.ndarray  # (nCoefs,) uint32 destination index in the domain
    coef_s: np.ndarray  # (nCoefs,) uint32 source witness index
    coef_val: np.ndarray  # (nCoefs, 16) uint32, raw Montgomery-form limbs
    points_a: G1Table
    points_b1: G1Table
    points_b2: G2Table
    points_c: G1Table
    points_h: G1Table
    vk_ic: tuple = ()


def from_jax_proving_key(pk) -> ProvingKey:
    """A keyless_zk_tpu.groth16.zkey.ProvingKey -> this package's key."""

    def g1(t):
        return G1Table(np.asarray(t.x, np.uint32), np.asarray(t.y, np.uint32), np.asarray(t.inf, bool))

    def g2(t):
        return G2Table(np.asarray(t.x, np.uint32), np.asarray(t.y, np.uint32), np.asarray(t.inf, bool))

    return ProvingKey(
        n8q=pk.n8q, n8r=pk.n8r, q=pk.q, r=pk.r,
        n_vars=pk.n_vars, n_public=pk.n_public, domain_size=pk.domain_size, n_coefs=pk.n_coefs,
        vk_alpha1=pk.vk_alpha1, vk_beta1=pk.vk_beta1, vk_beta2=pk.vk_beta2,
        vk_gamma2=pk.vk_gamma2, vk_delta1=pk.vk_delta1, vk_delta2=pk.vk_delta2,
        coef_m=np.asarray(pk.coef_m, np.uint32), coef_c=np.asarray(pk.coef_c, np.uint32),
        coef_s=np.asarray(pk.coef_s, np.uint32), coef_val=np.asarray(pk.coef_val, np.uint32),
        points_a=g1(pk.points_a), points_b1=g1(pk.points_b1), points_b2=g2(pk.points_b2),
        points_c=g1(pk.points_c), points_h=g1(pk.points_h),
        vk_ic=tuple(pk.vk_ic),
    )
