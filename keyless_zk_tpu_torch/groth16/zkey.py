"""Groth16 proving key (.zkey): host numpy tables, and the snarkjs file
reader and writer.

Layout per the reference's reader (rust-rapidsnark/rapidsnark/src/
zkey_utils.hpp:48-88 and fullprover.cpp:164-174):

  section 1: u32 protocol (1 = groth16)
  section 2: n8q, q, n8r, r, nVars, nPublic, domainSize,
             vk_alpha1 (G1), vk_beta1 (G1), vk_beta2 (G2),
             vk_gamma2 (G2), vk_delta1 (G1), vk_delta2 (G2)
  section 3: IC points (nPublic + 1 G1; empty when the vk is kept apart)
  section 4: u32 nCoefs, then nCoefs x { u32 m, u32 c, u32 s, Fr coef }
  section 5: pointsA   (nVars G1)
  section 6: pointsB1  (nVars G1)
  section 7: pointsB2  (nVars G2)
  section 8: pointsC   (nVars - nPublic - 1 G1)
  section 9: pointsH   (domainSize G1)

Field elements are 32-byte little-endian Montgomery-form integers
(R = 2^256), byte-compatible with the 16-bit limb encoding
(fields/limbs.py), so the point tables load with no bigint work; the
prover uploads them to its device. G1 affine = (x, y); G2 affine =
(x0, x1, y0, y1); the point at infinity is stored as all-zero coordinates.

A jax-free copy of keyless_zk_tpu/groth16/zkey.py: its writer packs section
4 and the point sections as numpy records (the bytes the JAX writer makes,
without its loop over coefficients), and its reader keeps no cache of
the limb tables: for the full keyless key (2.46 GB) such a cache (4.41 GB)
reloaded in 7.0 s where the parse takes 5.5 s, on an H100 machine's host
(PERF.md). `from_jax_proving_key` converts a JAX-package key (reading its
attributes only) so that both packages prove under the same key.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from ..fields.limbs import bytes_le_to_limbs
from .binfile import BinFile, le_bytes_to_int


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
    # IC points (section 3): n_public + 1 G1 points, standard-form host
    # ints; with them the snarkjs vk is recoverable from the zkey alone
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


# ---- the .zkey reader ---------------------------------------------------------

def _parse_g1_table(buf: np.ndarray, n8q: int) -> G1Table:
    rec = 2 * n8q
    n = buf.size // rec
    limbs = bytes_le_to_limbs(buf[: n * rec], n8q).reshape(n, 2, 16)
    x, y = limbs[:, 0], limbs[:, 1]
    inf = ~(np.any(x != 0, axis=-1) | np.any(y != 0, axis=-1))
    return G1Table(x=x, y=y, inf=inf)


def _parse_g2_table(buf: np.ndarray, n8q: int) -> G2Table:
    rec = 4 * n8q
    n = buf.size // rec
    limbs = bytes_le_to_limbs(buf[: n * rec], n8q).reshape(n, 4, 16)
    x = limbs[:, 0:2]  # (n, 2, 16): c0, c1
    y = limbs[:, 2:4]
    inf = ~(np.any(x != 0, axis=(-1, -2)) | np.any(y != 0, axis=(-1, -2)))
    return G2Table(x=x, y=y, inf=inf)


def _g1_std(buf: np.ndarray, n8q: int, q: int) -> tuple | None:
    """One stored G1 point -> standard-form (x, y) ints (None for inf)."""
    r_inv = pow(1 << (8 * n8q), -1, q)
    x = le_bytes_to_int(buf[:n8q]) * r_inv % q
    y = le_bytes_to_int(buf[n8q : 2 * n8q]) * r_inv % q
    return None if x == 0 and y == 0 else (x, y)


def _g2_std(buf: np.ndarray, n8q: int, q: int) -> tuple:
    r_inv = pow(1 << (8 * n8q), -1, q)
    c = [le_bytes_to_int(buf[i * n8q : (i + 1) * n8q]) * r_inv % q for i in range(4)]
    return ((c[0], c[1]), (c[2], c[3]))


def load_zkey(path: str) -> ProvingKey:
    """Parse a snarkjs zkey into limb-format host tables. Every section is
    converted with whole-array numpy operations; nothing is written."""
    bf = BinFile.load(path, "zkey")
    (protocol,) = struct.unpack_from("<I", bf.section(1), 0)
    if protocol != 1:
        raise ValueError("zkey file is not groth16")  # zkey_utils.hpp:55-58

    s2 = bf.section(2)
    pos = 0
    (n8q,) = struct.unpack_from("<I", s2, pos)
    pos += 4
    q = le_bytes_to_int(s2[pos : pos + n8q])
    pos += n8q
    (n8r,) = struct.unpack_from("<I", s2, pos)
    pos += 4
    r = le_bytes_to_int(s2[pos : pos + n8r])
    pos += n8r
    n_vars, n_public, domain_size = struct.unpack_from("<III", s2, pos)
    pos += 12
    vk = {}
    for name, size in (("vk_alpha1", 2), ("vk_beta1", 2), ("vk_beta2", 4), ("vk_gamma2", 4), ("vk_delta1", 2),
                       ("vk_delta2", 4)):
        vk[name] = (_g1_std if size == 2 else _g2_std)(s2[pos:], n8q, q)
        pos += size * n8q

    # section 4: leading u32 count, then packed 12 + n8r byte records
    # (the reference skips the count by offsetting +4: groth16.cpp:32)
    s4 = bf.section(4)
    rec = 12 + n8r
    n_coefs = (s4.size - 4) // rec
    body = s4[4 : 4 + n_coefs * rec].reshape(n_coefs, rec)
    meta = np.ascontiguousarray(body[:, :12]).view(np.uint32).reshape(n_coefs, 3)
    coef_val = bytes_le_to_limbs(np.ascontiguousarray(body[:, 12:]).reshape(-1), n8r)

    s3 = bf.section(3)
    return ProvingKey(
        n8q=n8q,
        n8r=n8r,
        q=q,
        r=r,
        n_vars=n_vars,
        n_public=n_public,
        domain_size=domain_size,
        n_coefs=n_coefs,
        **vk,
        coef_m=meta[:, 0].copy(),
        coef_c=meta[:, 1].copy(),
        coef_s=meta[:, 2].copy(),
        coef_val=coef_val,
        points_a=_parse_g1_table(bf.section(5), n8q),
        points_b1=_parse_g1_table(bf.section(6), n8q),
        points_b2=_parse_g2_table(bf.section(7), n8q),
        points_c=_parse_g1_table(bf.section(8), n8q),
        points_h=_parse_g1_table(bf.section(9), n8q),
        vk_ic=tuple(_g1_std(s3[i * 2 * n8q :], n8q, q) for i in range(s3.size // (2 * n8q))),
    )


# ---- the .zkey writer ---------------------------------------------------------

def _write_section(f, s_type: int, payload) -> None:
    f.write(struct.pack("<IQ", s_type, memoryview(payload).nbytes))
    f.write(payload)


def _limb_words(limbs: np.ndarray) -> np.ndarray:
    """(..., 16) 16-bit limbs -> (..., 8) little-endian uint32 words: the
    element's 32 bytes as the limbs' little-endian uint16 pairs."""
    limbs = np.asarray(limbs, dtype=np.uint32)
    words = limbs[..., 1::2] & 0xFFFF
    words <<= 16
    words |= limbs[..., 0::2] & 0xFFFF
    return words


def _point_records(x: np.ndarray, y: np.ndarray, inf: np.ndarray) -> np.ndarray:
    """Montgomery limb table -> packed affine records, x then y (all-zero
    records at infinity): (n, 16) uint32 words for G1, (n, 32) for G2."""
    n = x.shape[0]
    rec = np.concatenate([_limb_words(x).reshape(n, -1), _limb_words(y).reshape(n, -1)], axis=1)
    rec[np.asarray(inf, bool)] = 0
    return rec.astype("<u4", copy=False)


def save_zkey(path: str, pk: ProvingKey) -> None:
    """Write a snarkjs-format .zkey (inverse of `load_zkey`), byte for byte
    what keyless_zk_tpu.groth16.zkey.save_zkey writes.

    Section 4 is one (nCoefs, 3 + n8r / 4) uint32 record array: no loop
    over coefficients. The container is the one the reference mmaps
    (zkey_utils.hpp:13-90)."""
    q, r = pk.q, pk.r

    def r_mont(v: int) -> bytes:
        return ((v << 256) % q).to_bytes(pk.n8q, "little")

    def g1_point(pt) -> bytes:
        return bytes(2 * pk.n8q) if pt is None else r_mont(pt[0]) + r_mont(pt[1])

    def g2_point(pt) -> bytes:
        if pt is None:
            return bytes(4 * pk.n8q)
        return r_mont(pt[0][0]) + r_mont(pt[0][1]) + r_mont(pt[1][0]) + r_mont(pt[1][1])

    s2 = struct.pack("<I", pk.n8q) + q.to_bytes(pk.n8q, "little")
    s2 += struct.pack("<I", pk.n8r) + r.to_bytes(pk.n8r, "little")
    s2 += struct.pack("<III", pk.n_vars, pk.n_public, pk.domain_size)
    s2 += g1_point(pk.vk_alpha1) + g1_point(pk.vk_beta1) + g2_point(pk.vk_beta2)
    s2 += g2_point(pk.vk_gamma2) + g1_point(pk.vk_delta1) + g2_point(pk.vk_delta2)

    n = int(pk.n_coefs)
    s4 = np.empty((n, 3 + pk.n8r // 4), dtype="<u4")
    s4[:, 0], s4[:, 1], s4[:, 2] = pk.coef_m, pk.coef_c, pk.coef_s
    s4[:, 3:] = _limb_words(pk.coef_val)

    with open(path, "wb") as f:
        f.write(b"zkey")
        f.write(struct.pack("<II", 1, 9))
        _write_section(f, 1, struct.pack("<I", 1))
        _write_section(f, 2, s2)
        _write_section(f, 3, b"".join(g1_point(p) for p in pk.vk_ic))
        f.write(struct.pack("<IQ", 4, 4 + s4.nbytes))
        f.write(struct.pack("<I", n))
        f.write(s4)
        for s_type, name in ((5, "points_a"), (6, "points_b1"), (7, "points_b2"), (8, "points_c"), (9, "points_h")):
            t = getattr(pk, name)
            _write_section(f, s_type, _point_records(t.x, t.y, t.inf))
