"""Ed25519 (RFC 8032) — pure Python.

Used for training-wheels signing/verification (the reference signs every
proof with an Ed25519 key: prover-service/src/request_handler/
training_wheels.rs:155-222) and for deriving test ephemeral public keys.
Not on the proving hot path.

NOT constant-time: Python big-int arithmetic leaks timing. Fine for the
training-wheels role here (the TW key signs public statements; the
deployments that care use an HSM/KMS signer), but do not reuse this module
for secret-dependent protocols.

A frozen copy of keyless_zk_tpu_torch/utils/ed25519.py for the benchmark's
reference: it imports nothing of the program.
"""

from __future__ import annotations

import hashlib

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, -1, P)) % P

_BY = 4 * pow(5, -1, P) % P
_BX_SQ = (_BY * _BY - 1) * pow(D * _BY * _BY + 1, -1, P) % P


def _sqrt_mod(a: int) -> int:
    x = pow(a, (P + 3) // 8, P)
    if (x * x - a) % P != 0:
        x = x * pow(2, (P - 1) // 4, P) % P
    if (x * x - a) % P != 0:
        raise ValueError("not a square")
    return x


_BX = _sqrt_mod(_BX_SQ)
if _BX % 2 != 0:
    _BX = P - _BX
B = (_BX, _BY, 1, _BX * _BY % P)  # extended coordinates (x, y, z, t)


def _add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * t1 * t2 * D % P
    dd = 2 * z1 * z2 % P
    e, f, g, h = b - a, dd - c, dd + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _mul(p, s: int):
    q = (0, 1, 1, 0)
    while s:
        if s & 1:
            q = _add(q, p)
        p = _add(p, p)
        s >>= 1
    return q


def _compress(p) -> bytes:
    x, y, z, _ = p
    zi = pow(z, -1, P)
    x, y = x * zi % P, y * zi % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _decompress(data: bytes):
    y = int.from_bytes(data, "little")
    sign = y >> 255
    y &= (1 << 255) - 1
    if y >= P:
        raise ValueError("bad point encoding")
    x2 = (y * y - 1) * pow(D * y * y + 1, -1, P) % P
    x = _sqrt_mod(x2)
    if x == 0 and sign:
        raise ValueError("bad point encoding")
    if x & 1 != sign:
        x = P - x
    return (x, y, 1, x * y % P)


def _points_equal(p, q) -> bool:
    x1, y1, z1, _ = p
    x2, y2, z2, _ = q
    return (x1 * z2 - x2 * z1) % P == 0 and (y1 * z2 - y2 * z1) % P == 0


def _clamp(h: bytes) -> int:
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a


def public_key(sk: bytes) -> bytes:
    assert len(sk) == 32
    h = hashlib.sha512(sk).digest()
    return _compress(_mul(B, _clamp(h)))


def sign(sk: bytes, msg: bytes) -> bytes:
    h = hashlib.sha512(sk).digest()
    a = _clamp(h)
    pk = _compress(_mul(B, a))
    r = int.from_bytes(hashlib.sha512(h[32:] + msg).digest(), "little") % L
    r_enc = _compress(_mul(B, r))
    k = int.from_bytes(hashlib.sha512(r_enc + pk + msg).digest(), "little") % L
    s = (r + k * a) % L
    return r_enc + s.to_bytes(32, "little")


def verify(pk: bytes, msg: bytes, sig: bytes) -> bool:
    if len(sig) != 64 or len(pk) != 32:
        return False
    try:
        a_pt = _decompress(pk)
        r_pt = _decompress(sig[:32])
    except ValueError:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    k = int.from_bytes(hashlib.sha512(sig[:32] + pk + msg).digest(), "little") % L
    return _points_equal(_mul(B, s), _add(r_pt, _mul(a_pt, k)))
