"""snarkjs VK <-> Aptos on-chain VK representation.

Mirror of keyless-common/src/snark_js_groth16.rs:49-117 and types.rs:43-75:
points are ark-serialize compressed (x little-endian; flag bits in the top
byte: 0x80 = y lexicographically largest, 0x40 = point at infinity) and
hex-encoded into the `0x1::keyless_account::Groth16VerificationKey`
resource shape.  The gamma_g2 encoding of the standard G2 generator
reproduces the on-chain example hex in types.rs:43-60 exactly.

A jax-free copy of keyless_zk_tpu/tooling/onchain_vk.py: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

from ..fields import bn254

Q = bn254.Q

FLAG_INFINITY = 0x40
FLAG_Y_LARGEST = 0x80

ONCHAIN_TYPE = "0x1::keyless_account::Groth16VerificationKey"


def _y_is_largest_fq(y: int) -> bool:
    return y > Q - y


def _y_is_largest_fq2(y: tuple) -> bool:
    ny = ((Q - y[0]) % Q, (Q - y[1]) % Q)
    return (y[1], y[0]) > (ny[1], ny[0])


def compress_g1(pt) -> bytes:
    """Affine (x, y) or None -> 32-byte ark compressed encoding."""
    if pt is None:
        buf = bytearray(32)
        buf[-1] |= FLAG_INFINITY
        return bytes(buf)
    x, y = pt
    buf = bytearray(x.to_bytes(32, "little"))
    if _y_is_largest_fq(y):
        buf[-1] |= FLAG_Y_LARGEST
    return bytes(buf)


def compress_g2(pt) -> bytes:
    """Affine ((x0,x1), (y0,y1)) or None -> 64-byte compressed encoding."""
    if pt is None:
        buf = bytearray(64)
        buf[-1] |= FLAG_INFINITY
        return bytes(buf)
    x, y = pt
    buf = bytearray(x[0].to_bytes(32, "little") + x[1].to_bytes(32, "little"))
    if _y_is_largest_fq2(y):
        buf[-1] |= FLAG_Y_LARGEST
    return bytes(buf)


def _sqrt_fq(a: int) -> int | None:
    # q % 4 == 3: sqrt = a^((q+1)/4)
    r = pow(a, (Q + 1) // 4, Q)
    return r if r * r % Q == a % Q else None


def _sqrt_fq2(a: tuple) -> tuple | None:
    # Tonelli for Fq2 via norm: sqrt(a) with a = a0 + a1 u, u^2 = -1
    a0, a1 = a
    if a1 == 0:
        r = _sqrt_fq(a0)
        if r is not None:
            return (r, 0)
        # a0 is a QNR; sqrt is purely imaginary: (i*t)^2 = -t^2 = a0
        t = _sqrt_fq((-a0) % Q)
        return None if t is None else (0, t)
    norm = (a0 * a0 + a1 * a1) % Q
    n = _sqrt_fq(norm)
    if n is None:
        return None
    for sign in (1, Q - 1):
        x0 = (a0 + sign * n) % Q * pow(2, -1, Q) % Q
        r0 = _sqrt_fq(x0)
        if r0 is None:
            continue
        r1 = a1 * pow(2 * r0 % Q, -1, Q) % Q
        if ((r0 * r0 - r1 * r1) % Q, 2 * r0 * r1 % Q) == (a0 % Q, a1 % Q):
            return (r0, r1)
    return None


def decompress_g1(buf: bytes):
    assert len(buf) == 32
    b = bytearray(buf)
    flags = b[-1] & 0xC0
    b[-1] &= 0x3F
    if flags & FLAG_INFINITY:
        return None
    x = int.from_bytes(bytes(b), "little")
    y = _sqrt_fq((pow(x, 3, Q) + bn254.CURVE_B) % Q)
    if y is None:
        raise ValueError("invalid G1 encoding")
    if _y_is_largest_fq(y) != bool(flags & FLAG_Y_LARGEST):
        y = Q - y
    return (x, y)


def decompress_g2(buf: bytes):
    assert len(buf) == 64
    from ..curves.ref_curve import B2, fq2_add, fq2_mul

    b = bytearray(buf)
    flags = b[-1] & 0xC0
    b[-1] &= 0x3F
    if flags & FLAG_INFINITY:
        return None
    x = (int.from_bytes(bytes(b[:32]), "little"), int.from_bytes(bytes(b[32:]), "little"))
    rhs = fq2_add(fq2_mul(fq2_mul(x, x), x), B2)
    y = _sqrt_fq2(rhs)
    if y is None:
        raise ValueError("invalid G2 encoding")
    if _y_is_largest_fq2(y) != bool(flags & FLAG_Y_LARGEST):
        y = ((Q - y[0]) % Q, (Q - y[1]) % Q)
    return (x, y)


def _g1_from_json(repr3) -> tuple | None:
    x, y, z = (int(v) for v in repr3)
    if z == 0:
        return None
    zi = pow(z, -1, Q)
    return (x * zi % Q, y * zi % Q)


def _g2_from_json(repr3) -> tuple | None:
    x = (int(repr3[0][0]), int(repr3[0][1]))
    y = (int(repr3[1][0]), int(repr3[1][1]))
    z = (int(repr3[2][0]), int(repr3[2][1]))
    if z == (0, 0):
        return None
    from ..curves.ref_curve import fq2_inv, fq2_mul

    zi = fq2_inv(z)
    return (fq2_mul(x, zi), fq2_mul(y, zi))


def snarkjs_vk_to_onchain(vk: dict) -> dict:
    """snarkjs VK JSON -> on-chain resource dict (snark_js_groth16.rs:63-106)."""
    return {
        "type": ONCHAIN_TYPE,
        "data": {
            "alpha_g1": "0x" + compress_g1(_g1_from_json(vk["vk_alpha_1"])).hex(),
            "beta_g2": "0x" + compress_g2(_g2_from_json(vk["vk_beta_2"])).hex(),
            "delta_g2": "0x" + compress_g2(_g2_from_json(vk["vk_delta_2"])).hex(),
            "gamma_abc_g1": [
                "0x" + compress_g1(_g1_from_json(vk["IC"][0])).hex(),
                "0x" + compress_g1(_g1_from_json(vk["IC"][1])).hex(),
            ],
            "gamma_g2": "0x" + compress_g2(_g2_from_json(vk["vk_gamma_2"])).hex(),
        },
    }


def vk_json_from_pk(pk) -> dict:
    """snarkjs verification-key JSON recovered from a zkey's own points
    (header VK + section-3 IC), for imported setups that ship no separate
    VK file (setup_tool.import_zkey)."""
    if not pk.vk_ic:
        raise ValueError("zkey carries no IC points; supply a VK JSON instead")

    def g1(pt):
        return ["0", "1", "0"] if pt is None else [str(pt[0]), str(pt[1]), "1"]

    def g2(pt):
        return [
            [str(pt[0][0]), str(pt[0][1])],
            [str(pt[1][0]), str(pt[1][1])],
            ["1", "0"],
        ]

    return {
        "protocol": "groth16",
        "curve": "bn128",
        "nPublic": pk.n_public,
        "vk_alpha_1": g1(pk.vk_alpha1),
        "vk_beta_2": g2(pk.vk_beta2),
        "vk_gamma_2": g2(pk.vk_gamma2),
        "vk_delta_2": g2(pk.vk_delta2),
        "IC": [g1(p) for p in pk.vk_ic],
    }
