"""A small circuit of the keyless gadgets, built the same way from either
package (`pkg` is "keyless_zk_tpu" or "keyless_zk_tpu_torch"), so that the
port's witness engine, setup and prover can be held against the JAX
package's on one relation that runs every witness opcode:

- `input`, `mul`, `lc`, `bits`: everywhere (to_bits, less_than, materialize);
- `iszero`: is_zero / is_equal; `onehot`: single_one_array (offset 0) and
  ascii_digits_to_scalar (offset 1); `quorem`: base64url_decoded_length;
- `bigdiv` and `bigcarry`: fp_mul at 8-bit limbs, k = 4;
- `call`: a closure hint (a field inverse, checked by x * inv = 1);
- Poseidon, whose digest is the public input.

Two sizes: "engine" (2,275 constraints, or 29,179 with `sha`: one SHA-256
compression of a padded message) adds base64url decoding of 16 characters
and takes wider digits, limbs and hash inputs; "setup" (domain 2^9) is
small enough for a setup on the CPU whose tables the JAX package computes
with host scalar multiplications."""

from __future__ import annotations

import base64
import hashlib
import importlib

R = 21888242871839275222246405745257275088548364400416034343698204186575808495617  # BN254 scalar field
FP_BITS = 8
FP_MOD = {4: (1 << 31) - 1, 2: 65521}  # a prime below 2^(8 k) for k limbs
FP_A, FP_B = 0x1234567, 0x7654321
DIGITS = b"4096"
B64_TEXT = b"keyless!zk:)"  # 12 bytes, 16 base64url characters


def _limbs(v: int, k: int) -> list[int]:
    return [(v >> (FP_BITS * i)) & ((1 << FP_BITS) - 1) for i in range(k)]


SHA_MSG = b"keyless"


SIZES = {  # decimal digits, fp_mul limbs, Poseidon inputs, base64url characters
    "engine": (6, 4, 2, 16),
    "setup": (3, 2, 1, 0),
}


def build(pkg: str, size: str = "engine", sha: bool = False):
    """(cs, named output wires). The relation is the same for either pkg."""
    n_digits, fp_k, n_hashed, n_chars = SIZES[size]
    r1cs = importlib.import_module(pkg + ".circuits.r1cs")
    g = importlib.import_module(pkg + ".circuits.gadgets")
    b64 = importlib.import_module(pkg + ".circuits.base64_gadget")
    misc = importlib.import_module(pkg + ".circuits.misc_gadgets")
    rsa = importlib.import_module(pkg + ".circuits.rsa_gadget")
    sha256 = importlib.import_module(pkg + ".circuits.sha256_gadget")
    P = r1cs.P

    cs = r1cs.ConstraintSystem()
    out_pub = cs.public_wire()
    cs.set_input_hint([out_pub], "pub")
    a, b = cs.new_wire(), cs.new_wire()
    cs.set_input_hint([a], "a")
    cs.set_input_hint([b], "b")
    la, lb = cs.lc(a), cs.lc(b)
    cs.to_bits(la, 4)
    cs.to_bits(lb, 4)
    outs = {
        "is_zero": g.is_zero(cs, la - lb),
        "is_equal": g.is_equal(cs, la, cs.const(7)),
        "less_than": g.less_than(cs, la, lb, 4),
        "onehot": g.single_one_array(cs, lb, 5),
    }

    inv = cs.new_wire()
    cs.hint(lambda v: pow(v, P - 2, P), [inv], [a])
    cs.constrain(la, cs.lc(inv), cs.const(1))
    outs["inverse"] = inv

    digits = cs.new_wires(n_digits)
    cs.set_input_hint(digits, "digits")
    digits_len = cs.new_wire()
    cs.set_input_hint([digits_len], "digits_len")
    outs["digits"] = rsa.materialize(cs, misc.ascii_digits_to_scalar(cs, [cs.lc(d) for d in digits],
                                                                      cs.lc(digits_len)))

    if n_chars:
        chars = cs.new_wires(n_chars)
        cs.set_input_hint(chars, "chars")
        decoded = b64.base64url_decode(cs, [cs.lc(c) for c in chars], len(B64_TEXT))
        outs["decoded"] = [rsa.materialize(cs, d) for d in decoded]
    chars_len = cs.new_wire()
    cs.set_input_hint([chars_len], "chars_len")
    outs["decoded_len"] = rsa.materialize(cs, b64.base64url_decoded_length(cs, cs.lc(chars_len), 16))

    outs["poseidon"] = rsa.materialize(cs, g.poseidon_gadget(cs, [la, lb][:n_hashed]))
    # the public wire carries the Poseidon digest
    cs.constrain_eq(cs.lc(out_pub), cs.lc(outs["poseidon"]))

    fp = {}
    for name in ("fa", "fb", "fp"):
        fp[name] = cs.new_wires(fp_k)
        cs.set_input_hint(fp[name], name)
        for w in fp[name]:
            cs.to_bits(cs.lc(w), FP_BITS)
    outs["fp_mul"] = rsa.fp_mul(cs, fp["fa"], fp["fb"], fp["fp"], FP_BITS, fp_k)

    if sha:
        block = cs.new_wires(64)
        cs.set_input_hint(block, "sha_block")
        state = sha256.sha256_compression(cs, sha256.initial_state(cs), sha256.bytes_to_bits(cs, block))
        outs["sha"] = [rsa.materialize(cs, bit) for word in state for bit in word]
    return cs, outs


def inputs(poseidon, size: str = "engine", sha: bool = False, a: int = 7, b: int = 3) -> dict:
    """Witness inputs for `build`; `poseidon` is the host hash function of
    either package (the public input is the Poseidon digest)."""
    n_digits, fp_k, n_hashed, n_chars = SIZES[size]
    digits = DIGITS[: n_digits - 1]  # ascii_digits_to_scalar takes lengths 1 .. n - 1
    kw = {
        "pub": poseidon([a, b][:n_hashed]),
        "a": a,
        "b": b,
        "digits": list(digits.ljust(n_digits, b"\x00")),
        "digits_len": len(digits),
        "chars_len": 16,
        "fa": _limbs(FP_A % FP_MOD[fp_k], fp_k),
        "fb": _limbs(FP_B % FP_MOD[fp_k], fp_k),
        "fp": _limbs(FP_MOD[fp_k], fp_k),
    }
    if n_chars:
        kw["chars"] = list(base64.urlsafe_b64encode(B64_TEXT).rstrip(b"="))
    if sha:  # SHA-256 padding to one block
        kw["sha_block"] = list(SHA_MSG + b"\x80" + bytes(55 - len(SHA_MSG)) + (8 * len(SHA_MSG)).to_bytes(8, "big"))
    return kw


def expected(size: str = "engine", sha: bool = False, a: int = 7, b: int = 3) -> dict:
    """Host values of the named outputs, for the same inputs."""
    n_digits, fp_k, _, n_chars = SIZES[size]
    mod = FP_MOD[fp_k]
    want = {
        "is_zero": int(a == b),
        "is_equal": int(a == 7),
        "less_than": int(a < b),
        "onehot": [int(b == j) for j in range(5)],
        "inverse": pow(a, -1, R),
        "digits": int(DIGITS[: n_digits - 1]),
        "decoded_len": 3 * 16 // 4,
        "fp_mul": _limbs(FP_A * FP_B % mod, fp_k),
    }
    if n_chars:
        want["decoded"] = list(B64_TEXT)
    if sha:
        digest = int.from_bytes(hashlib.sha256(SHA_MSG).digest(), "big")
        want["sha"] = [(digest >> (255 - i)) & 1 for i in range(256)]
    return want
