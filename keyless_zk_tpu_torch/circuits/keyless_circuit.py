"""The Aptos Keyless relation as a native ConstraintSystem.

Faithful re-expression of the reference's top-level circuit
(circuit/templates/keyless.circom:55-558 with the parameterization of
templates/main.circom:5-43): JWT concatenation + SHA2 padding verification
+ SHA-256 + RSA-2048 PKCS#1 v1.5 + base64url decoding + per-field JWT
parsing (aud with override/skip logic, uid, extra, email_verified, iss,
iat with expiry check, nonce with Poseidon recomputation) + identity
commitment + the single Poseidon(14) public-inputs hash.

Input signal names follow the reference's witness input.json keys
(prover-service input_signals.rs:18-96), so signal derivation feeds this
circuit directly.

A jax-free copy of keyless_zk_tpu/circuits/keyless_circuit.py: the port
imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

from .r1cs import ConstraintSystem, LinComb
from .gadgets import is_equal, is_zero, less_than, select_array_value
from .hash_gadget import (
    assert_is_concatenation,
    assert_is_substring,
    hash_64bit_limbs_to_field_with_len,
    hash_bytes_to_field_with_len,
    is_substring,
    poseidon_gadget,
)
from .jwt_gadget import (
    b_and,
    b_not,
    brackets_depth_map,
    brackets_map,
    email_verified_check,
    enforce_not_nested,
    parse_email_verified_field,
    parse_jwt_field_quoted,
    parse_jwt_field_unquoted,
    string_bodies,
)
from .misc_gadgets import (
    ascii_digits_to_scalar,
    assert_is_64bit_limbs,
    big_endian_bits_to_scalars,
    big_less_than,
    sha2_padding_verify,
)
from .rsa_gadget import rsa_pkcs1_verify
from .sha256_gadget import bytes_to_bits, sha256_prepadded
from .base64_gadget import base64url_decode, base64url_decoded_length


@dataclass(frozen=True)
class KeylessConfig:
    """Max-length parameters (defaults: templates/main.circom:5-43)."""

    max_b64u_jwt_no_sig_len: int = 192 * 8
    max_b64u_jwt_header_w_dot_len: int = 300
    max_b64u_jwt_payload_sha2_padded_len: int = 192 * 8 - 64
    max_aud_kv_pair_len: int = 140
    max_aud_name_len: int = 40
    max_aud_value_len: int = 120
    max_iss_kv_pair_len: int = 140
    max_iss_name_len: int = 40
    max_iss_value_len: int = 120
    max_iat_kv_pair_len: int = 50
    max_iat_name_len: int = 10
    max_iat_value_len: int = 45
    max_nonce_kv_pair_len: int = 105
    max_nonce_name_len: int = 10
    max_nonce_value_len: int = 100
    max_ev_kv_pair_len: int = 30
    max_ev_name_len: int = 20
    max_ev_value_len: int = 10
    max_uid_kv_pair_len: int = 350
    max_uid_name_len: int = 30
    max_uid_value_len: int = 330
    max_extra_kv_pair_len: int = 350

    @property
    def max_jwt_payload_len(self) -> int:
        return (3 * self.max_b64u_jwt_payload_sha2_padded_len) // 4

    @property
    def sha2_max_num_blocks(self) -> int:
        return self.max_b64u_jwt_no_sig_len * 8 // 512


def to_circuit_config(cfg: KeylessConfig, has_skip_aud: bool = True):
    """KeylessConfig -> the service-side CircuitConfig (circuit_config.yml
    contract, keyless-common circuit_config.rs:8-53)."""
    from ..input_processing.circuit_config import CircuitConfig

    ml = {
        "b64u_jwt_no_sig_sha2_padded": cfg.max_b64u_jwt_no_sig_len,
        "b64u_jwt_header_w_dot": cfg.max_b64u_jwt_header_w_dot_len,
        "b64u_jwt_payload_sha2_padded": cfg.max_b64u_jwt_payload_sha2_padded_len,
        "b64u_jwt_payload": cfg.max_b64u_jwt_payload_sha2_padded_len,
        "sha2_num_bits": 8,
        "sha2_padding": 64,
        "epk": 3,
        "iss_field": cfg.max_iss_kv_pair_len,
        "iss_field_string_bodies": cfg.max_iss_kv_pair_len,
        "iss_name": cfg.max_iss_name_len,
        "iss_value": cfg.max_iss_value_len,
        "extra_field": cfg.max_extra_kv_pair_len,
        "ev_field": cfg.max_ev_kv_pair_len,
        "ev_name": cfg.max_ev_name_len,
        "ev_value": cfg.max_ev_value_len,
        "nonce_field": cfg.max_nonce_kv_pair_len,
        "nonce_field_string_bodies": cfg.max_nonce_kv_pair_len,
        "nonce_name": cfg.max_nonce_name_len,
        "nonce_value": cfg.max_nonce_value_len,
        "aud_field": cfg.max_aud_kv_pair_len,
        "aud_field_string_bodies": cfg.max_aud_kv_pair_len,
        "aud_name": cfg.max_aud_name_len,
        "private_aud_value": cfg.max_aud_value_len,
        "override_aud_value": cfg.max_aud_value_len,
        "iat_field": cfg.max_iat_kv_pair_len,
        "iat_name": cfg.max_iat_name_len,
        "iat_value": cfg.max_iat_value_len,
        "uid_field": cfg.max_uid_kv_pair_len,
        "uid_field_string_bodies": cfg.max_uid_kv_pair_len,
        "uid_name": cfg.max_uid_name_len,
        "uid_value": cfg.max_uid_value_len,
    }
    return CircuitConfig(max_lengths=ml, has_input_skip_aud_checks=has_skip_aud)


def witness_kwargs(signals) -> dict:
    """Padded CircuitInputSignals -> compute_witness keyword dict."""
    from ..input_processing.signals import Kind

    out = {}
    for name, s in signals.signals.items():
        if s.kind in (Kind.U64, Kind.FR):
            out[name] = int(s.value)
        elif s.kind == Kind.BYTES:
            out[name] = list(s.value)
        else:
            out[name] = [int(v) for v in s.value]
    return out


def build_keyless_circuit(cfg: KeylessConfig = KeylessConfig()) -> ConstraintSystem:
    cs = ConstraintSystem()

    # ---- the single public input (keyless.circom:531, main.circom:5) -----
    public_inputs_hash = cs.public_wire()
    cs.set_input_hint([public_inputs_hash], "public_inputs_hash")

    def arr(name: str, n: int) -> list[LinComb]:
        ws = cs.new_wires(n)
        cs.set_input_hint(ws, name)
        cs.label(name, ws)
        return [cs.lc(w) for w in ws]

    def sig(name: str) -> LinComb:
        w = cs.new_wire()
        cs.set_input_hint([w], name)
        cs.label(name, w)
        return cs.lc(w)

    # ---- JWT splitting (keyless.circom:105-162) ---------------------------
    jwt_no_sig = arr("b64u_jwt_no_sig_sha2_padded", cfg.max_b64u_jwt_no_sig_len)
    header = arr("b64u_jwt_header_w_dot", cfg.max_b64u_jwt_header_w_dot_len)
    header_len = sig("b64u_jwt_header_w_dot_len")
    payload_padded = arr(
        "b64u_jwt_payload_sha2_padded", cfg.max_b64u_jwt_payload_sha2_padded_len
    )
    payload_padded_len = sig("b64u_jwt_payload_sha2_padded_len")

    assert_is_concatenation(
        cs, jwt_no_sig, header, payload_padded, header_len, payload_padded_len
    )
    dot = select_array_value(cs, jwt_no_sig, header_len - cs.const(1))
    cs.constrain_eq(dot, cs.const(46))  # '.'

    payload_b64 = arr("b64u_jwt_payload", cfg.max_b64u_jwt_payload_sha2_padded_len)
    padded_hash = hash_bytes_to_field_with_len(cs, payload_padded, payload_padded_len)
    assert_is_substring(
        cs, payload_padded, padded_hash, payload_b64, payload_padded_len, LinComb()
    )

    # ---- SHA2 padding + hash (keyless.circom:168-198) ----------------------
    sha2_num_blocks = sig("sha2_num_blocks")
    sha2_num_bits = arr("sha2_num_bits", 8)
    sha2_padding = arr("sha2_padding", 64)
    sha2_padding_verify(
        cs,
        jwt_no_sig,
        sha2_num_blocks,
        header_len + payload_padded_len,
        sha2_num_bits,
        sha2_padding,
    )
    jwt_bits = bytes_to_bits(cs, [w for w in cs.wires_of("b64u_jwt_no_sig_sha2_padded")])
    jwt_hash_bits = sha256_prepadded(
        cs, jwt_bits, sha2_num_blocks - cs.const(1), cfg.sha2_max_num_blocks
    )

    # ---- RSA verification (keyless.circom:205-211, 537-558) ----------------
    signature = arr("signature", 32)
    pubkey_modulus = arr("pubkey_modulus", 32)
    sig_wires = cs.wires_of("signature")
    mod_wires = cs.wires_of("pubkey_modulus")
    assert_is_64bit_limbs(cs, signature)
    sig_lt = big_less_than(cs, signature, pubkey_modulus, 64)
    cs.constrain_eq(sig_lt, cs.const(1))
    msg_limbs_be = big_endian_bits_to_scalars(cs, jwt_hash_bits, 64)
    rsa_pkcs1_verify(cs, sig_wires, mod_wires, list(reversed(msg_limbs_be)))

    # ---- base64url decoding (keyless.circom:217-236) -----------------------
    n_payload = cfg.max_jwt_payload_len
    jwt_payload = base64url_decode(cs, payload_b64, n_payload)
    jwt_payload_len = base64url_decoded_length(
        cs, payload_padded_len, cfg.max_b64u_jwt_payload_sha2_padded_len
    )
    jwt_payload_hash = hash_bytes_to_field_with_len(cs, jwt_payload, jwt_payload_len)

    # ---- parsing hint maps (keyless.circom:238-249) -------------------------
    bodies = string_bodies(cs, jwt_payload)
    unquoted_brackets = [
        cs.lc(cs.mul(b_not(cs, b), m))
        for b, m in zip(bodies, brackets_map(cs, jwt_payload))
    ]
    depth_map = brackets_depth_map(cs, unquoted_brackets)

    def check_field_in_jwt(fname: str, fld, flen, fidx, with_bodies=None):
        assert_is_substring(cs, jwt_payload, jwt_payload_hash, fld, flen, fidx)
        if with_bodies is not None:
            assert_is_substring(cs, bodies, jwt_payload_hash, with_bodies, flen, fidx)
        enforce_not_nested(cs, fidx, flen, depth_map)

    # ---- aud field (keyless.circom:256-299) ---------------------------------
    aud_field = arr("aud_field", cfg.max_aud_kv_pair_len)
    aud_field_sb = arr("aud_field_string_bodies", cfg.max_aud_kv_pair_len)
    aud_field_len = sig("aud_field_len")
    aud_index = sig("aud_index")
    check_field_in_jwt("aud", aud_field, aud_field_len, aud_index, aud_field_sb)

    aud_value_index = sig("aud_value_index")
    aud_colon_index = sig("aud_colon_index")
    aud_name = arr("aud_name", cfg.max_aud_name_len)
    use_aud_override = sig("use_aud_override")
    cs.constrain(use_aud_override, use_aud_override - cs.const(1), LinComb())

    private_aud_value = arr("private_aud_value", cfg.max_aud_value_len)
    override_aud_value = arr("override_aud_value", cfg.max_aud_value_len)
    private_aud_value_len = sig("private_aud_value_len")
    override_aud_value_len = sig("override_aud_value_len")
    skip_aud_checks = sig("skip_aud_checks")
    cs.constrain(skip_aud_checks, skip_aud_checks - cs.const(1), LinComb())
    cs.constrain_zero(b_and(cs, skip_aud_checks, use_aud_override))

    aud_value = [
        cs.lc(cs.mul(o - p, use_aud_override)) + p
        for o, p in zip(override_aud_value, private_aud_value)
    ]
    aud_value_len = (
        cs.lc(cs.mul(override_aud_value_len - private_aud_value_len, use_aud_override))
        + private_aud_value_len
    )
    parse_jwt_field_quoted(
        cs, aud_field, aud_name, aud_value, aud_field_sb,
        aud_field_len, cs.const(3), aud_value_index, aud_value_len, aud_colon_index,
        skip_aud_checks,
    )
    perform_aud_checks = b_not(cs, skip_aud_checks)
    for i, c in enumerate(b"aud"):
        cs.constrain_eq(
            cs.lc(cs.mul(aud_name[i], perform_aud_checks)),
            perform_aud_checks.scale(c),
        )

    # ---- uid field (keyless.circom:301-318) ---------------------------------
    uid_field = arr("uid_field", cfg.max_uid_kv_pair_len)
    uid_field_sb = arr("uid_field_string_bodies", cfg.max_uid_kv_pair_len)
    uid_field_len = sig("uid_field_len")
    uid_index = sig("uid_index")
    check_field_in_jwt("uid", uid_field, uid_field_len, uid_index, uid_field_sb)

    uid_name_len = sig("uid_name_len")
    uid_value_index = sig("uid_value_index")
    uid_value_len = sig("uid_value_len")
    uid_colon_index = sig("uid_colon_index")
    uid_name = arr("uid_name", cfg.max_uid_name_len)
    uid_value = arr("uid_value", cfg.max_uid_value_len)
    parse_jwt_field_quoted(
        cs, uid_field, uid_name, uid_value, uid_field_sb,
        uid_field_len, uid_name_len, uid_value_index, uid_value_len, uid_colon_index,
        LinComb(),
    )

    # ---- extra field (keyless.circom:320-337) -------------------------------
    extra_field = arr("extra_field", cfg.max_extra_kv_pair_len)
    extra_field_len = sig("extra_field_len")
    extra_index = sig("extra_index")
    use_extra_field = sig("use_extra_field")
    cs.constrain(use_extra_field, use_extra_field - cs.const(1), LinComb())
    ef_ok = cs.lc(
        is_substring(cs, jwt_payload, jwt_payload_hash, extra_field, extra_field_len, extra_index)
    )
    enforce_not_nested(cs, extra_index, extra_field_len, depth_map)
    cs.constrain_zero(b_and(cs, use_extra_field, b_not(cs, ef_ok)))
    ef_start = select_array_value(cs, bodies, extra_index)
    cs.constrain_zero(ef_start)

    # ---- email_verified field (keyless.circom:339-368) ----------------------
    ev_field = arr("ev_field", cfg.max_ev_kv_pair_len)
    ev_field_len = sig("ev_field_len")
    ev_index = sig("ev_index")
    ev_value_index = sig("ev_value_index")
    ev_value_len = sig("ev_value_len")
    ev_colon_index = sig("ev_colon_index")
    ev_name = arr("ev_name", cfg.max_ev_name_len)
    ev_value = arr("ev_value", cfg.max_ev_value_len)

    uid_is_email = email_verified_check(
        cs, ev_name, ev_value, ev_value_len, uid_name, uid_name_len
    )
    ev_in_jwt = cs.lc(
        is_substring(cs, jwt_payload, jwt_payload_hash, ev_field, ev_field_len, ev_index)
    )
    cs.constrain_zero(b_and(cs, uid_is_email, b_not(cs, ev_in_jwt)))
    enforce_not_nested(cs, ev_index, ev_field_len, depth_map)
    parse_email_verified_field(
        cs, ev_field, ev_name, ev_value,
        ev_field_len, cs.const(14), ev_value_index, ev_value_len, ev_colon_index,
    )

    # ---- iss field (keyless.circom:370-394) ---------------------------------
    iss_field = arr("iss_field", cfg.max_iss_kv_pair_len)
    iss_field_sb = arr("iss_field_string_bodies", cfg.max_iss_kv_pair_len)
    iss_field_len = sig("iss_field_len")
    iss_index = sig("iss_index")
    check_field_in_jwt("iss", iss_field, iss_field_len, iss_index, iss_field_sb)

    iss_value_index = sig("iss_value_index")
    iss_value_len = sig("iss_value_len")
    iss_colon_index = sig("iss_colon_index")
    iss_name = arr("iss_name", cfg.max_iss_name_len)
    iss_value = arr("iss_value", cfg.max_iss_value_len)
    parse_jwt_field_quoted(
        cs, iss_field, iss_name, iss_value, iss_field_sb,
        iss_field_len, cs.const(3), iss_value_index, iss_value_len, iss_colon_index,
        LinComb(),
    )
    for i, c in enumerate(b"iss"):
        cs.constrain_eq(iss_name[i], cs.const(c))

    # ---- iat field + expiry (keyless.circom:396-428) ------------------------
    iat_field = arr("iat_field", cfg.max_iat_kv_pair_len)
    iat_field_len = sig("iat_field_len")
    iat_index = sig("iat_index")
    assert_is_substring(
        cs, jwt_payload, jwt_payload_hash, iat_field, iat_field_len, iat_index
    )
    iat_value_index = sig("iat_value_index")
    iat_value_len = sig("iat_value_len")
    iat_colon_index = sig("iat_colon_index")
    iat_name = arr("iat_name", cfg.max_iat_name_len)
    iat_value = arr("iat_value", cfg.max_iat_value_len)
    parse_jwt_field_unquoted(
        cs, iat_field, iat_name, iat_value,
        iat_field_len, cs.const(3), iat_value_index, iat_value_len, iat_colon_index,
        LinComb(),
    )
    enforce_not_nested(cs, iss_index, iss_field_len, depth_map)  # sic: keyless.circom:412
    iat_start = select_array_value(cs, bodies, iat_index)
    cs.constrain_zero(iat_start)
    for i, c in enumerate(b"iat"):
        cs.constrain_eq(iat_name[i], cs.const(c))

    iat_elem = ascii_digits_to_scalar(cs, iat_value, iat_value_len)
    exp_date = sig("exp_date")
    exp_horizon = sig("exp_horizon")
    not_expired = cs.lc(less_than(cs, exp_date, iat_elem + exp_horizon, 252))
    cs.constrain_eq(not_expired, cs.const(1))

    # ---- nonce field (keyless.circom:430-470) --------------------------------
    nonce_field = arr("nonce_field", cfg.max_nonce_kv_pair_len)
    nonce_field_sb = arr("nonce_field_string_bodies", cfg.max_nonce_kv_pair_len)
    nonce_field_len = sig("nonce_field_len")
    nonce_index = sig("nonce_index")
    check_field_in_jwt("nonce", nonce_field, nonce_field_len, nonce_index, nonce_field_sb)

    nonce_value_index = sig("nonce_value_index")
    nonce_value_len = sig("nonce_value_len")
    nonce_colon_index = sig("nonce_colon_index")
    nonce_name = arr("nonce_name", cfg.max_nonce_name_len)
    nonce_value = arr("nonce_value", cfg.max_nonce_value_len)
    parse_jwt_field_quoted(
        cs, nonce_field, nonce_name, nonce_value, nonce_field_sb,
        nonce_field_len, cs.const(5), nonce_value_index, nonce_value_len,
        nonce_colon_index, LinComb(),
    )
    for i, c in enumerate(b"nonce"):
        cs.constrain_eq(nonce_name[i], cs.const(c))

    epk = arr("epk", 3)
    epk_len = sig("epk_len")
    epk_blinder = sig("epk_blinder")
    computed_nonce = poseidon_gadget(
        cs, [epk[0], epk[1], epk[2], epk_len, exp_date, epk_blinder]
    )
    nonce_elem = ascii_digits_to_scalar(cs, nonce_value, nonce_value_len)
    cs.constrain_eq(nonce_elem, computed_nonce)

    # ---- identity commitment (keyless.circom:476-494) -------------------------
    pepper = sig("pepper")
    hashable_aud = [
        cs.lc(cs.mul(v, perform_aud_checks)) for v in private_aud_value
    ]
    private_aud_val_hashed = hash_bytes_to_field_with_len(
        cs, hashable_aud, private_aud_value_len
    )
    uid_value_hashed = hash_bytes_to_field_with_len(cs, uid_value, uid_value_len)
    uid_name_hashed = hash_bytes_to_field_with_len(cs, uid_name, uid_name_len)
    idc = poseidon_gadget(
        cs, [pepper, private_aud_val_hashed, uid_value_hashed, uid_name_hashed]
    )

    # ---- public-inputs hash (keyless.circom:500-532) ---------------------------
    assert_is_64bit_limbs(cs, pubkey_modulus)
    override_aud_val_hashed = hash_bytes_to_field_with_len(
        cs, override_aud_value, override_aud_value_len
    )
    hashed_jwt_header = hash_bytes_to_field_with_len(cs, header, header_len)
    hashed_pubkey_modulus = hash_64bit_limbs_to_field_with_len(
        cs, pubkey_modulus, cs.const(256)
    )
    hashed_iss_value = hash_bytes_to_field_with_len(cs, iss_value, iss_value_len)
    hashed_extra_field = hash_bytes_to_field_with_len(cs, extra_field, extra_field_len)
    computed = poseidon_gadget(
        cs,
        [
            epk[0], epk[1], epk[2], epk_len,
            idc,
            exp_date,
            exp_horizon,
            hashed_iss_value,
            use_extra_field,
            hashed_extra_field,
            hashed_jwt_header,
            hashed_pubkey_modulus,
            override_aud_val_hashed,
            use_aud_override,
        ],
    )
    cs.constrain_eq(cs.lc(public_inputs_hash), computed)
    return cs
