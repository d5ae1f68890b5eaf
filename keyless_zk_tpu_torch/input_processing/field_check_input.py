"""Per-JWT-field signal bundles (parse hints for the circuit).

Mirror of prover-service/src/input_processing/field_check_input.rs: the
string-bodies bitmap (:11-31), default-behavior fields (iss/nonce/iat/uid),
and the custom aud / email_verified / extra-field logic including
aud-override and aud-less modes (:143-252).

A jax-free copy of keyless_zk_tpu/input_processing/field_check_input.py: the
port imports nothing of the JAX package.
"""

from __future__ import annotations

from .field_parser import ParsedField, find_and_parse_field
from .signals import CircuitInputSignals
from .types import VerifiedInput


def calc_string_bodies(s: str) -> list[bool]:
    """Which bytes sit inside JSON string bodies (escaped-quote aware)."""
    b = s.encode()
    out = [False] * len(b)
    out[1] = b[0:1] == b'"'
    for i in range(2, len(b)):
        if not out[i - 2] and b[i - 1 : i] == b'"' and b[i - 2 : i - 1] != b"\\":
            out[i] = True
        elif out[i - 1] and b[i : i + 1] == b'"' and b[i - 1 : i] != b"\\":
            out[i] = False
        else:
            out[i] = out[i - 1]
    return out


_STRING_BODIES_FIELDS = ("nonce", "iss", "aud", "uid")


def _whole_field_signals(parsed: ParsedField, name: str) -> CircuitInputSignals:
    s = (
        CircuitInputSignals()
        .str_input(f"{name}_field", parsed.whole_field)
        .usize_input(f"{name}_field_len", len(parsed.whole_field))
        .usize_input(f"{name}_index", parsed.index)
    )
    if name in _STRING_BODIES_FIELDS:
        s.bools_input(f"{name}_field_string_bodies", calc_string_bodies(parsed.whole_field))
    return s


def _field_components_signals(parsed: ParsedField, name: str) -> CircuitInputSignals:
    return (
        CircuitInputSignals()
        .usize_input(f"{name}_colon_index", parsed.colon_index)
        .str_input(f"{name}_name", parsed.key)
        .usize_input(f"{name}_value_index", parsed.value_index)
        .usize_input(f"{name}_value_len", len(parsed.value))
        .str_input(f"{name}_value", parsed.value)
    )


def _signals_for_field(vi: VerifiedInput, name: str) -> CircuitInputSignals:
    parsed = find_and_parse_field(vi.jwt_parts.payload_decoded(), name)
    return _whole_field_signals(parsed, name).merge(_field_components_signals(parsed, name))


def _signals_for_field_with_key(vi: VerifiedInput, name: str, key: str) -> CircuitInputSignals:
    parsed = find_and_parse_field(vi.jwt_parts.payload_decoded(), key)
    return (
        _whole_field_signals(parsed, name)
        .merge(_field_components_signals(parsed, name))
        .usize_input(f"{name}_name_len", len(key))
    )


def private_aud_value(vi: VerifiedInput) -> str:
    if vi.skip_aud_checks:
        if vi.idc_aud is not None:
            raise ValueError("there is no aud-based recovery in aud-less mode")
        return ""
    if vi.idc_aud is not None:
        return vi.idc_aud
    return vi.jwt.payload.aud


def override_aud_value(vi: VerifiedInput) -> str:
    return vi.jwt.payload.aud if vi.idc_aud is not None else ""


def _aud_signals(vi: VerifiedInput) -> CircuitInputSignals:
    parsed = find_and_parse_field(vi.jwt_parts.payload_decoded(), "aud")
    priv = private_aud_value(vi)
    override = override_aud_value(vi)
    return (
        _whole_field_signals(parsed, "aud")
        .usize_input("aud_colon_index", parsed.colon_index)
        .str_input("aud_name", parsed.key)
        .usize_input("aud_value_index", parsed.value_index)
        .usize_input("private_aud_value_len", len(priv))
        .str_input("private_aud_value", priv)
        .usize_input("override_aud_value_len", len(override))
        .str_input("override_aud_value", override)
        .bool_input("use_aud_override", vi.idc_aud is not None)
    )


def parsed_email_verified_field_or_default(vi: VerifiedInput) -> ParsedField:
    if vi.uid_key == "email":
        return find_and_parse_field(vi.jwt_parts.payload_decoded(), "email_verified")
    return ParsedField(
        index=1,
        key="email_verified",
        value="true",
        colon_index=16,
        value_index=17,
        whole_field='"email_verified":true,',
    )


def parsed_extra_field_or_default(vi: VerifiedInput) -> ParsedField:
    if vi.extra_field is not None:
        return find_and_parse_field(vi.jwt_parts.payload_decoded(), vi.extra_field)
    return ParsedField(
        index=1, key="", value="", colon_index=0, value_index=0, whole_field=" "
    )


def field_check_input_signals(vi: VerifiedInput) -> CircuitInputSignals:
    ev = parsed_email_verified_field_or_default(vi)
    extra = parsed_extra_field_or_default(vi)
    return (
        _signals_for_field(vi, "iss")
        .merge(_signals_for_field(vi, "nonce"))
        .merge(_signals_for_field(vi, "iat"))
        .merge(_signals_for_field_with_key(vi, "uid", vi.uid_key))
        .merge(_whole_field_signals(extra, "extra"))
        .merge(_whole_field_signals(ev, "ev").merge(_field_components_signals(ev, "ev")))
        .merge(_aud_signals(vi))
    )
