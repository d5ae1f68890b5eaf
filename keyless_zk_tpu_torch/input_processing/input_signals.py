"""derive_circuit_input_signals: verified request -> padded signal map.

Mirror of prover-service/src/input_processing/input_signals.rs:18-96 —
builds the ~70 named circuit inputs (b64u JWT segments, SHA2 padding
pieces, 32x64-bit signature/modulus limbs, packed epk scalars, pepper,
per-field parse hints) and pads them per the circuit config.

A jax-free copy of keyless_zk_tpu/input_processing/input_signals.py: the port
imports nothing of the JAX package.
"""

from __future__ import annotations

from . import field_check_input
from .circuit_config import CircuitConfig
from .jwt import payload_with_padding
from .public_inputs_hash import (
    MAX_COMMITTED_EPK_BYTES,
    compute_ephemeral_pubkey_frs,
    compute_public_inputs_hash,
)
from .sha_padding import compute_sha_padding, jwt_bit_len_binary, with_sha_padding_bytes
from .signals import CircuitInputSignals
from .types import VerifiedInput


def to_64bit_limbs(value: int, n_limbs: int = 32) -> list[int]:
    """Little-endian 64-bit limb decomposition (encoding.rs:54-62)."""
    return [(value >> (64 * i)) & ((1 << 64) - 1) for i in range(n_limbs)]


def derive_circuit_input_signals(
    config: CircuitConfig,
    vi: VerifiedInput,
    max_committed_epk_bytes: int = MAX_COMMITTED_EPK_BYTES,
) -> tuple[CircuitInputSignals, int]:
    """Returns (padded signals, public_inputs_hash)."""
    epk_frs, epk_len = compute_ephemeral_pubkey_frs(vi, max_committed_epk_bytes)
    public_inputs_hash = compute_public_inputs_hash(config, vi, max_committed_epk_bytes)

    unsigned = vi.jwt_parts.unsigned_undecoded().encode()
    padded_jwt = with_sha_padding_bytes(unsigned)

    signals = (
        CircuitInputSignals()
        .bytes_input("b64u_jwt_no_sig_sha2_padded", padded_jwt)
        .str_input("b64u_jwt_header_w_dot", vi.jwt_parts.header_undecoded_with_dot())
        .bytes_input("b64u_jwt_payload_sha2_padded", payload_with_padding(padded_jwt))
        .str_input("b64u_jwt_payload", vi.jwt_parts.payload_undecoded())
        .usize_input(
            "b64u_jwt_header_w_dot_len", len(vi.jwt_parts.header_undecoded_with_dot())
        )
        .usize_input(
            "b64u_jwt_payload_sha2_padded_len", len(vi.jwt_parts.payload_undecoded())
        )
        .usize_input("sha2_num_blocks", len(padded_jwt) * 8 // 512)
        .bytes_input("sha2_num_bits", jwt_bit_len_binary(unsigned))
        .bytes_input("sha2_padding", compute_sha_padding(unsigned, with_length=False))
        .limbs_input("signature", to_64bit_limbs(vi.jwt.signature))
        .limbs_input("pubkey_modulus", to_64bit_limbs(vi.pubkey_modulus))
        .u64_input("exp_date", vi.exp_date_secs)
        .u64_input("exp_horizon", vi.exp_horizon_secs)
        .frs_input("epk", epk_frs)
        .fr_input("epk_len", epk_len)
        .fr_input("epk_blinder", vi.epk_blinder_fr)
        .fr_input("pepper", vi.pepper_fr)
        .bool_input("use_extra_field", vi.use_extra_field())
    )
    if config.has_input_skip_aud_checks:
        signals.bool_input("skip_aud_checks", vi.skip_aud_checks)
    signals.fr_input("public_inputs_hash", public_inputs_hash)
    signals.merge(field_check_input.field_check_input_signals(vi))
    return signals.pad(config), public_inputs_hash
