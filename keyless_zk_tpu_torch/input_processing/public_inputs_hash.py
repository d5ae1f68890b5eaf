"""Public-inputs hash: the circuit's single public input.

Mirror of prover-service/src/input_processing/public_inputs_hash.rs:
IDC = Poseidon(pepper, aud_hash, uid_val_hash, uid_key_hash) (:16-48);
public_inputs_hash = Poseidon(14) over [epk0..2, epk_len, idc, exp_date,
exp_horizon, iss_hash, use_extra, extra_hash, header_hash, pubkey_hash,
override_aud_hash, use_override] (:76-147). Golden-tested against the
reference's pinned value (:219-222).

A jax-free copy of keyless_zk_tpu/input_processing/public_inputs_hash.py: the
port imports nothing of the JAX package.
"""

from __future__ import annotations

from . import field_check_input
from .circuit_config import CircuitConfig
from .hashing import (
    BYTES_PACKED_PER_SCALAR,
    hash_scalars,
    pad_and_hash_string,
    pad_and_pack_bytes_to_scalars_with_len,
    rsa_modulus_to_scalar,
)
from .types import VerifiedInput

EPHEMERAL_PUBKEY_FRS_LEN = 3
MAX_COMMITTED_EPK_BYTES = 93  # ProverServiceConfig default (prover_config.rs)
MAX_AUD_VAL_BYTES = 115  # aptos-types IdCommitment::MAX_AUD_VAL_BYTES


def compute_idc_hash(config: CircuitConfig, vi: VerifiedInput, pepper_fr: int) -> int:
    frs = [pepper_fr]
    frs.append(
        pad_and_hash_string(
            field_check_input.private_aud_value(vi),
            config.get_max_length("private_aud_value"),
        )
    )
    frs.append(pad_and_hash_string(vi.uid_val, config.get_max_length("uid_value")))
    frs.append(pad_and_hash_string(vi.uid_key, config.get_max_length("uid_name")))
    return hash_scalars(frs)


def compute_ephemeral_pubkey_frs(
    vi: VerifiedInput, max_committed_epk_bytes: int = MAX_COMMITTED_EPK_BYTES
) -> tuple[list[int], int]:
    frs = pad_and_pack_bytes_to_scalars_with_len(vi.epk_bytes, max_committed_epk_bytes)
    return frs[:EPHEMERAL_PUBKEY_FRS_LEN], frs[EPHEMERAL_PUBKEY_FRS_LEN]


def compute_public_inputs_hash(
    config: CircuitConfig,
    vi: VerifiedInput,
    max_committed_epk_bytes: int = MAX_COMMITTED_EPK_BYTES,
) -> int:
    epk_frs, epk_len = compute_ephemeral_pubkey_frs(vi, max_committed_epk_bytes)
    extra = field_check_input.parsed_extra_field_or_default(vi)

    frs = list(epk_frs)
    frs.append(epk_len)
    frs.append(compute_idc_hash(config, vi, vi.pepper_fr))
    frs.append(vi.exp_date_secs)
    frs.append(vi.exp_horizon_secs)
    frs.append(pad_and_hash_string(vi.jwt.payload.iss, config.get_max_length("iss_value")))
    frs.append(int(vi.use_extra_field()))
    frs.append(pad_and_hash_string(extra.whole_field, config.get_max_length("extra_field")))
    frs.append(
        pad_and_hash_string(
            vi.jwt_parts.header_undecoded_with_dot(),
            config.get_max_length("b64u_jwt_header_w_dot"),
        )
    )
    frs.append(rsa_modulus_to_scalar(vi.pubkey_modulus))
    frs.append(
        pad_and_hash_string(field_check_input.override_aud_value(vi), MAX_AUD_VAL_BYTES)
    )
    frs.append(int(vi.idc_aud is not None))
    return hash_scalars(frs)
