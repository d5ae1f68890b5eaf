"""Circuit configuration: per-signal max lengths + feature flags.

Mirror of keyless-common/src/input_processing/circuit_config.rs:8-53; the
YAML file (circuit_config.yml) ships with each circuit setup and is the
contract between circuit version and service.

A jax-free copy of keyless_zk_tpu/input_processing/circuit_config.py: the port
imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class CircuitConfig:
    max_lengths: dict[str, int] = field(default_factory=dict)
    has_input_skip_aud_checks: bool = False

    def get_max_length(self, key: str) -> int:
        if key not in self.max_lengths:
            raise KeyError(f"unknown circuit signal max-length key: {key}")
        return self.max_lengths[key]

    @classmethod
    def from_yaml(cls, path: str) -> "CircuitConfig":
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f)
        return cls(
            max_lengths=dict(raw["max_lengths"]),
            has_input_skip_aud_checks=bool(raw.get("has_input_skip_aud_checks", False)),
        )


# The production configuration shipped with the reference service
# (prover-service/circuit_config.yml:1-33), used as the default.
DEFAULT_MAX_LENGTHS = {
    "b64u_jwt_no_sig_sha2_padded": 1536,
    "b64u_jwt_header_w_dot": 300,
    "b64u_jwt_payload_sha2_padded": 1472,
    "b64u_jwt_payload": 1472,
    "sha2_num_bits": 8,
    "sha2_padding": 64,
    "epk": 3,
    "iss_field": 140,
    "iss_field_string_bodies": 140,
    "iss_name": 40,
    "iss_value": 120,
    "extra_field": 350,
    "ev_field": 30,
    "ev_name": 20,
    "ev_value": 10,
    "nonce_field": 105,
    "nonce_field_string_bodies": 105,
    "nonce_name": 10,
    "nonce_value": 100,
    "aud_field": 140,
    "aud_field_string_bodies": 140,
    "aud_name": 40,
    "private_aud_value": 120,
    "override_aud_value": 120,
    "iat_field": 50,
    "iat_name": 10,
    "iat_value": 45,
    "uid_field": 350,
    "uid_field_string_bodies": 350,
    "uid_name": 30,
    "uid_value": 330,
}


def default_circuit_config() -> CircuitConfig:
    return CircuitConfig(
        max_lengths=dict(DEFAULT_MAX_LENGTHS), has_input_skip_aud_checks=True
    )
