"""Service configuration (YAML).

Mirror of prover-service/src/external_resources/prover_config.rs:17-120:
`ProverServiceConfig` with serde-style defaults, path helpers into the
content-addressed setup directory, and `load_circuit_params()` for the
per-setup circuit_config.yml contract.

A jax-free copy of keyless_zk_tpu/service/config.py. The default setup
root is this package's own (~/.local/share/keyless_zk_tpu_torch/setups),
never the JAX package's.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from ..input_processing.circuit_config import CircuitConfig, default_circuit_config

DEFAULT_SETUP_ROOT = os.path.expanduser("~/.local/share/keyless_zk_tpu_torch/setups")

# Fields the reference's config has (so a config file that sets them is not
# refused as unknown) but that nothing here implements: any value other
# than the default is refused by `check_supported`.
NOT_IMPLEMENTED = {
    "enable_test_provider": "the test OIDC provider is not implemented",
    "enable_federated_jwks": "federated JWK lookup is not implemented",
}


@dataclass
class ProverServiceConfig:
    setup_dir: str = "default"
    resources_dir: str = DEFAULT_SETUP_ROOT
    zkey_filename: str = "prover_key.zkey"
    vk_filename: str = "verification_key.json"
    circuit_config_filename: str = "circuit_config.yml"
    oidc_providers: list = field(default_factory=list)  # [{iss, endpoint_url}]
    jwk_refresh_rate_secs: int = 10
    port: int = 8083
    metrics_port: int = 9100
    enable_debug_checks: bool = False
    enable_test_provider: bool = False  # NOT_IMPLEMENTED
    enable_federated_jwks: bool = False  # NOT_IMPLEMENTED
    max_committed_epk_bytes: int = 93  # prover_config.rs default
    # batched proving: concurrent requests coalesce into batches of at most
    # max_batch proofs (parallel/batch_prover.py)
    batch_proving: bool = False
    max_batch: int = 8
    # HTTP backpressure: bounded in-flight requests (503 beyond) + socket
    # read timeout, standing in for the reference's tokio-bounded semantics
    max_inflight_requests: int = 32
    request_timeout_secs: int = 30
    # Production guard: the pure-Python pairing fallback verifies a proof in
    # about half a second (the native one in tens of ms); a silently
    # degraded deployment must fail its healthcheck instead of limping.
    require_native_pairing: bool = False

    @classmethod
    def from_yaml(cls, path: str) -> "ProverServiceConfig":
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        known = {k: v for k, v in raw.items() if k in cls.__dataclass_fields__}
        unknown = set(raw) - set(known)
        if unknown:  # deny_unknown_fields (prover_config.rs:17)
            raise ValueError(f"unknown config fields: {sorted(unknown)}")
        config = cls(**known)
        config.check_supported()
        return config

    def check_supported(self) -> None:
        """Refuse a value other than the default in a NOT_IMPLEMENTED field,
        and a batch of fewer than one proof."""
        bad = [f"{k}: {getattr(self, k)!r} ({why})" for k, why in NOT_IMPLEMENTED.items()
               if getattr(self, k) != self.__dataclass_fields__[k].default]
        if self.max_batch < 1:
            bad.append(f"max_batch: {self.max_batch!r} (a batch holds at least one proof)")
        if bad:
            raise ValueError("unsupported config: " + "; ".join(bad))

    # ---- path helpers (prover_config.rs:55-104) ----
    def setup_path(self, *parts: str) -> str:
        return os.path.join(self.resources_dir, self.setup_dir, *parts)

    def zkey_path(self) -> str:
        return self.setup_path(self.zkey_filename)

    def vk_path(self) -> str:
        return self.setup_path(self.vk_filename)

    def circuit_config_path(self) -> str:
        return self.setup_path(self.circuit_config_filename)

    def load_circuit_params(self) -> CircuitConfig:
        path = self.circuit_config_path()
        if os.path.exists(path):
            return CircuitConfig.from_yaml(path)
        return default_circuit_config()
