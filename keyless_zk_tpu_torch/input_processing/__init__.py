"""Input processing: prove-request -> circuit input signals.

Python re-implementation of the reference's L4 layer
(keyless-common/src/input_processing/ and
prover-service/src/input_processing/): JWT decomposition, SHA2 padding,
per-field parse hints, Poseidon public-inputs hash, and the typed signal
map with its padding contract (circuit_config.yml).

A jax-free copy of keyless_zk_tpu/input_processing/__init__.py: the port
imports nothing of the JAX package.
"""

from .circuit_config import CircuitConfig
from .jwt import DecodedJWT, JwtParts
from .signals import CircuitInputSignals
from .types import VerifiedInput

__all__ = ["CircuitConfig", "DecodedJWT", "JwtParts", "CircuitInputSignals", "VerifiedInput"]
