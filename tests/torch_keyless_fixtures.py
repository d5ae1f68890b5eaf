"""Shared inputs for the port's keyless parity tests: the scaled-down
keyless configuration of tests/test_keyless_circuit.py in both packages, and
a test JWT from the port's seeded generator handed to the JAX package as its
own VerifiedInput (the same JWT string and fields)."""

import dataclasses

from keyless_zk_tpu.input_processing.jwt import DecodedJWT as JaxDecodedJWT
from keyless_zk_tpu.input_processing.jwt import JwtParts as JaxJwtParts
from keyless_zk_tpu.input_processing.types import VerifiedInput as JaxVerifiedInput
from keyless_zk_tpu_torch.circuits.keyless_circuit import KeylessConfig
from test_keyless_circuit import SMALL as JAX_SMALL

SMALL = KeylessConfig(**dataclasses.asdict(JAX_SMALL))


def jax_verified_input(vi):
    """The port's VerifiedInput as the JAX package's dataclass."""
    fields = {f.name: getattr(vi, f.name) for f in dataclasses.fields(vi)}
    jwt_str = vi.jwt_parts.header + "." + vi.jwt_parts.payload + "." + vi.jwt_parts.signature
    fields["jwt"] = JaxDecodedJWT.from_b64(jwt_str)
    fields["jwt_parts"] = JaxJwtParts.from_b64(jwt_str)
    return JaxVerifiedInput(**fields)
