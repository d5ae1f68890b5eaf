"""Typed circuit-input signal map with merge/pad/JSON semantics.

Mirror of keyless-common/src/input_processing/circuit_input_signals.rs:
signal kinds U64/Fr/Frs/Limbs/Bytes; `merge` refuses redefinition
(:138-156); `pad` zero-extends Bytes (max length required) and Limbs
(max length optional) per the circuit config (:159-251); JSON output
stringifies every number decimally (:253-280).

A jax-free copy of keyless_zk_tpu/input_processing/signals.py: the port
imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Any

from .circuit_config import CircuitConfig


class Kind(Enum):
    U64 = "u64"
    FR = "fr"
    FRS = "frs"
    LIMBS = "limbs"
    BYTES = "bytes"


@dataclass
class Signal:
    kind: Kind
    value: Any


class CircuitInputSignals:
    def __init__(self):
        self.signals: dict[str, Signal] = {}
        self.padded = False

    # ---- input methods (mirror the Rust type's methods) ----
    def _put(self, name: str, kind: Kind, value) -> "CircuitInputSignals":
        self.signals[name] = Signal(kind, value)
        return self

    def bytes_input(self, name: str, value: bytes):
        return self._put(name, Kind.BYTES, bytes(value))

    def str_input(self, name: str, value: str):
        return self._put(name, Kind.BYTES, value.encode())

    def bools_input(self, name: str, value):
        return self._put(name, Kind.BYTES, bytes(1 if b else 0 for b in value))

    def byte_input(self, name: str, value: int):
        return self._put(name, Kind.U64, int(value))

    def usize_input(self, name: str, value: int):
        return self._put(name, Kind.U64, int(value))

    def u64_input(self, name: str, value: int):
        return self._put(name, Kind.U64, int(value))

    def bool_input(self, name: str, value: bool):
        return self._put(name, Kind.U64, int(bool(value)))

    def fr_input(self, name: str, value: int):
        return self._put(name, Kind.FR, int(value))

    def frs_input(self, name: str, value):
        return self._put(name, Kind.FRS, [int(v) for v in value])

    def limbs_input(self, name: str, value):
        return self._put(name, Kind.LIMBS, [int(v) for v in value])

    def merge(self, other: "CircuitInputSignals") -> "CircuitInputSignals":
        for key in other.signals:
            if key in self.signals:
                raise ValueError(f"Cannot redefine signal input: {key}")
        self.signals.update(other.signals)
        return self

    def pad(self, config: CircuitConfig) -> "CircuitInputSignals":
        out = CircuitInputSignals()
        out.padded = True
        for name, sig in self.signals.items():
            if sig.kind == Kind.BYTES:
                max_len = config.get_max_length(name)
                if len(sig.value) > max_len:
                    raise ValueError(
                        f"Max byte size exceeded for {name}: {len(sig.value)} > {max_len}"
                    )
                out.signals[name] = Signal(
                    Kind.BYTES, sig.value + b"\x00" * (max_len - len(sig.value))
                )
            elif sig.kind == Kind.LIMBS:
                max_len = config.max_lengths.get(name, len(sig.value))
                if len(sig.value) > max_len:
                    raise ValueError(
                        f"Max limb size exceeded for {name}: {len(sig.value)} > {max_len}"
                    )
                out.signals[name] = Signal(
                    Kind.LIMBS, sig.value + [0] * (max_len - len(sig.value))
                )
            else:
                out.signals[name] = sig
        return out

    def to_json_dict(self) -> dict:
        """Decimal-string form, the circom witness-generator input contract."""
        assert self.padded, "only padded signals serialize unambiguously"
        out = {}
        for name in sorted(self.signals):
            sig = self.signals[name]
            if sig.kind in (Kind.U64, Kind.FR):
                out[name] = str(sig.value)
            elif sig.kind in (Kind.FRS, Kind.LIMBS):
                out[name] = [str(v) for v in sig.value]
            else:
                out[name] = [str(b) for b in sig.value]
        return out
