"""JWT field parser: locate and dissect `"key" : value [,}]` in a payload.

Mirror of prover-service/src/input_processing/field_parser.rs:47-204,
including its index conventions (colon_index/value_index are relative to the
start of the whole field; for quoted values value_index points at the first
character *after* the opening quote).

A jax-free copy of keyless_zk_tpu/input_processing/field_parser.py: the port
imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass


class FieldParserError(ValueError):
    pass


@dataclass
class ParsedField:
    index: int  # offset of the field within the JWT payload
    key: str
    value: str
    colon_index: int
    value_index: int
    whole_field: str


class _Parser:
    def __init__(self, s: str):
        self.s = s
        self.pos = 0

    def _peek(self) -> str:
        if self.pos >= len(self.s):
            raise FieldParserError(f"Unexpected end of stream at {self.pos} of {self.s!r}")
        return self.s[self.pos]

    def _pop(self) -> str:
        c = self._peek()
        self.pos += 1
        return c

    def _skip_spaces(self) -> None:
        while self._peek() == " ":
            self.pos += 1

    def _consume_non_whitespace_char(self, options: str) -> int:
        self._skip_spaces()
        c = self._peek()
        if c not in options:
            raise FieldParserError(
                f"Expected a character in {options!r}, got {c!r} at {self.pos} of {self.s!r}"
            )
        idx = self.pos
        self.pos += 1
        return idx

    def _consume_string(self) -> tuple[int, str]:
        if self._peek() != '"':
            raise FieldParserError(f"Expected a string at {self.pos} of {self.s!r}")
        self._pop()
        index = self.pos
        out = []
        while self._peek() != '"':
            out.append(self._pop())
        self._pop()
        return index, "".join(out)

    def _consume_unquoted(self) -> tuple[int, str]:
        index = self.pos
        out = []
        while self._peek() not in ' ,}':
            out.append(self._pop())
        return index, "".join(out)

    def _consume_value(self) -> tuple[int, str]:
        self._skip_spaces()
        if self._peek() == '"':
            return self._consume_string()
        return self._consume_unquoted()

    def parse(self) -> ParsedField:
        _, key = self._consume_string()
        colon_index = self._consume_non_whitespace_char(":")
        value_index, value = self._consume_value()
        end_index = self._consume_non_whitespace_char(",}")
        return ParsedField(
            index=0,
            key=key,
            value=value,
            colon_index=colon_index,
            value_index=value_index,
            whole_field=self.s[: end_index + 1],
        )


def find_and_parse_field(jwt_payload: str, key: str) -> ParsedField:
    needle = f'"{key}"'
    index = jwt_payload.find(needle)
    if index < 0:
        raise FieldParserError(f"Could not find {needle} in jwt payload")
    parsed = _Parser(jwt_payload[index:]).parse()
    parsed.index = index
    return parsed
