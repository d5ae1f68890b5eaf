"""snarkjs binary container (.zkey / .wtns) reader.

Same on-disk format the reference parses with mmap in
rust-rapidsnark/rapidsnark/src/binfile_utils.cpp:1-60: 4-byte magic,
u32 version, u32 nSections, then sections of (u32 type, u64 size, payload).
Here the file is read into one numpy buffer and sections are zero-copy
views — the host-side ingestion path that feeds device uploads.

A jax-free copy of keyless_zk_tpu/groth16/binfile.py: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np


@dataclass
class BinFile:
    data: np.ndarray  # uint8 view of the whole file
    magic: str
    version: int
    sections: dict = field(default_factory=dict)  # type -> list[(offset, size)]

    @classmethod
    def load(cls, path: str, expected_magic: str, max_version: int = 2) -> "BinFile":
        raw = np.fromfile(path, dtype=np.uint8)
        if raw.size < 12:
            raise ValueError(f"{path}: too small for a snarkjs container")
        magic = bytes(raw[:4]).decode("latin1")
        if magic != expected_magic:
            raise ValueError(f"{path}: bad magic {magic!r}, expected {expected_magic!r}")
        version, n_sections = struct.unpack_from("<II", raw, 4)
        if version > max_version:
            raise ValueError(f"{path}: version {version} > {max_version}")
        sections: dict = {}
        pos = 12
        for _ in range(n_sections):
            s_type, s_size = struct.unpack_from("<IQ", raw, pos)
            pos += 12
            sections.setdefault(s_type, []).append((pos, s_size))
            pos += s_size
        return cls(data=raw, magic=magic, version=version, sections=sections)

    def section(self, s_type: int, pos: int = 0) -> np.ndarray:
        off, size = self.sections[s_type][pos]
        return self.data[off : off + size]

    def section_size(self, s_type: int, pos: int = 0) -> int:
        return self.sections[s_type][pos][1]


def read_u32s(buf: np.ndarray, offset: int, count: int) -> np.ndarray:
    return buf[offset : offset + 4 * count].view(np.uint32).copy()


def le_bytes_to_int(buf: np.ndarray) -> int:
    return int.from_bytes(bytes(buf), "little")
