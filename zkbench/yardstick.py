"""The benchmark's own measures of work: the table of peaks and the
bytes that the five MSMs of a proof must move, counted from the proving
key file itself (the snarkjs .zkey the service loads), never from the
program's tables or its scan streams.

The floor for one batch of B proofs: each distinct point of each of the
key's five tables (A, B1, B2, C, H; the point at infinity excluded) read
once (G1 64 B, G2 128 B affine), each proof's scalars read once (the
witness, n_vars x 32 B, and the h scalars, domain x 32 B), and each
proof's five results written once (four G1 and one G2, affine). Bound:
bytes. No operation term: no floor on BN254 products is written down yet
that holds both for integer multiply-adds and for tensor-core routes.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

# Published peaks (NVIDIA data sheets), by the name torch.cuda gives a
# card: HBM bytes per second.
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,  # H100 SXM5
}

G1_BYTES, G2_BYTES, SCALAR_BYTES = 64, 128, 32
TABLES = {"a": (5, G1_BYTES), "b1": (6, G1_BYTES), "b2": (7, G2_BYTES), "c": (8, G1_BYTES), "h": (9, G1_BYTES)}


def _sections(path: Path) -> dict:
    """{section type: (offset, size)} of a snarkjs binary container."""
    with open(path, "rb") as f:
        head = f.read(12)
        if head[:4] != b"zkey":
            raise ValueError(f"{path} is not a zkey")
        (n_sections,) = struct.unpack_from("<I", head, 8)
        out, pos = {}, 12
        for _ in range(n_sections):
            f.seek(pos)
            s_type, size = struct.unpack("<IQ", f.read(12))
            out[s_type] = (pos + 12, size)
            pos += 12 + size
    return out


def zkey_vk(path: Path, q: int) -> dict:
    """The verification key that a zkey carries, in standard form over
    the base field `q`: its header's alpha1, beta2, gamma2 and delta2
    (section 2) and its IC points (section 3, empty where the key keeps
    its vk apart), each coordinate read from the little-endian Montgomery
    bytes (x R mod q, R = 2^(8 n8q)). None stands for the point at infinity
    (all-zero bytes). Refused where the header's q is not `q`."""
    secs = _sections(path)
    with open(path, "rb") as f:
        f.seek(secs[2][0])
        s2 = f.read(secs[2][1])
        f.seek(secs[3][0])
        s3 = f.read(secs[3][1])
    (n8q,) = struct.unpack_from("<I", s2, 0)
    if int.from_bytes(s2[4:4 + n8q], "little") != q:
        raise ValueError(f"{path}: the key's base field is not the one expected")
    (n8r,) = struct.unpack_from("<I", s2, 4 + n8q)
    pos = 8 + n8q + n8r + 12
    r_inv = pow(1 << (8 * n8q), -1, q)

    def fq(buf, at):
        return int.from_bytes(buf[at:at + n8q], "little") * r_inv % q

    def g1(buf, at):
        return None if not any(buf[at:at + 2 * n8q]) else (fq(buf, at), fq(buf, at + n8q))

    def g2(buf, at):
        if not any(buf[at:at + 4 * n8q]):
            return None
        c = [fq(buf, at + i * n8q) for i in range(4)]
        return ((c[0], c[1]), (c[2], c[3]))

    g1b, g2b = 2 * n8q, 4 * n8q
    alpha1 = g1(s2, pos)
    beta2 = g2(s2, pos + 2 * g1b)
    gamma2 = g2(s2, pos + 2 * g1b + g2b)
    delta2 = g2(s2, pos + 3 * g1b + 2 * g2b)
    ic = [g1(s3, at) for at in range(0, len(s3), g1b)]
    return {"alpha1": alpha1, "beta2": beta2, "gamma2": gamma2, "delta2": delta2, "ic": ic}


def distinct_points(path: Path, s_type: int, point_bytes: int) -> int:
    """Distinct points other than infinity (all-zero records) in a table
    of the key: equal Montgomery bytes are equal points."""
    secs = _sections(path)
    off, size = secs[s_type]
    rows = np.memmap(path, dtype=np.uint8, mode="r", offset=off, shape=(size // point_bytes, point_bytes))
    view = np.ascontiguousarray(rows).view(np.dtype((np.void, point_bytes))).ravel()
    uniq = np.unique(view)
    zero = np.zeros(1, dtype=np.uint8).repeat(point_bytes).view(np.dtype((np.void, point_bytes)))[0]
    return int(uniq.size - np.count_nonzero(uniq == zero))


def key_counts(path: Path, cache_dir: Path | None = None) -> dict:
    """{n_vars, n_public, domain_size, distinct: {table: count}} of a zkey,
    kept in `cache_dir` under the file's size and modification time."""
    path = Path(path)
    st = path.stat()
    stamp = f"{st.st_size}-{st.st_mtime_ns}"
    memo = Path(cache_dir) / "key_counts.json" if cache_dir else None
    if memo is not None and memo.exists():
        saved = json.loads(memo.read_text())
        if saved.get("stamp") == stamp:
            return saved["counts"]
    secs = _sections(path)
    off, _ = secs[2]
    with open(path, "rb") as f:
        f.seek(off)
        raw = f.read(4)
        (n8q,) = struct.unpack("<I", raw)
        f.seek(off + 4 + n8q)
        (n8r,) = struct.unpack("<I", f.read(4))
        f.seek(off + 8 + n8q + n8r)
        n_vars, n_public, domain_size = struct.unpack("<III", f.read(12))
    counts = {"n_vars": n_vars, "n_public": n_public, "domain_size": domain_size,
              "distinct": {t: distinct_points(path, s, b) for t, (s, b) in TABLES.items()}}
    if memo is not None:
        memo.parent.mkdir(parents=True, exist_ok=True)
        memo.write_text(json.dumps({"stamp": stamp, "counts": counts}))
    return counts


def msm_floor_bytes(counts: dict, batch: int) -> int:
    """Bytes the five MSMs of a batch of `batch` proofs must move."""
    points = sum(counts["distinct"][t] * b for t, (_, b) in TABLES.items())
    scalars = (counts["n_vars"] + counts["domain_size"]) * SCALAR_BYTES
    results = 4 * G1_BYTES + G2_BYTES
    return points + batch * (scalars + results)
