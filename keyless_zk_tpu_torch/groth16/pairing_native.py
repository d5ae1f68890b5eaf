"""ctypes wrapper for the native BN254 pairing (native/bn254_pairing.c).

Generates the Montgomery/Frobenius constants header with host integers
(nothing hand-copied into C), compiles the shared library at first use
with gcc into `build/pairing/<hash>/` beside the package (the hash over the
source, the header, the flags and what -march=native means on this host,
as circuits/witness_engine.py builds its engine), and exposes:

    pairing_check(pairs) -> bool     # prod e(Pi, Qi) == 1
    pairing(p1, p2) -> tuple         # one e(P, Q), 6 Fq2 coeffs of w^i

Used by groth16.pairing.verify_groth16 whenever `available()` (the
reference verifies through ark-groth16 natives, prover_handler.rs:329-336);
the pure-Python tower stays the independent cross-check. The service
reports which one it verifies with (service/prover_state.py
`check_pairing_backend`).

A jax-free copy of keyless_zk_tpu/groth16/pairing_native.py and its C
source, which the JAX package builds into the system temp directory.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ..fields import bn254

Q = bn254.Q
U = 4965661367192848881  # BN parameter: p = 36u^4+36u^3+24u^2+6u+1
SIX_U_PLUS_2 = 6 * U + 2

_SRC = Path(__file__).resolve().parent.parent / "native" / "bn254_pairing.c"
_BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "pairing"
_GCC_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_lib_lock = threading.Lock()
_lib = None
_lib_error: str | None = None  # why the build or load failed, once it has


def _limbs(x: int) -> list[int]:
    return [(x >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(4)]


def _fq2_pow(base: tuple, e: int) -> tuple:
    """(c0, c1) ** e in Fq2 = Fq[u]/(u^2+1)."""
    r = (1, 0)
    b = base
    while e:
        if e & 1:
            r = _fq2_mul(r, b)
        b = _fq2_mul(b, b)
        e >>= 1
    return r


def _fq2_mul(a: tuple, b: tuple) -> tuple:
    return (
        (a[0] * b[0] - a[1] * b[1]) % Q,
        (a[0] * b[1] + a[1] * b[0]) % Q,
    )


def _mont(x: int) -> int:
    return (x << 256) % Q


def _emit_fq2_mont(c: tuple) -> str:
    return "{{%s}, {%s}}" % (
        ", ".join(f"0x{v:016x}ull" for v in _limbs(_mont(c[0]))),
        ", ".join(f"0x{v:016x}ull" for v in _limbs(_mont(c[1]))),
    )


def _gen_header() -> str:
    xi = (9, 1)
    frob = []
    for power, exp_num in ((1, Q - 1), (2, Q * Q - 1), (3, Q**3 - 1)):
        rows = []
        for i in range(1, 6):
            g = _fq2_pow(xi, i * exp_num // 6)
            rows.append(_emit_fq2_mont(g))
        frob.append("{" + ", ".join(rows) + "}")

    n0 = (-pow(Q, -1, 1 << 64)) % (1 << 64)
    defs = []
    for name, val in (
        ("BN_P", Q),
        ("BN_R1_", (1 << 256) % Q),
        ("BN_R2_", (1 << 512) % Q),
        ("BN_PM2_", Q - 2),
    ):
        for i, l in enumerate(_limbs(val)):
            defs.append(f"#define {name}{i} 0x{l:016x}ull")
    defs.append(f"#define BN_N0 0x{n0:016x}ull")
    defs.append(f"#define BN_U 0x{U:016x}ull")
    defs.append(f"#define BN_S_LO 0x{SIX_U_PLUS_2 & ((1 << 64) - 1):016x}ull")
    defs.append(f"#define BN_S_HI 0x{SIX_U_PLUS_2 >> 64:016x}ull")
    defs.append(f"#define BN_S_BITS {SIX_U_PLUS_2.bit_length()}")
    defs.append(f"#define BN_FROB1 {frob[0]}")
    defs.append(f"#define BN_FROB2 {frob[1]}")
    defs.append(f"#define BN_FROB3 {frob[2]}")
    return "\n".join(defs) + "\n"


def _build_lib() -> Path:
    """Compile the library with gcc (cached by source, header, flags and
    host CPU); returns the .so path."""
    target = subprocess.run(["gcc", "-march=native", "-Q", "--help=target"], capture_output=True, text=True,
                            check=True).stdout
    header = _gen_header()
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(header.encode())
    h.update(" ".join(_GCC_FLAGS).encode())
    h.update(target.encode())
    out_dir = _BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / "libbn254_pairing.so"
    if lib.exists():
        return lib
    tmp = _BUILD_ROOT / f"tmp-{os.getpid()}-{time.time_ns()}"
    tmp.mkdir(parents=True)
    try:
        (tmp / "bn254_pairing_consts.h").write_text(header)
        subprocess.run(["gcc", *_GCC_FLAGS, f"-I{tmp}", "-o", str(tmp / lib.name), str(_SRC)], check=True,
                       capture_output=True, text=True)
        if not out_dir.exists():
            os.replace(tmp, out_dir)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def _load_lib():
    """The loaded library, or None when gcc or the build failed (the reason
    is kept in `build_error()`); built at most once per process."""
    global _lib, _lib_error
    with _lib_lock:
        if _lib is not None or _lib_error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build_lib()))
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", None) or ""
            _lib_error = f"{e} {detail}".strip()
            return None
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.bn254_pairing_check.argtypes = [u64p, u64p, ctypes.c_int]
        lib.bn254_pairing_check.restype = ctypes.c_int
        for name in ("bn254_miller_test", "bn254_fq_mul_test"):
            getattr(lib, name).argtypes = [u64p, u64p, u64p]
            getattr(lib, name).restype = None
        _lib = lib
        return lib


def build_error() -> str | None:
    """Why the native library is unavailable (None if it loaded or was never
    tried)."""
    return _lib_error


def available() -> bool:
    return _load_lib() is not None


def _pack_points(pairs) -> tuple:
    """Coordinates are reduced mod q here: the Python curve helpers
    (groth16/pairing.py _add/multiply) return lazily-unreduced ints."""
    n = len(pairs)
    g1 = (ctypes.c_uint64 * (8 * n))()
    g2 = (ctypes.c_uint64 * (16 * n))()
    for k, (p1, p2) in enumerate(pairs):
        if p1 is not None:
            for i, l in enumerate(_limbs(p1[0] % Q)):
                g1[8 * k + i] = l
            for i, l in enumerate(_limbs(p1[1] % Q)):
                g1[8 * k + 4 + i] = l
        if p2 is not None:
            (x0, x1), (y0, y1) = p2
            for off, v in ((0, x0 % Q), (4, x1 % Q), (8, y0 % Q), (12, y1 % Q)):
                for i, l in enumerate(_limbs(v)):
                    g2[16 * k + off + i] = l
    return g1, g2, n


def pairing_check(pairs) -> bool:
    """pairs: list of ((x, y) | None, ((x0,x1),(y0,y1)) | None).
    Returns prod e(Pi, Qi) == 1. Raises RuntimeError if unavailable."""
    lib = _load_lib()
    if lib is None:
        raise RuntimeError("native pairing unavailable")
    g1, g2, n = _pack_points(pairs)
    return bool(lib.bn254_pairing_check(g1, g2, n))


def pairing(p1: tuple, p2: tuple) -> tuple:
    """One full pairing e(P, Q) -> ((c0,c1) x 6) standard-form coefficients
    of w^0..w^5 (w^6 = 9+u tower) — for differential tests."""
    lib = _load_lib()
    if lib is None:
        raise RuntimeError("native pairing unavailable")
    out = (ctypes.c_uint64 * 48)()
    g1, g2, _ = _pack_points([(p1, p2)])
    lib.bn254_miller_test(out, g1, g2)
    coeffs = []
    for i in range(6):
        c0 = sum(int(out[8 * i + j]) << (64 * j) for j in range(4))
        c1 = sum(int(out[8 * i + 4 + j]) << (64 * j) for j in range(4))
        coeffs.append((c0, c1))
    return tuple(coeffs)


def fq_mul_test(a: int, b: int) -> int:
    lib = _load_lib()
    out = (ctypes.c_uint64 * 4)()
    aa = (ctypes.c_uint64 * 4)(*_limbs(a))
    bb = (ctypes.c_uint64 * 4)(*_limbs(b))
    lib.bn254_fq_mul_test(out, aa, bb)
    return sum(int(out[j]) << (64 * j) for j in range(4))
