"""ctypes wrapper for the native BN254 pairing (native/bn254_pairing.c).

Generates the Montgomery/Frobenius constants header with host integers
(nothing hand-copied into C), compiles the shared library at first use
with gcc into `build/pairing/<hash>/` beside the package (the hash over the
source, the header, the flags and what -march=native means on this host,
as circuits/witness_engine.py builds its engine), and exposes:

    pairing_check(pairs) -> bool     # prod e(Pi, Qi) == 1
    pairing(p1, p2) -> tuple         # one e(P, Q), 6 Fq2 coeffs of w^i
    groth16_blind(...) -> (pi_a, pi_b, pi_c)   # a proof's blinding tail
    g1_mul(p, k), g2_mul(p, k)       # one scalar multiplication

Used by groth16.pairing.verify_groth16 whenever `available()` (the
reference verifies through ark-groth16 natives, prover_handler.rs:329-336),
and always by groth16.prover.blind, which has no fallback; the pure-Python
tower and `blind_plain` stay the independent cross-checks. The service
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
        for name in ("bn254_miller_test", "bn254_fq_mul_test", "bn254_g1_mul", "bn254_g2_mul"):
            getattr(lib, name).argtypes = [u64p, u64p, u64p]
            getattr(lib, name).restype = None
        lib.bn254_groth16_blind.argtypes = [u64p, u64p, u64p, u64p]
        lib.bn254_groth16_blind.restype = None
        _lib = lib
        return lib


def build_error() -> str | None:
    """Why the native library is unavailable (None if it loaded or was never
    tried)."""
    return _lib_error


def available() -> bool:
    return _load_lib() is not None


def _put(buf, off: int, values) -> None:
    """Standard-form ints as 4 limbs each into buf[off:], reduced mod q
    here: the Python curve helpers (groth16/pairing.py _add/multiply)
    return lazily-unreduced ints."""
    for j, v in enumerate(values):
        buf[off + 4 * j : off + 4 * j + 4] = _limbs(v % Q)


def _get(buf, off: int, n: int) -> list[int]:
    return [sum(int(buf[off + 4 * j + i]) << (64 * i) for i in range(4)) for j in range(n)]


def _put_g1(buf, k: int, p) -> None:
    """G1 point k of buf (8 words each); None, the point at infinity, stays
    all zero."""
    if p is not None:
        _put(buf, 8 * k, p)


def _put_g2(buf, k: int, p) -> None:
    if p is not None:
        _put(buf, 16 * k, (*p[0], *p[1]))


def _get_g1(buf, off: int):
    x, y = _get(buf, off, 2)
    return None if x == y == 0 else (x, y)


def _get_g2(buf, off: int):
    x0, x1, y0, y1 = _get(buf, off, 4)
    return None if x0 == x1 == y0 == y1 == 0 else ((x0, x1), (y0, y1))


def _pack_points(pairs) -> tuple:
    n = len(pairs)
    g1 = (ctypes.c_uint64 * (8 * n))()
    g2 = (ctypes.c_uint64 * (16 * n))()
    for k, (p1, p2) in enumerate(pairs):
        _put_g1(g1, k, p1)
        _put_g2(g2, k, p2)
    return g1, g2, n


def _scalars(*ks: int):
    return (ctypes.c_uint64 * (4 * len(ks)))(*(l for k in ks for l in _limbs(k % bn254.R_SCALAR)))


def _loaded():
    lib = _load_lib()
    if lib is None:
        raise RuntimeError("native pairing unavailable")
    return lib


def pairing_check(pairs) -> bool:
    """pairs: list of ((x, y) | None, ((x0,x1),(y0,y1)) | None).
    Returns prod e(Pi, Qi) == 1. Raises RuntimeError if unavailable."""
    lib = _loaded()
    g1, g2, n = _pack_points(pairs)
    return bool(lib.bn254_pairing_check(g1, g2, n))


def pairing(p1: tuple, p2: tuple) -> tuple:
    """One full pairing e(P, Q) -> ((c0,c1) x 6) standard-form coefficients
    of w^0..w^5 (w^6 = 9+u tower) — for differential tests."""
    lib = _loaded()
    out = (ctypes.c_uint64 * 48)()
    g1, g2, _ = _pack_points([(p1, p2)])
    lib.bn254_miller_test(out, g1, g2)
    vals = _get(out, 0, 12)
    return tuple(zip(vals[0::2], vals[1::2]))


def fq_mul_test(a: int, b: int) -> int:
    lib = _load_lib()
    out = (ctypes.c_uint64 * 4)()
    aa = (ctypes.c_uint64 * 4)(*_limbs(a))
    bb = (ctypes.c_uint64 * 4)(*_limbs(b))
    lib.bn254_fq_mul_test(out, aa, bb)
    return sum(int(out[j]) << (64 * j) for j in range(4))


def g1_mul(p, k: int):
    """k * p for a G1 affine point (None = infinity), k reduced mod r as
    curves/ref_curve.py `GroupOps.mul` reduces it."""
    lib = _loaded()
    buf, out = (ctypes.c_uint64 * 8)(), (ctypes.c_uint64 * 8)()
    _put_g1(buf, 0, p)
    lib.bn254_g1_mul(out, buf, _scalars(k))
    return _get_g1(out, 0)


def g2_mul(p, k: int):
    """k * p for a G2 affine point ((x0, x1), (y0, y1)) or None."""
    lib = _loaded()
    buf, out = (ctypes.c_uint64 * 16)(), (ctypes.c_uint64 * 16)()
    _put_g2(buf, 0, p)
    lib.bn254_g2_mul(out, buf, _scalars(k))
    return _get_g2(out, 0)


def groth16_blind(a, b1, b2, c, h, alpha1, beta1, beta2, delta1, delta2, r: int, s: int) -> tuple:
    """A proof's blinding (groth16/prover.py `blind`) in one native call:
    (pi_a, pi_b, pi_c) as affine host points, None for infinity. ctypes
    lets go of the GIL for the call."""
    lib = _loaded()
    g1 = (ctypes.c_uint64 * (8 * 7))()
    g2 = (ctypes.c_uint64 * (16 * 3))()
    for k, p in enumerate((a, b1, c, h, alpha1, beta1, delta1)):
        _put_g1(g1, k, p)
    for k, p in enumerate((b2, beta2, delta2)):
        _put_g2(g2, k, p)
    out = (ctypes.c_uint64 * 32)()
    lib.bn254_groth16_blind(out, g1, g2, _scalars(r, s, r * s))
    return _get_g1(out, 0), _get_g2(out, 8), _get_g1(out, 24)
