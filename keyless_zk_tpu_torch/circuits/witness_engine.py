"""Native witness engine: compile ConstraintSystem ops to C bytecode.

The per-request hot path of the service is witness generation — the
reference forks a circom-generated C binary per request
(prover_handler.rs:541-572); here the ConstraintSystem's structured
witness ops compile once into flat tables executed by
native/witness_engine.c (4x64-bit Montgomery arithmetic, CIOS), with the
rare big-integer hints (RSA long division) calling back into Python.

Also exposes a native R1CS satisfaction check used by tests and the
service's debug mode.

A jax-free copy of keyless_zk_tpu/circuits/witness_engine.py: the port imports
nothing of the JAX package. Its C source is the package's own copy,
keyless_zk_tpu_torch/native/witness_engine.c, which gcc builds at first use
into `build/witness_engine/<hash>/` beside the package (a directory the
repository's .gitignore lists), keyed by the source, the flags and the host
CPU that -march=native targets. A failed build is an error: the Python
`ConstraintSystem.compute_witness` is not a fallback.
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

import numpy as np

from ..fields import bn254
from .r1cs import ConstraintSystem, LinComb

P = bn254.R_SCALAR
R256 = 1 << 256

_OPCODES = {
    "input": 0,
    "lc": 1,
    "mul": 2,
    "bits": 3,
    "iszero": 4,
    "onehot": 5,
    "quorem": 6,
    # python-callback ops
    "bigdiv": 7,
    "bigcarry": 7,
    "call": 7,
    # R1CS propagation solves (foreign circom R1CS, circom_witness.py)
    "fms": 8,
    "divsub": 9,
}

_SRC = Path(__file__).resolve().parent.parent / "native" / "witness_engine.c"
_BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "witness_engine"
_GCC_FLAGS = ["-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC"]

_PYCALL_T = ctypes.CFUNCTYPE(
    ctypes.c_int,
    ctypes.c_int64,
    ctypes.POINTER(ctypes.c_uint64),
    ctypes.c_int64,
    ctypes.POINTER(ctypes.c_uint64),
    ctypes.c_int64,
)

_lib_lock = threading.Lock()
_lib = None


def _build_lib() -> Path:
    """Compile the engine with gcc (cached by source, flags and host CPU)."""
    target = subprocess.run(["gcc", "-march=native", "-Q", "--help=target"], capture_output=True, text=True,
                            check=True).stdout
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_GCC_FLAGS).encode())
    h.update(target.encode())
    out_dir = _BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / "libwitness_engine.so"
    if lib.exists():
        return lib
    tmp = _BUILD_ROOT / f"tmp-{os.getpid()}-{time.time_ns()}"
    tmp.mkdir(parents=True)
    try:
        subprocess.run(["gcc", *_GCC_FLAGS, "-o", str(tmp / lib.name), str(_SRC)], check=True)
        if not out_dir.exists():
            os.replace(tmp, out_dir)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def _load_lib():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build_lib()))
        P64, P32, I64 = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32), ctypes.c_int64
        PU64 = ctypes.POINTER(ctypes.c_uint64)
        lib.witness_eval.argtypes = [P64, I64, P32, P32, PU64, P64, PU64, I64, _PYCALL_T]
        lib.witness_eval.restype = ctypes.c_int
        lib.r1cs_check.argtypes = [P64, I64, P32, PU64, PU64, I64]
        lib.r1cs_check.restype = ctypes.c_int64
        _lib = lib
        return lib


def _int_to_u64x4(x: int) -> tuple:
    return tuple((x >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(4))


def _u64x4_to_int(a) -> int:
    return int(a[0]) | (int(a[1]) << 64) | (int(a[2]) << 128) | (int(a[3]) << 192)


def _flatten_lcs(lcs: list[LinComb], mont: bool):
    """-> (offsets (n,2) int64, wires int32, coefs (t,4) uint64).

    Coefficient conversion is memoized: circuits reuse a small set of
    distinct coefficients (1, powers of two, round constants) across
    millions of terms, so the bigint work collapses to the distinct set.
    """
    total = sum(len(lc) for lc in lcs)
    offsets = np.zeros((len(lcs), 2), dtype=np.int64)
    wires = np.zeros(total, dtype=np.int32)
    coefs = np.zeros((total, 4), dtype=np.uint64)
    memo: dict[int, tuple] = {}
    pos = 0
    for i, lc in enumerate(lcs):
        offsets[i] = (pos, len(lc))
        for w, c in lc.items():
            conv = memo.get(c)
            if conv is None:
                conv = _int_to_u64x4(c * R256 % P if mont else c)
                memo[c] = conv
            wires[pos] = w
            coefs[pos] = conv
            pos += 1
    return offsets, wires, coefs


class CompiledWitnessProgram:
    """One ConstraintSystem compiled to engine tables (reusable across
    requests — the analog of the circom witness binary)."""

    def __init__(self, cs: ConstraintSystem):
        self.cs = cs
        self.lib = _load_lib()

        op_rows = []
        out_wires: list[int] = []
        all_lcs: list[LinComb] = []
        self._py_ops: dict[int, tuple] = {}
        self._input_slots: list[tuple] = []  # (name, out_ptr, count)

        for idx, (opcode, params, outs, in_lcs) in enumerate(cs.ops):
            out_ptr = len(out_wires)
            out_wires.extend(outs)
            lc_ptr = len(all_lcs)
            all_lcs.extend(in_lcs)
            p0 = 0
            if opcode == "input":
                self._input_slots.append((params[0], outs))
            elif opcode in ("onehot",):
                p0 = params[0]
            elif opcode == "quorem":
                p0 = params[0]
            elif opcode in ("bigdiv", "bigcarry", "call"):
                self._py_ops[idx] = (opcode, params)
            op_rows.append(
                [_OPCODES[opcode], p0, 0, out_ptr, len(outs), lc_ptr, len(in_lcs), 0]
            )

        self.op_table = np.asarray(op_rows, dtype=np.int64)
        self.out_wires = np.asarray(out_wires, dtype=np.int32)
        self.lc_offsets, self.lc_wires, self.lc_coefs = _flatten_lcs(all_lcs, mont=True)
        self.n_wires = cs.n_wires

        self._cb = _PYCALL_T(self._pycall)
        self._check_tables = None

    # ---- program serialization ------------------------------------------------
    #
    # The compiled tables are the analog of circom's main_c binary: build
    # once per circuit, reuse across service starts. Building them costs
    # ~2 min at the full config (circuit construction + flattening); the
    # tables themselves load in <1 s.

    def save(self, path: str) -> None:
        """Write the compiled program to `path` (.npz). Fails for circuits
        with generic python 'call' ops (closures aren't serializable);
        the keyless circuit only uses the structured bigdiv/bigcarry ops."""
        import json as _json

        py_ops = []
        for idx, (opcode, params) in sorted(self._py_ops.items()):
            if opcode not in ("bigdiv", "bigcarry"):
                raise ValueError(f"op {idx}: '{opcode}' is not serializable")
            py_ops.append([idx, opcode, list(params)])
        meta = {
            "n_wires": int(self.n_wires),
            "py_ops": py_ops,
            "input_slots": [[name, list(map(int, outs))] for name, outs in self._input_slots],
        }
        tmp = path + ".tmp.npz"
        np.savez(
            tmp,
            meta=np.frombuffer(_json.dumps(meta).encode(), dtype=np.uint8),
            op_table=self.op_table,
            out_wires=self.out_wires,
            lc_offsets=self.lc_offsets,
            lc_wires=self.lc_wires,
            lc_coefs=self.lc_coefs,
        )
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "CompiledWitnessProgram":
        """Reload a saved program. The instance has no ConstraintSystem
        (cs is None): compute_witness/witness_limbs work; check_witness
        needs the circuit and raises."""
        import json as _json

        z = np.load(path, allow_pickle=False)
        meta = _json.loads(bytes(z["meta"]).decode())
        self = cls.__new__(cls)
        self.cs = None
        self.lib = _load_lib()
        self.op_table = np.ascontiguousarray(z["op_table"])
        self.out_wires = np.ascontiguousarray(z["out_wires"])
        self.lc_offsets = np.ascontiguousarray(z["lc_offsets"])
        self.lc_wires = np.ascontiguousarray(z["lc_wires"])
        self.lc_coefs = np.ascontiguousarray(z["lc_coefs"])
        self.n_wires = meta["n_wires"]
        self._py_ops = {int(i): (op, tuple(params)) for i, op, params in meta["py_ops"]}
        self._input_slots = [(name, outs) for name, outs in meta["input_slots"]]
        self._cb = _PYCALL_T(self._pycall)
        self._check_tables = None
        return self

    # ---- python-callback ops ------------------------------------------------

    def _pycall(self, op_idx, in_ptr, n_in, out_ptr, n_out) -> int:
        try:
            opcode, params = self._py_ops[int(op_idx)]
            vals = [
                _u64x4_to_int(in_ptr[4 * j : 4 * j + 4]) for j in range(int(n_in))
            ]
            if opcode == "bigdiv":
                n_bits, k = params
                mask = (1 << n_bits) - 1
                a = sum(vals[j] << (n_bits * j) for j in range(k))
                b = sum(vals[k + j] << (n_bits * j) for j in range(k))
                m = sum(vals[2 * k + j] << (n_bits * j) for j in range(k))
                q, r = divmod(a * b, m)
                outs = [(q >> (n_bits * j)) & mask for j in range(k)] + [
                    (r >> (n_bits * j)) & mask for j in range(k)
                ]
            elif opcode == "bigcarry":
                n_bits, k = params
                av, bv, pv, qv, rv = (vals[i * k : (i + 1) * k] for i in range(5))
                L = 2 * k - 1
                conv = [0] * L
                for i in range(k):
                    for j in range(k):
                        conv[i + j] += av[i] * bv[j] - pv[i] * qv[j]
                outs = []
                c = 0
                for j in range(L - 1):
                    c = (conv[j] - (rv[j] if j < k else 0) + c) >> n_bits
                    outs.append(c % P)
            else:  # generic legacy closure
                fn = params[0]
                res = fn(*vals)
                outs = [res] if isinstance(res, int) else list(res)
            for j in range(int(n_out)):
                limbs = _int_to_u64x4(outs[j] % P)
                for t in range(4):
                    out_ptr[4 * j + t] = limbs[t]
            return 0
        except Exception:
            return 1

    # ---- execution ------------------------------------------------------------

    def compute_witness(self, **inputs) -> np.ndarray:
        """-> (n_wires, 4) uint64 standard-form witness."""
        wires = np.zeros((self.n_wires, 4), dtype=np.uint64)
        for name, outs in self._input_slots:
            vals = inputs[name]
            if isinstance(vals, int):
                vals = [vals]
            if len(vals) != len(outs):
                raise ValueError(f"input '{name}': expected {len(outs)} values")
            for o, v in zip(outs, vals):
                wires[o] = _int_to_u64x4(v % P)

        rc = self.lib.witness_eval(
            self.op_table.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(len(self.op_table)),
            self.out_wires.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self.lc_wires.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self.lc_coefs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            self.lc_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            wires.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            ctypes.c_int64(self.n_wires),
            self._cb,
        )
        if rc != 0:
            raise RuntimeError(f"witness engine failed at op {-rc - 1}")
        return wires

    def witness_limbs(self, wires_u64: np.ndarray) -> np.ndarray:
        """(n, 4) uint64 -> (n, 16) uint32 16-bit limb rows (device format).

        Widening via np.add into a preallocated buffer: this numpy build's
        u16->u32 astype path runs ~140x slower (measured 6.8s vs 49ms for a
        1.4M-wire witness — a per-request cost worth dodging).
        """
        v16 = wires_u64.view(np.uint16).reshape(-1, 16)
        out = np.empty(v16.shape, dtype=np.uint32)
        np.add(v16, np.uint32(0), out=out, casting="unsafe")
        return out

    def witness_ints(self, wires_u64: np.ndarray) -> list[int]:
        return [_u64x4_to_int(row) for row in wires_u64]

    # ---- native R1CS check -------------------------------------------------------

    def check_witness(self, wires_u64: np.ndarray) -> int | None:
        if self.cs is None:
            raise RuntimeError(
                "check_witness needs the ConstraintSystem; this program was "
                "reloaded from tables (CompiledWitnessProgram.load)"
            )
        if self._check_tables is None:
            lcs = []
            offsets = np.zeros((len(self.cs.constraints), 6), dtype=np.int64)
            for cn in self.cs.constraints:
                lcs.extend((cn.a, cn.b, cn.c))
            flat_off, wires_t, coefs = _flatten_lcs(lcs, mont=True)
            offsets[:, 0:2] = flat_off[0::3]
            offsets[:, 2:4] = flat_off[1::3]
            offsets[:, 4:6] = flat_off[2::3]
            self._check_tables = (offsets, wires_t, coefs)
        offsets, wires_t, coefs = self._check_tables
        rc = self.lib.r1cs_check(
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(len(self.cs.constraints)),
            wires_t.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            coefs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            wires_u64.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            ctypes.c_int64(self.cs.n_wires),
        )
        return None if rc == -1 else int(rc)
