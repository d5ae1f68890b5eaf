"""Build and load the port's CUDA kernels; count their launches.

The kernels are CUDA C++ in keyless_zk_tpu_torch/csrc/, compiled with nvcc
for sm_90a into one shared library with a plain C interface and loaded with
ctypes. The build runs at first use, from the sources alone, into
`build/kernels/<hash of the sources>/` beside the package (a directory the
repository's .gitignore lists), so a fresh checkout builds itself and an
edited source rebuilds. A missing nvcc is an error: there is no path that
carries on without the kernels.

Every kernel wrapper carries a plain-int attribute `launches`, incremented
where it launches its kernel and nowhere else; `launch_counts` and
`reset_launch_counts` read and clear them all.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_WRAPPERS: list = []


def counted(fn):
    """Register a kernel wrapper and give it a launch counter."""
    fn.launches = 0
    _WRAPPERS.append(fn)
    return fn


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0


def _sources(csrc: Path) -> list[Path]:
    return sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build(csrc: Path = CSRC) -> tuple[Path, float]:
    """Compile csrc/*.cu into one shared library (cached by source hash).

    Returns (library path, seconds spent compiling; 0.0 when cached). The
    .cu files compile in parallel; nvcc's -Xptxas -v report (registers,
    spills) is kept in build.log beside the library. `csrc` may name an
    edited copy of the sources (tools/kernel_variants.py)."""
    h = hashlib.sha256()
    for src in _sources(csrc):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(ARCH.encode())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / "libkzk_kernels.so"
    if lib.exists():
        return lib, 0.0
    nvcc = _nvcc()
    tmp = BUILD_ROOT / f"tmp-{os.getpid()}-{time.time_ns()}"
    tmp.mkdir(parents=True)
    t0 = time.perf_counter()
    flags = [ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", f"-I{csrc}"]
    procs = []
    for src in sorted(csrc.glob("*.cu")):
        obj = tmp / (src.stem + ".o")
        log = open(tmp / (src.stem + ".log"), "w")
        procs.append((src, log, subprocess.Popen(
            [nvcc, *flags, "-c", str(src), "-o", str(obj)], stdout=log, stderr=subprocess.STDOUT
        )))
    failed = []
    for src, log, proc in procs:
        proc.wait()
        log.close()
        if proc.returncode != 0:
            failed.append(src.name)
    logs = "".join((tmp / (src.stem + ".log")).read_text() for src, _, _ in procs)
    (tmp / "build.log").write_text(logs)
    if failed:
        errors = "\n".join(line for line in logs.splitlines() if "error" in line or "fatal" in line)
        raise RuntimeError(f"nvcc failed on {failed}:\n{errors[-6000:]}\n--- the log's tail:\n{logs[-2000:]}")
    subprocess.run(
        [nvcc, ARCH, "-shared", "-o", str(tmp / lib.name), *map(str, sorted(tmp.glob("*.o")))],
        check=True,
    )
    seconds = time.perf_counter() - t0
    out_dir.parent.mkdir(parents=True, exist_ok=True)
    if out_dir.exists():
        shutil.rmtree(tmp)
    else:
        os.replace(tmp, out_dir)
    return lib, seconds


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    return load(build()[0])


def load(path: Path) -> ctypes.CDLL:
    """Load a built kernel library with its entry points' argtypes declared."""
    lib = ctypes.CDLL(str(path))
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    signatures = {
        "kzk_mont_mul": [P, P, P, LL, LL, I, P],
        "kzk_mont_pow": [P, P, LL, ctypes.POINTER(ctypes.c_uint32), I, I, P],
        "kzk_window_scan": [P, P, P, P, P, LL, P, P, P, P, LL, LL, I, I, P],
        "kzk_boundary_merge_level": [P, P, LL, P, P, P, LL, I, I, P],
        "kzk_bucket_walk": [P, P, LL, LL, LL, I, I, P],
        "kzk_point_sum": [P, P, LL, LL, I, I, P],
        "kzk_horner_total": [P, P, LL, LL, I, P, I, I, P],
        "kzk_redc": [P, P, P, LL, P],
        "kzk_curve_madd": [P, P, P, P, P, P, P, P, P, LL, LL, I, P],
        "kzk_curve_dbl": [P, P, P, P, P, P, LL, I, P],
        "kzk_curve_add": [P, P, P, P, P, P, P, P, P, LL, I, P],
        "kzk_eval_ab": [P, LL, P, P, P, P, P, LL, LL, I, I, P, P, P, P],
        "kzk_ntt_pass": [P, P, LL, I, I, I, I, I, I, I, I, P, P, P, I, P, I, I, I, P],
    }
    for name, args in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def mangles(name: str, mangled: str) -> bool:
    """Whether a mangled (Itanium) symbol names the function `name`: its
    length-prefixed identifier occurs in it (so `add_kernel` does not match
    `madd_kernel`)."""
    return f"{len(name)}{name}" in mangled


def field_suffix(mangled: str) -> str:
    """The field a kernel instance was built for, from its mangled name:
    " g2" (Fq2), " fr" (Fr) or " g1" (Fq)."""
    return " g2" if "Fq2" in mangled else " fr" if "FrMod" in mangled else " g1"


def ptxas_report(log_text: str, kernels) -> dict:
    """Registers, spill bytes and stack frame of each kernel of `kernels`,
    per field ("<name> g1" / "<name> g2" / "<name> fr"), from nvcc's -Xptxas -v output
    (build.log), with the 128-thread blocks per SM that its registers allow
    (K3's blocks are 128 threads)."""
    out: dict = {}
    entry = props = None
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Function properties for" in line:
            props = line.rsplit(" ", 1)[-1].strip()
        elif entry and any(mangles(k, entry) for k in kernels):
            key = next(k for k in kernels if mangles(k, entry)) + field_suffix(entry)
            rec = out.setdefault(key, {})
            if "bytes stack frame" in line and props == entry:
                words = line.replace(",", "").split()
                rec.update(stack_frame=int(words[0]), spill_stores=int(words[4]), spill_loads=int(words[8]))
            elif "Used" in line and "registers" in line:
                words = line.split()
                rec["registers"] = int(words[words.index("Used") + 1])
                rec["blocks_of_128_per_sm"] = 65536 // (128 * max(rec["registers"], 1))
    return out
