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


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build() -> tuple[Path, float]:
    """Compile csrc/*.cu into one shared library (cached by source hash).

    Returns (library path, seconds spent compiling; 0.0 when cached). The
    .cu files compile in parallel; nvcc's -Xptxas -v report (registers,
    spills) is kept in build.log beside the library."""
    h = hashlib.sha256()
    for src in _sources():
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
    flags = [ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", f"-I{CSRC}"]
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
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
        raise RuntimeError(f"nvcc failed on {failed}:\n{logs[-8000:]}")
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
    """The loaded kernel library, built on first call; argtypes declared."""
    lib = ctypes.CDLL(str(build()[0]))
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    signatures = {
        "kzk_mont_mul": [P, P, P, LL, LL, I, P],
        "kzk_window_scan": [P, P, P, P, P, P, P, P, P, LL, LL, I, P],
        "kzk_boundary_merge_pass": [P, P, P, LL, LL, I, P],
        "kzk_weighted_bucket_total": [P, P, LL, LL, I, I, P],
        "kzk_horner_total": [P, P, LL, I, I, P],
        "kzk_redc": [P, P, P, LL, P],
        "kzk_curve_madd": [P, P, P, P, P, P, P, P, P, LL, LL, I, P],
        "kzk_curve_dbl": [P, P, P, P, P, P, LL, I, P],
        "kzk_curve_add": [P, P, P, P, P, P, P, P, P, LL, I, P],
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
