#!/usr/bin/env python3
"""Drive the PyTorch port (keyless_zk_tpu_torch) once on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. environment: the card (nvidia-smi name and power limit), torch, CUDA;
2. build: compile the CUDA kernels from keyless_zk_tpu_torch/csrc;
3. the Montgomery product kernel (K1) against its plain PyTorch version on
   the card, Fr and Fq at 2^22 elements with the main path's broadcasts,
   with both times (exact integers: they must be equal);
4. a small proof (synthetic key at domain 2^12) on the card and on the CPU
   through the plain versions, with the same r and s: the proofs must be
   equal, and equal to the key's discrete-log oracle;
5. the full keyless width (n_vars 1,377,553, domain 2^21, ~42.7M
   coefficients, synthetic key with known discrete logs): key generation,
   prover construction, one warm-up and three timed proofs with per-phase
   CUDA-event times, each proof checked against the discrete-log oracle,
   and the launch counts of a main-path run (every kernel > 0). The
   warm-up proof keeps the inputs of every MSM kernel call (K4-K7) with a
   distinct signature -- G1 and G2, dense and compacted, each scan's
   (L, V) and table, each merge's length and pass count -- and each is
   then run through the kernel and its plain version: equal, with both
   times. Last, the h scalars of the kernel path are checked against the
   plain versions on the card.

The line before the last is one JSON object with a record per kernel; the
last line is {"ok": true, "device": {...}}. Without CUDA, or without the
package beside it, the script prints no result and exits non-zero.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

KERNELS = [
    # (wrapper name, source, the TPU kernel it replaces)
    ("mont_mul", "keyless_zk_tpu_torch/csrc/mont_mul.cu", "keyless_zk_tpu/ops/pallas_field.py:145"),
    ("window_scan", "keyless_zk_tpu_torch/csrc/msm_scan.cu", "keyless_zk_tpu/ops/pallas_msm.py:253"),
    ("boundary_merge", "keyless_zk_tpu_torch/csrc/msm_merge.cu", "keyless_zk_tpu/ops/pallas_msm.py:413"),
    ("weighted_bucket_total", "keyless_zk_tpu_torch/csrc/msm_reduce.cu", "keyless_zk_tpu/ops/pallas_msm.py:548"),
    ("horner_total", "keyless_zk_tpu_torch/csrc/msm_reduce.cu", "keyless_zk_tpu/ops/pallas_msm.py:615"),
]

R_FIXED, S_FIXED = 0x1234567890ABCDEF1234567890ABCDEF, 0xFEDCBA0987654321FEDCBA0987654321


def log(msg: str) -> None:
    print(msg, flush=True)


class Failed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


def cuda_ms(fn, reps: int = 1, warm: bool = True) -> tuple[object, float]:
    """Run fn reps times between CUDA events, after one untimed run if
    `warm`; (last result, ms per run)."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / reps


@contextlib.contextmanager
def plain_kernels():
    """Route the main path's kernel wrappers to their plain versions on the
    card (comparison runs only; the plain versions launch no kernel)."""
    from keyless_zk_tpu_torch.ops import cuda_field, cuda_msm

    saved = {}
    swaps = {
        cuda_field: {"mont_mul": cuda_field.mont_mul_plain},
        cuda_msm: {
            "window_scan": cuda_msm.window_scan_plain,
            "boundary_merge": cuda_msm.boundary_merge_plain,
            "weighted_bucket_total": cuda_msm.weighted_bucket_total_plain,
            "horner_total": cuda_msm.horner_total_plain,
        },
    }
    try:
        for mod, names in swaps.items():
            for name, fn in names.items():
                saved[(mod, name)] = getattr(mod, name)
                setattr(mod, name, fn)
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def rand_field(gen, n: int, spec, dev):
    """(n, 16) int32 limbs of random values < p (top limb below p's)."""
    import torch

    a = torch.randint(0, 1 << 16, (n, 16), generator=gen, dtype=torch.int32, device=dev)
    a[:, 15] = torch.randint(0, spec.p >> 240, (n,), generator=gen, dtype=torch.int32, device=dev)
    return a


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


# ---- kernels against their plain versions -------------------------------------

def record(records: dict, name, err, ms, plain_ms, note) -> None:
    rec = records.setdefault(name, {"max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0})
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    rec["ms"] += ms
    rec["plain_ms"] += plain_ms
    log(f"kernel {name} [{note}]: equal={err == 0} kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    check(err == 0, f"{name} differs from its plain version ({note})")


def mont_mul_checks(dev, records: dict) -> None:
    import torch

    from keyless_zk_tpu_torch.fields.torch_field import FQ, FR
    from keyless_zk_tpu_torch.ops import cuda_field

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)

    # K1 at 2^22 elements, Fr and Fq, with the main path's broadcasts
    n = 1 << 22
    for spec in (FR, FQ):
        a = rand_field(gen, n, spec, dev)
        for label, b in (
            ("b full", rand_field(gen, n, spec, dev)),
            ("b (2^20 rows) over (4, 2^20)", rand_field(gen, 1 << 20, spec, dev)),
            ("b one row", rand_field(gen, 1, spec, dev)[0]),
        ):
            a_in = a if b.dim() == 1 or b.shape[0] != 1 << 20 else a.reshape(4, 1 << 20, 16)
            got, ms = cuda_ms(lambda: cuda_field.mont_mul(a_in, b, spec), reps=5)

            def plain():
                flat = a_in.reshape(-1, 16)
                nb = b.shape[0] if b.dim() == 2 else 1
                step = 1 << 20
                return torch.cat([
                    cuda_field.mont_mul_plain(flat[s : s + step], b if nb == 1 else b[(s % nb) : (s % nb) + step], spec)
                    for s in range(0, flat.shape[0], step)
                ])

            want, plain_ms = cuda_ms(plain)
            record(records, "mont_mul", max_abs_err(got.reshape(-1, 16), want), ms, plain_ms,
                   f"{spec.name} 2^22, {label}")


MSM_KERNELS = ("window_scan", "boundary_merge", "weighted_bucket_total", "horner_total")


def _signature(name: str, args) -> tuple:
    return (name, *(tuple(a.shape) if hasattr(a, "shape") else a for a in args))


def _describe(sig: tuple) -> str:
    name, tag, *rest = sig
    if name == "window_scan":
        (L, V), _, (rows, _), _ = rest
        return f"{tag} L={L} V={V} table {rows} rows"
    if name == "boundary_merge":
        (m,), _, steps = rest
        return f"{tag} m={m} {steps} passes"
    if name == "weighted_bucket_total":
        (_, wn, nb), = rest
        return f"{tag} Wn={wn} NB={nb}"
    (_, wn), c = rest
    return f"{tag} Wn={wn} c={c}"


@contextlib.contextmanager
def capture_msm_calls(store: dict):
    """While the main path runs, keep a copy of the inputs of the first call
    of each MSM kernel wrapper (K4-K7) per argument signature: the tag, the
    tensor shapes and the integer arguments (K5's pass count, K7's c)."""
    from keyless_zk_tpu_torch.ops import cuda_msm

    saved = {name: getattr(cuda_msm, name) for name in MSM_KERNELS}

    class Spy:
        # the wrappers bump `<own name>.launches`, a module global that
        # names this object while it is installed: forward it to the wrapper
        def __init__(self, name, fn):
            self.name, self.fn = name, fn

        def __call__(self, *args):
            store.setdefault(_signature(self.name, args), tuple(a.clone() if hasattr(a, "clone") else a for a in args))
            return self.fn(*args)

        @property
        def launches(self):
            return self.fn.launches

        @launches.setter
        def launches(self, value):
            self.fn.launches = value

    try:
        for name, fn in saved.items():
            setattr(cuda_msm, name, Spy(name, fn))
        yield
    finally:
        for name, fn in saved.items():
            setattr(cuda_msm, name, fn)


def msm_kernel_checks(store: dict, records: dict) -> None:
    """Each captured main-path call of K4-K7 through the kernel and through
    its plain version on the same card tensors: the outputs must be equal."""
    from keyless_zk_tpu_torch.ops import cuda_msm

    for name in MSM_KERNELS:
        for tag in ("fq", "fq2"):
            check(any(sig[:2] == (name, tag) for sig in store), f"no main-path call of {name} ({tag}) captured")
    for sig, args in store.items():
        name, tag = sig[0], sig[1]
        kernel, plain = getattr(cuda_msm, name), getattr(cuda_msm, name + "_plain")
        got, ms = cuda_ms(lambda: kernel(*args), reps=3)
        want, plain_ms = cuda_ms(lambda: plain(*args), warm=False)
        if name == "window_scan":
            err = max(max_abs_err(g, w) for g, w in zip(got, want))
        else:
            err = max_abs_err(got, want)
        record(records, name, err, ms, plain_ms, _describe(sig))


# ---- phases 4 and 5: proofs -----------------------------------------------------

def prove_checked(prover, key, r, s, label):
    from keyless_zk_tpu_torch.fields import torch_field as tf
    from keyless_zk_tpu_torch.ops import testgen

    t0 = time.perf_counter()
    proof = prover.prove(key.witness, r=r, s=s)
    wall = (time.perf_counter() - t0) * 1e3
    h = tf.decode_ints(prover.last_h, tf.FR)
    want = testgen.expected_proof(key, h, r, s)
    ok = (proof.pi_a, proof.pi_b, proof.pi_c) == want
    log(f"{label}: wall {wall:.1f} ms, dlog oracle {'passed' if ok else 'FAILED'}")
    check(ok, f"{label}: proof differs from the discrete-log oracle")
    return proof, wall


def small_proof(dev) -> None:
    import torch

    from keyless_zk_tpu_torch.groth16.prover import Groth16Prover
    from keyless_zk_tpu_torch.ops import testgen

    key = testgen.synthetic_key(
        5, n_vars=3000, n_public=1, domain_pow=12, n_distinct_a=2600, n_distinct_b=1800, n_coefs=80_000, device=dev
    )
    gpu_proof, _ = prove_checked(Groth16Prover(key.pk, dev), key, R_FIXED, S_FIXED, "small proof (gpu, domain 2^12)")
    torch.set_num_threads(8)
    cpu_proof, _ = prove_checked(Groth16Prover(key.pk, "cpu"), key, R_FIXED, S_FIXED, "small proof (cpu plain, domain 2^12)")
    equal = gpu_proof == cpu_proof
    log(f"small proof: gpu == cpu: {equal}")
    check(equal, "the GPU proof differs from the CPU proof")


def full_width(dev, counts_out: dict, records: dict) -> None:
    import torch

    from keyless_zk_tpu_torch.groth16.prover import Groth16Prover
    from keyless_zk_tpu_torch.ops import _build, testgen

    t0 = time.perf_counter()
    key = testgen.synthetic_key(2026, device=dev, **testgen.KEYLESS_SHAPE)
    torch.cuda.synchronize()
    log(f"full width: key generation {time.perf_counter() - t0:.1f} s "
        f"(n_vars {key.pk.n_vars}, domain {key.pk.domain_size}, coefficients {key.pk.n_coefs})")
    t0 = time.perf_counter()
    prover = Groth16Prover(key.pk, dev)
    torch.cuda.synchronize()
    log(f"full width: prover construction {time.perf_counter() - t0:.1f} s")

    calls: dict = {}
    with capture_msm_calls(calls):
        prove_checked(prover, key, R_FIXED, S_FIXED, "full proof warm-up (K4-K7 inputs captured)")
    log("  phases (ms): " + json.dumps({k: round(v, 3) for k, v in prover.phase_ms.items()}))
    msm_kernel_checks(calls, records)
    del calls
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    _build.reset_launch_counts()
    walls = []
    for i in range(3):
        _, wall = prove_checked(prover, key, R_FIXED + i, S_FIXED + i, f"full proof {i + 1}")
        walls.append(wall)
        log("  phases (ms): " + json.dumps({k: round(v, 3) for k, v in prover.phase_ms.items()}))
        if i == 0:
            counts_out.update(_build.launch_counts())
    log(f"full width: proof wall ms {[round(w, 1) for w in walls]}, "
        f"peak device memory over the timed proofs {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"launch counts (one full proof): {json.dumps(counts_out)}")
    for name, _, _ in KERNELS:
        check(counts_out.get(name, 0) > 0, f"kernel {name} was not launched by the main path")

    w = torch.from_numpy(key.witness.astype("int32")).to(dev)
    got = prover._h_scalars(w)
    with plain_kernels():
        want = prover._h_scalars(w)
    equal = torch.equal(got, want)
    log(f"full width: h scalars kernel path == plain path: {equal}")
    check(equal, "h scalars differ between the kernel path and the plain path")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        from keyless_zk_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: keyless_zk_tpu_torch is not importable ({e}); run from the repository root",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    records: dict = {}
    counts: dict = {}
    try:
        log(f"card: {card}")
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
        lib, secs = _build.build()
        _build.library()
        log(f"build: {secs:.1f} s -> {lib}")
        mont_mul_checks(dev, records)
        small_proof(dev)
        full_width(dev, counts, records)
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"total {time.perf_counter() - t_start:.1f} s")
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": rep,
            "launches": counts[name],
            "max_abs_err": records[name]["max_abs_err"],
            "ms": round(records[name]["ms"], 4),
            "plain_ms": round(records[name]["plain_ms"], 4),
        }
        for name, src, rep in KERNELS
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
