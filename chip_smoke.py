#!/usr/bin/env python3
"""Drive the PyTorch port (keyless_zk_tpu_torch) once on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. environment: the card (nvidia-smi name and power limit), torch, CUDA;
2. build: compile the CUDA kernels from keyless_zk_tpu_torch/csrc, and
   print ptxas's registers, spill bytes and stack frame of K1's mont_pow
   and the K3-K7 and K9 kernels from build.log; then the port's bench
   (`python -m keyless_zk_tpu_torch.bench`) in a subprocess with
   BENCH_QUICK=1: its devices child (the kernels already built) and the
   headline metric msm_g1_2^16, whose record must have a value and
   "correct": true (its MSM checked against the points' discrete logs);
   the record is printed on its own line;
3. the Montgomery product kernel (K1) against its plain PyTorch version on
   the card, Fr and Fq at 2^22 elements with the main path's broadcasts
   and Fq at the decode's n = 4 and n = 1 (per launch), with both times
   (exact integers: they must be equal); then K1's power
   `mont_pow` (the whole square-and-multiply chain in one launch) against
   its plain version (one plain product per step), with the lanes 0, 1,
   p - 1 and R mod p planted: the Fq inverse (e = p - 2) at the proof
   decode's n = 4 and n = 1, the setup's 2^21 + 37 (the last block
   partial) and Fr at 2^16, timed, and e = 0, 1 and 13 at each, untimed;
4. the group-law kernels (K3: complete mixed add, doubling, full add) on
   random points with every edge case planted (either side at infinity,
   both, P == Q, P == -Q), at sizes that leave the last block of 128
   partial (G1 2^20 + 37, G2 2^18 + 61 points), against their plain
   versions (the bounds count the doublings of the P == Q lanes, and the
   full add's counts no add there); the
   mixed add also with one affine point for the whole batch
   (nq == 1), planted as P == Q and P == -Q in some lanes, and at
   infinity; then K4's complete body (`window_scan_complete`, the scan
   with no precondition: on G1 a branch-free projective law, on G2 the
   P == Q doubling) on planted 2^16-row tables, G1 and G2, each
   random point in four consecutive rows with a shared nonzero lowest
   digit, some rows at infinity: `msm(..., assume_distinct=False)` equal
   to a double-and-add over K3's complete mixed add, and on the stream
   that msm built the complete body equal to its plain version (its
   bound counts the P == Q lanes, found in the stream, as affine
   doublings) and the distinct body not;
5. a small proof (synthetic key at domain 2^10) on the card, which runs
   K10's NTT, and on the CPU through the plain versions, which runs K10's
   plain passes, with the same r and s: the proofs must be equal, and
   equal to the key's discrete-log oracle;
6. the prove path at the full keyless width (n_vars 1,377,553, domain 2^21,
   ~42.7M coefficients, synthetic key with known discrete logs): key
   generation, prover construction, one warm-up and three timed proofs
   with per-phase CUDA-event times, each proof checked against the
   discrete-log oracle, and the launch counts of one proof (every kernel of
   the path > 0; K5 counts each level's launch, at most three per MSM; K6
   its bucket walk and each sum launch; K1's product at most
   K1_PROVE_LAUNCHES, its decode's inversions in two launches of
   `mont_pow`; K9 once; K10 four passes, K8 none). The warm-up proof keeps the
   inputs of every call of the MSM kernels (K4-K7), of K10 (each pass of the
   h chain) and of the
   decode's `mont_pow` with a distinct signature, and each is then run through the
   kernel and its plain version: equal, with both times (K4's and K5's
   bucket tables, written in place, are compared, K4's with its heads and
   tails; K6's line shows its grids, K7's its microseconds per chained
   group op). K5 and K7 also run planted edge cases against their plain
   versions: boundary sequences with leading sentinels, runs across tiles,
   one run over most of the sequence or all of it, ids >= n_seg; window
   totals at infinity, equal (the add's doubling branch) and opposite
   (P + (-P)). Then the h scalars of the
   kernel path against the plain versions; K9, the coefficient evaluation
   (`eval_ab`, one launch per proof), against its plain version on the
   prover's table (with the table's entries per row: empty rows, median,
   p99, max) and on planted tables with a witness near r in a quarter of
   its rows (a row of the most entries the prover takes, 2^23 - 1, empty
   rows, rows on either side of a block's share of the merge path, no
   entries), with both times and the h scalars' beside them; K10 at the
   keyless shape ((3, 2^21) random values with 0, 1 and r - 1 planted):
   its NTT, iNTT and fused h chain against the plain version, with the
   bound; the h scalars under K10 equal to the matmul plan's and the
   butterfly plan's on the card, and to K10's unfused chain; the three
   plans' iNTT, NTT and h chain times in turns; K8 on the matmul plan's
   own iNTT and NTT (captured calls against the plain version, its
   launches) and the int8 product's time;
7. the setup path on the chain circuit a == b^m with m = 2^16 - 4 (domain
   2^16), built with the port's ConstraintSystem: `groth16_setup` on the
   card with pinned toxic values (K3's madd and dbl launched), a proof
   under that key (its three-point G2 MSM runs K3 at n = 3), and the port's
   pairing check: true for the proof, false with one coordinate changed;
   then the prover CLI: the key's zkey, witness and vk written under
   build/chip_smoke/cli, `python -m keyless_zk_tpu_torch.groth16.cli prove`
   in a subprocess (exit 0, "verified: true") and `verify` on its output;
   then the circom route at 2^19 constraints: the chain a == b^m with an
   is_zero and a circom-form Num2Bits(254) of a chain wire appended to its
   circom-order R1CS, written as .r1cs, input.json and .sym under
   build/chip_smoke/circom; `witness_from_input_json` with a cold program
   cache (served by the compiled program, the Python solver never called;
   equal to the native witness under the permutation, every constraint
   satisfied), `groth16_setup` on the card over that R1CS (K3's madd and
   dbl launched), and `cli prove --zkey --r1cs --input --sym --vk` in a
   subprocess with the cache warm (exit 0, "verified: true"; its proof
   verifies under the native pairing, with a + 1 it does not); then the
   ceremony tools on the 2^16 chain key: a release feed staged under
   build/chip_smoke/ceremony with file:// URLs, `download_ceremony` with a
   wrong pin (raises, installs nothing) and with the right pins (the
   assets byte for byte), `setup_tool cache-push` and `cache-pull` into
   another store (byte-equal), `cache-pull` of a missing key (exit 1), and
   the prove CLI on the pulled key (verified); then the sharded path
   over a one-process NCCL group (torch.distributed on 127.0.0.1):
   `ShardedGroth16Prover.prove` with the same r and s equal
   to the single prover's proof and verifying (its launch counts: K3's
   full add combines each MSM's partials, and each captured call of it is
   held against its plain version), `four_step_ntt` forward and inverse
   equal to the prover's plan, `sharded_msm` equal to `msm` on the H table;
8. the service's path at full width. Procure: the real keyless circuit
   (`KeylessConfig()`: 1,377,553 wires, 1,406,751 constraints, domain 2^21)
   from the port's `build_keyless_circuit`, then `setup_tool.procure` into
   a cold store under build/chip_smoke/setups: `r1cs_from_cs`, `save_r1cs`,
   `groth16_setup` on the card (its launch counts; one mid-ladder dbl and
   madd call per group and pass size kept and replayed against the plain
   versions, and K3's share of the device ladders), `save_zkey`, the vk
   and circuit config, each file's bytes. The compiled witness engine
   (compile, saved beside the zkey as `witness_program.npz`) on a test JWT
   from the port's seeded generator: every constraint checked, the public
   wire equal to the public-inputs hash, the witness's nonzero and
   bit-valued shares. Start: a `ProverServiceState` started warm from the
   store (`init_prover_from_native_setup(persist=True)`: the saved witness
   program, the zkey, checked equal to the setup's key array by array and
   vk point by vk point before the prover is built, the prover), the
   native pairing required. Prove through the service's program and prover: one
   warm-up proof (each of its four K10 passes kept and held against the
   plain version, timed) whose five MSMs are each held against a double-and-add
   over K3's complete mixed add (as affine points), then
   `msm(..., assume_distinct=False)` with the same witness on the key's
   raw tables A, B1, C and B2, which repeat points, each equal as an
   affine point to the prover's MSM over its deduplicated table, with
   both times (their launch counts are the complete body's path, and
   msm_a's scan stream is held against the plain version), three timed proofs
   with per-phase CUDA-event times, every proof checked under the pairing
   against [public-inputs hash] (a tampered proof must fail), the launch
   counts of one proof (K9 once, K10 four times, K8 never), K9 against its plain version on the
   key's table, with the table's entries per row. Serve: the HTTP
   service and its metrics server on 127.0.0.1 (ephemeral ports, threads,
   no JWK fetcher), three POST /v0/prove one after another and two at once
   with JWTs of five seeds, each 200 with a proof that verifies under
   verification_key.json against the response's public-inputs hash and a
   training-wheels signature that verifies over the BCS message rebuilt
   from the response; the launch counts of one request (every prove-path
   kernel > 0); then, with a BatchProver (max_batch 4) around the same
   prover, four POST /v0/prove at once, each 200 and verifying, with the
   batch sizes the worker drained; a tampered JWT answered 400;
   /healthcheck 200; the nine prove phases in the metrics text. Each
   step's seconds are logged, and each request's wall ms, nine phase ms
   and the prover's phase ms. Between the proofs and the service, batched
   proving on the same prover (no second prover is built): the witnesses
   of eight seeded JWTs, a warm-up batch of four whose K7 inputs are kept,
   every proof verifying (a tampered one not), its msm_b2 and msm_h equal
   to the single prover's MSMs of the same witnesses; the batched K7
   against its plain version at B = 1, 2 and 4 on those window totals and
   on planted edge cases; three timed batches at B = 1, 2, 4 and 8 with
   proofs_per_sec, phases, launches per batch (K9 once per element) and
   peak device memory.

The line before the last is one JSON object with a record per kernel; the
last line is {"ok": true, "device": {...}}. Without CUDA, or without the
package beside it, the script prints no result and exits non-zero.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

KERNELS = [
    # (record: the wrapper, whose counter gives its launches; source; the TPU
    # kernel it replaces; the path whose run gives its launches: "prove",
    # "setup", "batch", "sharded", "complete" or "mxu")
    ("mont_mul", "keyless_zk_tpu_torch/csrc/mont_mul.cu", "keyless_zk_tpu/ops/pallas_field.py:145", "prove"),
    # K1's product chained through jax_field.mont_pow's fori_loop, in one launch
    ("mont_pow", "keyless_zk_tpu_torch/csrc/mont_mul.cu", "keyless_zk_tpu/ops/pallas_field.py:145", "prove"),
    ("curve_madd", "keyless_zk_tpu_torch/csrc/curve_ops.cu", "keyless_zk_tpu/ops/pallas_curve.py:130", "setup"),
    ("curve_dbl", "keyless_zk_tpu_torch/csrc/curve_ops.cu", "keyless_zk_tpu/ops/pallas_curve.py:152", "setup"),
    ("curve_add", "keyless_zk_tpu_torch/csrc/curve_ops.cu", "keyless_zk_tpu/ops/pallas_curve.py:168", "sharded"),
    ("window_scan", "keyless_zk_tpu_torch/csrc/msm_scan.cu", "keyless_zk_tpu/ops/pallas_msm.py:253", "prove"),
    # K4's second body (assume_distinct=False: the P == Q doubling), on the real key's raw tables
    ("window_scan_complete", "keyless_zk_tpu_torch/csrc/msm_scan.cu", "keyless_zk_tpu/ops/pallas_msm.py:253",
     "complete"),
    ("boundary_merge", "keyless_zk_tpu_torch/csrc/msm_merge.cu", "keyless_zk_tpu/ops/pallas_msm.py:413", "prove"),
    ("weighted_bucket_total", "keyless_zk_tpu_torch/csrc/msm_reduce.cu", "keyless_zk_tpu/ops/pallas_msm.py:548",
     "prove"),
    ("horner_total", "keyless_zk_tpu_torch/csrc/msm_reduce.cu", "keyless_zk_tpu/ops/pallas_msm.py:615", "prove"),
    # K7 over a batch's (3R, B, Wn) window totals, B blocks in one launch
    ("horner_total_batched", "keyless_zk_tpu_torch/csrc/msm_reduce.cu", "keyless_zk_tpu/ops/pallas_msm.py:615",
     "batch"),
    # K8 off the prover's path: the matmul plan's (3, 2^21) iNTT and NTT ("mxu")
    ("redc", "keyless_zk_tpu_torch/csrc/redc.cu", "keyless_zk_tpu/ops/pallas_redc.py:115", "mxu"),
    ("redc_twiddle", "keyless_zk_tpu_torch/csrc/redc.cu", "keyless_zk_tpu/ops/pallas_redc.py:122", "mxu"),
    # K9 replaces no Pallas kernel: the JAX package's coefficient evaluation is XLA
    ("eval_ab", "keyless_zk_tpu_torch/csrc/eval_ab.cu", "none (keyless_zk_tpu/groth16/prover.py:80 _eval_ab_fused, XLA)",
     "prove"),
    # K10 replaces, on the prover's path, the matmul NTT of keyless_zk_tpu/ops/mxu_ntt.py with K8
    ("ntt_pass", "keyless_zk_tpu_torch/csrc/ntt.cu",
     "none (the matmul chain of keyless_zk_tpu/ops/mxu_ntt.py and K8, pallas_redc.py:115 / :122, on this path)",
     "prove"),
]

# K10's launches a proof: two passes of the h chain's iNTT and two of its NTT
NTT_PROVE_LAUNCHES = 4

# K1 product launches of one proof: the 758 that the proof made (H100 runs)
# when each Fermat chain was one launch per product, less the decode's two
# chains of 364 products each (Fq p - 2: 254 squarings, 110 set bits),
# which `mont_pow` runs in two launches, less the products of the 11
# coefficient chunks, which K9 (`eval_ab`) makes in one launch. The 19 were
# the merges' to_mont, the h scalars' products and the decode's products
# around the inversions; K10 makes the h scalars' products (c = a*b, n^-1,
# the coset shift, A*B, from_mont) inside its passes since, so a proof
# makes five fewer: 19 stays the bound.
K1_PROVE_LAUNCHES = 758 - 2 * 364 - 11

R_FIXED, S_FIXED = 0x1234567890ABCDEF1234567890ABCDEF, 0xFEDCBA0987654321FEDCBA0987654321
TOXIC = {"tau": 999, "alpha": 3, "beta": 4, "gamma": 5, "delta": 6}

# ---- the least time the card could take (bound_ms) ------------------------------
# H100 SXM (NVIDIA's data sheet): 3.35 TB/s of device memory, 1,979 TOP/s
# int8 in the tensor cores. The data sheet gives no integer-ALU rate; the
# SM has 64 INT32 lanes (half its 128 FP32 lanes), so 132 * 64 32-bit
# multiply-adds per clock at the 1.98 GHz boost clock. A 32 x 32 -> 64-bit
# product counts as two multiply-adds (low and high word).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
IMAD_PER_S = 132 * 64 * 1.98e9
# one Montgomery product over 8 words (CIOS): 8 rounds of 16 wide products
# and one 32-bit product for m
FQ_MUL_IMAD = 8 * (16 * 2 + 1)
# Fq products per group op, (G1, G2): an Fq2 product is three Fq products,
# an Fq2 square two (csrc/field.cuh)
GROUP_OP_PRODUCTS = {
    "dbl": (2 + 5, 2 * 3 + 5 * 2),  # dbl_core: 2 mul, 5 sqr
    "madd": (7 + 4, 7 * 3 + 4 * 2),  # madd-2007-bl: 7 mul, 4 sqr
    "dbl_affine": (1 + 5, 1 * 3 + 5 * 2),
    "add": (11 + 5, 11 * 3 + 5 * 2),  # add-2007-bl: 11 mul, 5 sqr
}
REDC_IMAD = 10 * (8 * 2 + 1)  # K8: ten word-wise rounds by 2^32


def group_imad(op: str, tag: str, count) -> float:
    return float(count) * GROUP_OP_PRODUCTS[op][tag == "fq2"] * FQ_MUL_IMAD


def nbytes(*objs) -> int:
    """Bytes of the tensors in objs (tuples and JacPoints are walked)."""
    total = 0
    for o in objs:
        if isinstance(o, (tuple, list)):
            total += nbytes(*o)
        elif hasattr(o, "element_size"):
            total += o.numel() * o.element_size()
    return total


def log(msg: str) -> None:
    print(msg, flush=True)


class Failed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


def cuda_ms(fn, reps: int = 1, warm: bool = True) -> tuple[object, float]:
    """Run fn reps times between CUDA events, after two untimed runs if
    `warm`; (last result, ms per run). The warm runs hold a result across
    a call as the timed loop does, so the allocator holds the two output
    buffers that the loop alternates between before the clock starts."""
    import torch

    if warm:
        out = fn()
        out = fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / reps


def spin_up(fn, seconds: float = 1.0) -> None:
    """Run fn untimed for about `seconds` of device time, so that the
    timings after it do not start on a card that has sat idle."""
    import torch

    start = time.monotonic()
    while time.monotonic() - start < seconds:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()


@contextlib.contextmanager
def plain_kernels():
    """Route the main path's kernel wrappers to their plain versions on the
    card (comparison runs only; the plain versions launch no kernel)."""
    from keyless_zk_tpu_torch.ops import cuda_curve, cuda_eval_ab, cuda_field, cuda_msm, cuda_ntt, cuda_redc

    saved = {}
    swaps = {
        cuda_eval_ab: {"eval_ab": cuda_eval_ab.eval_ab_plain},
        cuda_ntt: {"ntt_pass": cuda_ntt.ntt_pass_plain},
        cuda_field: {"mont_mul": cuda_field.mont_mul_plain, "mont_pow": cuda_field.mont_pow_plain},
        cuda_msm: {
            "window_scan": cuda_msm.window_scan_plain,
            "window_scan_complete": functools.partial(cuda_msm.window_scan_plain, assume_distinct=False),
            "boundary_merge": cuda_msm.boundary_merge_plain,
            "weighted_bucket_total": cuda_msm.weighted_bucket_total_plain,
            "horner_total": cuda_msm.horner_total_plain,
        },
        cuda_redc: {"redc": cuda_redc.redc_columns, "redc_twiddle": cuda_redc.redc_twiddle_plain},
        cuda_curve: {"curve_madd": cuda_curve.madd_plain, "curve_dbl": cuda_curve.dbl_plain,
                     "curve_add": cuda_curve.add_plain},
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
    """Largest limb difference; a and b may be tensors or (nested) tuples."""
    if isinstance(a, (tuple, list)):
        return max((max_abs_err(x, y) for x, y in zip(a, b)), default=0)
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


# ---- kernels against their plain versions -------------------------------------

def record(records: dict, name, err, ms, plain_ms, note, *, moved: int, imad: float = 0.0) -> None:
    """Add one kernel-vs-plain comparison to `name`'s record. `moved` is the
    bytes the function must move (inputs read once, outputs written once),
    `imad` the 32-bit multiply-adds its arithmetic needs on these inputs."""
    rec = records.setdefault(name, {"max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                                    "bound_ms": 0.0})
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = imad / IMAD_PER_S * 1e3
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    rec["ms"] += ms
    rec["plain_ms"] += plain_ms
    rec["bytes_ms"] += bytes_ms
    rec["ops_ms"] += ops_ms
    rec["bound_ms"] += max(bytes_ms, ops_ms)
    log(f"kernel {name} [{note}]: equal={err == 0} kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bound {max(bytes_ms, ops_ms):.4f} ms ({'bytes' if bytes_ms >= ops_ms else 'operations'})")
    check(err == 0, f"{name} differs from its plain version ({note})")


def compare(records, name, kernel, plain, args, note, *, imad: float, reps: int = 3) -> float:
    """One input through the kernel wrapper and its plain version (with K1
    routed to its plain version too), both timed; equal or fail. Returns
    the kernel's ms."""
    got, ms = cuda_ms(lambda: kernel(*args), reps=reps)
    with plain_kernels():
        want, plain_ms = cuda_ms(lambda: plain(*args), warm=False)
    record(records, name, max_abs_err(got, want), ms, plain_ms, note, moved=nbytes(args, got), imad=imad)
    return ms


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
        if spec == FR:  # the first timed launches: bring the card off its idle clocks first
            spin_up(lambda: cuda_field.mont_mul(a, a, spec))
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
                   f"{spec.name} 2^22, {label}", moved=nbytes(a_in, b, got), imad=n * FQ_MUL_IMAD)

    # K1 at the decode's shapes: the products around its inversions (and,
    # before mont_pow, each step of their chains), one launch each
    for n in (4, 1):
        a, b = rand_field(gen, n, FQ, dev), rand_field(gen, n, FQ, dev)
        got, ms = cuda_ms(lambda: cuda_field.mont_mul(a, b, FQ), reps=100)
        want, plain_ms = cuda_ms(lambda: cuda_field.mont_mul_plain(a, b, FQ), reps=100)
        record(records, "mont_mul", max_abs_err(got, want), ms, plain_ms, f"fq n={n} (the decode's), per launch",
               moved=nbytes(a, b, got), imad=n * FQ_MUL_IMAD)


def pow_steps(e: int) -> tuple[int, int]:
    """(squarings, products) of the kernel's chain for exponent e: fixed
    4-bit windows from the top, a table of x^2 .. x^15 (14 products), then
    four squarings per window below the top one and a product for each
    nonzero one (csrc/mont_mul.cu `mont_pow_kernel`)."""
    nwin = (max(e.bit_length(), 1) + 3) // 4
    return 4 * (nwin - 1), 14 + sum(1 for w in range(nwin - 1) if (e >> (4 * w)) & 15)


def pow_imad(n: int, e: int) -> float:
    """The multiply-adds of n chains of exponent e, as the kernel runs them."""
    return float(n) * sum(pow_steps(e)) * FQ_MUL_IMAD


def pow_compare(records, args, note) -> None:
    """One mont_pow input through the kernel and its plain version, timed:
    bytes 128 per element (a row in, a row out)."""
    from keyless_zk_tpu_torch.ops import cuda_field

    a, e, _ = args
    n = a.numel() // 16
    sqr, mul = pow_steps(e)
    compare(records, "mont_pow", cuda_field.mont_pow, cuda_field.mont_pow_plain, args,
            f"{note}, {sqr} squarings and {mul} products per element", imad=pow_imad(n, e), reps=5)


def mont_pow_checks(dev, records: dict) -> None:
    """K1's mont_pow against its plain version, lanes 0, 1, p - 1 and R mod
    p planted: the Fq inverse at the decode's n = 4 and n = 1, the setup's
    2^21 + 37 and Fr 2^16, timed; e = 0, 1 and 13 untimed."""
    import torch

    from keyless_zk_tpu_torch.fields.torch_field import FQ, FR, encode_ints
    from keyless_zk_tpu_torch.ops import cuda_field

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    for spec, n, label in ((FQ, 4, "decode's G1 z's"), (FQ, 1, "decode's Fq2 norm"),
                           (FQ, (1 << 21) + 37, "a setup pass"), (FR, 1 << 16, "Fr")):
        a = rand_field(gen, n, spec, dev)
        edge = encode_ints([0, 1, spec.p - 1, spec.r_mod_p], spec, device=dev)
        k = min(n, 4)
        a[:k] = edge[:k] if n >= 4 else edge[[1]]  # n = 1: the Montgomery 1 is R mod p; plant raw 1
        for e in (spec.p - 2, 0, 1, 13):
            args = (a, e, spec)
            if e == spec.p - 2:
                pow_compare(records, args, f"{spec.name} n={n} ({label}), e = p - 2")
                continue
            got = cuda_field.mont_pow(*args)
            with plain_kernels():
                want = cuda_field.mont_pow_plain(*args)
            planted(records, "mont_pow", max_abs_err(got, want), f"{spec.name} n={n}, e = {e}, lanes 0, 1, p - 1, R")
        if n == 1:  # the other planted lanes one at a time
            for v in edge:
                x = v[None].contiguous()
                got = cuda_field.mont_pow(x, spec.p - 2, spec)
                with plain_kernels():
                    want = cuda_field.mont_pow_plain(x, spec.p - 2, spec)
                planted(records, "mont_pow", max_abs_err(got, want), f"{spec.name} n=1, e = p - 2, one planted lane")


def decode_pow_checks(store: dict, records: dict) -> None:
    """The decode's captured mont_pow calls (the G1 batch's z's and the G2
    point's Fq2 norm) through the kernel and its plain version."""
    check(sorted(sig[1] for sig in store) == [(1, 16), (4, 16)],
          f"the decode's mont_pow calls were not captured: {sorted(store)}")
    for sig, args in store.items():
        pow_compare(records, args, f"decode, {args[2].name} {tuple(args[0].shape)}")


# ---- K3 on random points with the edge cases planted ------------------------------

def _scaled(curve, x, y, lam):
    """The Jacobian representative (x lam^2, y lam^3, lam) of affine (x, y)."""
    from keyless_zk_tpu_torch.curves.jacobian import JacPoint

    f = curve.ops
    l2 = f.sqr(lam)
    return JacPoint(f.mul(x, l2), f.mul(y, f.mul(l2, lam)), lam)


def k3_inputs(tag: str, n: int, dev):
    """Jacobian batches p and q (random z), the affine form of q, with every
    edge case planted in lanes i % 64 == 0..4: p at infinity, q at infinity,
    p == q, p == -q, both at infinity. Also the mixed add's inputs with one
    affine point for the batch, {label: (p, (qx, qy, q_inf))}: q's first
    point (finite) with p planted as that point in lanes i % 64 == 5 and as
    its negation in lanes i % 64 == 6 (each with its own z), and a point at
    infinity."""
    import torch

    from keyless_zk_tpu_torch.curves.jacobian import G1_CURVE, G2_CURVE, JacPoint
    from keyless_zk_tpu_torch.fields.torch_field import FQ
    from keyless_zk_tpu_torch.ops import testgen

    curve = G1_CURVE if tag == "fq" else G2_CURVE
    f = curve.ops
    px, py, _ = testgen.random_points(n, seed=31, curve=curve, device=dev)
    qx, qy, _ = testgen.random_points(n, seed=32, curve=curve, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(33)

    def lam():
        v = rand_field(gen, n * (1 if tag == "fq" else 2), FQ, dev)
        v[:, 0] |= 1  # nonzero
        return v if tag == "fq" else v.reshape(n, 2, 16)

    lane = torch.arange(n, device=dev) % 64
    same, opposite = lane == 2, lane == 3
    qx = f.select(same | opposite, px, qx)
    qy = f.select(same, py, f.select(opposite, f.neg(py), qy))
    p_inf = (lane == 0) | (lane == 4)
    q_inf = (lane == 1) | (lane == 4)
    p = _scaled(curve, px, py, lam())
    p = curve.select(p_inf, JacPoint(p.x, p.y, torch.zeros_like(p.z)), p)
    q = _scaled(curve, qx, qy, lam())
    q = curve.select(q_inf, JacPoint(q.x, q.y, torch.zeros_like(q.z)), q)

    q1 = tuple(t[:1].contiguous() for t in (qx, qy, q_inf))
    x1, y1 = (t.expand(n, *t.shape[1:]).contiguous() for t in q1[:2])
    bp = curve.select(lane == 5, _scaled(curve, x1, y1, lam()),
                      curve.select(lane == 6, _scaled(curve, x1, f.neg(y1), lam()), p))
    broadcast = {"q planted as P == Q and P == -Q": (JacPoint(*(c.contiguous() for c in bp)), q1),
                 "q at infinity": (p, (q1[0], q1[1], torch.ones_like(q1[2])))}
    return (JacPoint(*(c.contiguous() for c in p)), JacPoint(*(c.contiguous() for c in q)), (qx, qy, q_inf),
            broadcast)


def doubling_lanes(p, q, tag: str) -> int:
    """The lanes of a full add p + q that take its doubling: P == Q as
    points, neither at infinity (plain field ops)."""
    from keyless_zk_tpu_torch.ops.cuda_msm import curve_for

    f = curve_for(tag).ops

    def eq(a, b):
        return (a == b).reshape(a.shape[0], -1).all(1)

    with plain_kernels():
        z1z1, z2z2 = f.sqr(p.z), f.sqr(q.z)
        same_x = eq(f.mul(p.x, z2z2), f.mul(q.x, z1z1))
        same_y = eq(f.mul(f.mul(p.y, q.z), z2z2), f.mul(f.mul(q.y, p.z), z1z1))
    return int((same_x & same_y & ~f.is_zero(p.z) & ~f.is_zero(q.z)).sum())


def add_imad(p, q, tag: str) -> float:
    """The multiply-adds of a full add of these batches: the doubling in the
    lanes where P == Q, the add in the others (each lane needs one of them)."""
    n_dbl = doubling_lanes(p, q, tag)
    return group_imad("add", tag, p.x.shape[0] - n_dbl) + group_imad("dbl", tag, n_dbl)


def k3_checks(dev, records: dict) -> None:
    """madd, dbl and add on random batches with the edge cases, G1 2^20 + 37
    and G2 2^18 + 61 points (the last block of 128 is partial), and madd
    with one affine point for the batch (untimed)."""
    import torch

    from keyless_zk_tpu_torch.ops import cuda_curve

    for tag, n in (("fq", (1 << 20) + 37), ("fq2", (1 << 18) + 61)):
        p, q, (qx, qy, q_inf), broadcast = k3_inputs(tag, n, dev)
        torch.cuda.synchronize()
        n_dbl_affine = int(((torch.arange(n, device=dev) % 64) == 2).sum())
        compare(records, "curve_madd", cuda_curve.curve_madd, cuda_curve.madd_plain, (p, qx, qy, q_inf, tag),
                f"{tag} n={n}, edge cases planted",
                imad=group_imad("madd", tag, n) + group_imad("dbl_affine", tag, n_dbl_affine))
        compare(records, "curve_dbl", cuda_curve.curve_dbl, cuda_curve.dbl_plain, (p, tag),
                f"{tag} n={n}", imad=group_imad("dbl", tag, n))
        n_dbl = doubling_lanes(p, q, tag)
        check(n_dbl == n_dbl_affine, f"K3 add: {n_dbl} lanes double, {n_dbl_affine} were planted")
        compare(records, "curve_add", cuda_curve.curve_add, cuda_curve.add_plain, (p, q, tag),
                f"{tag} n={n}, edge cases planted, {n_dbl} doubling lanes", imad=add_imad(p, q, tag))
        for label, (bp, q1) in broadcast.items():
            got = cuda_curve.curve_madd(bp, *q1, tag)
            with plain_kernels():
                want = cuda_curve.madd_plain(bp, *q1, tag)
            planted(records, "curve_madd", max_abs_err(got, want), f"{tag} n={n}, nq=1, {label}")
        del p, q, qx, qy, q_inf, broadcast
        torch.cuda.empty_cache()


# ---- capturing the kernels' inputs on a path ------------------------------------

def _signature(name: str, args) -> tuple:
    def sig(a):
        if hasattr(a, "shape"):
            return tuple(a.shape)
        if hasattr(a, "log_line"):  # one pass of K10: its domain, line and stride
            return ("pass", a.log_n, a.log_line, a.log_stride)
        if isinstance(a, tuple):
            return tuple(sig(x) for x in a)
        return a

    return (name, *(sig(a) for a in args))


def _clone(a):
    if hasattr(a, "clone"):
        return a.clone()
    if isinstance(a, tuple):
        return type(a)(*(_clone(x) for x in a))
    return a


@contextlib.contextmanager
def capture_calls(module, names, store: dict, at: int = 0, seen: dict | None = None):
    """While a path runs, keep a copy of the inputs of the at-th call of each
    kernel wrapper `names` of `module` per argument signature (tensor and
    point shapes, tags and integer arguments); `seen` receives the calls per
    signature."""
    saved = {name: getattr(module, name) for name in names}
    seen = {} if seen is None else seen

    class Spy:
        # the wrappers bump `<own name>.launches`, a module global that
        # names this object while it is installed: forward it to the wrapper
        def __init__(self, name, fn):
            self.name, self.fn = name, fn

        def __call__(self, *args, **kwargs):  # keyword arguments pass through, unrecorded
            sig = _signature(self.name, args)
            seen[sig] = seen.get(sig, 0) + 1
            if seen[sig] == at + 1:
                store[sig] = tuple(_clone(a) for a in args)
            return self.fn(*args, **kwargs)

        @property
        def launches(self):
            return self.fn.launches

        @launches.setter
        def launches(self, value):
            self.fn.launches = value

    try:
        for name, fn in saved.items():
            setattr(module, name, Spy(name, fn))
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


MSM_KERNELS = ("window_scan", "boundary_merge", "weighted_bucket_total", "horner_total")
REDC_KERNELS = ("redc", "redc_twiddle")
# K10's input and output formats by number (ops/cuda_ntt.py IN_*, OUT_*)
NTT_FORMATS = (("words", "limbs", "a|b"), ("words", "limbs", "h"))


def _describe(sig: tuple) -> str:
    name, *rest = sig
    if name in REDC_KERNELS:
        return f"N={rest[0][1]}"
    if name == "ntt_pass":
        src, (_, log_n, log_line, log_stride), batch, in_fmt, out_fmt, scale = rest
        return (f"pass of 2^{log_line} points 2^{log_stride} apart, domain 2^{log_n}, batch {batch}, "
                f"{NTT_FORMATS[0][in_fmt]} in, {NTT_FORMATS[1][out_fmt]} out, scale {scale or 'none'}")
    tag, *rest = rest
    if name in ("window_scan", "window_scan_complete"):
        (L, V), _, (rows, _), _, (_, n_seg) = rest
        return f"{tag} L={L} V={V} table {rows} rows, {n_seg} buckets"
    if name == "boundary_merge":
        from keyless_zk_tpu_torch.ops import cuda_msm

        (m,), _, (_, n_seg) = rest
        tile = cuda_msm._MERGE_TILE[tag]
        return (f"{tag} m={m}, {n_seg} buckets: tiles of {tile}, "
                f"{len(cuda_msm.merge_levels(m, tile))} launches {cuda_msm.merge_levels(m, tile)}")
    if name == "weighted_bucket_total":
        from keyless_zk_tpu_torch.ops import cuda_msm

        (_, wn, nb), = rest
        lanes = cuda_msm.bucket_threads(tag, wn, nb)
        grids, n = [], lanes
        while n > 1:
            j = cuda_msm._sum_threads(tag, n)
            n = -(-n // j)
            grids.append(f"{wn * n} x {j}")
        return (f"{tag} Wn={wn} NB={nb}: walk {lanes} lanes per window, {-(-wn * lanes // 128)} blocks of 128; "
                f"sums {', '.join(grids) or 'none'} (blocks x threads)")
    (*_, wn), c = rest
    return f"{tag} Wn={wn} c={c}, {horner_ops(wn, c)} chained group ops"


def horner_ops(wn: int, c: int) -> int:
    """Group ops on K7's chain: c doublings and one add per window below the top."""
    return (wn - 1) * (c + 1)


def msm_imad(name: str, args) -> float:
    """The multiply-adds a K4-K7 call needs on these inputs."""
    import torch

    tag = args[0]
    if name in ("window_scan", "window_scan_complete"):  # one mixed add per stream entry of a finite point
        _, _, pay, _, tinf, _ = args
        return group_imad("madd", tag, int((~tinf[(pay & ((1 << 30) - 1)).long()]).sum()))
    if name == "boundary_merge":  # one add per entry whose bucket key equals its predecessor's
        _, keys, _, tbl = args
        k = keys[1:]
        return group_imad("add", tag, int(((k == keys[:-1]) & (k >= 0) & (k < tbl.shape[1])).sum()))
    if name == "weighted_bucket_total":  # the running sum and its integral over every bucket
        _, tbl = args
        return group_imad("add", tag, 2 * tbl.shape[1] * tbl.shape[2])
    _, wins, c = args  # Horner, per chain: c doublings and one add per window below the top
    wn = wins.shape[-1]
    chains = wins[0].numel() // wn
    return chains * (group_imad("dbl", tag, (wn - 1) * c) + group_imad("add", tag, wn - 1))


def scan_check(records, args, note) -> None:
    """K4 against its plain version. The scan writes its bucket table in
    place: each side starts from its own copy of the captured table, and
    the tables are compared with the heads and tails. The timed launches
    then write into the captured table itself (each writes the same
    columns). The complete body is timed on the same stream too."""
    from keyless_zk_tpu_torch.ops import cuda_msm

    tag, keys, pay, table, tinf, tbl = args
    tbl0 = tbl.clone()  # the table as the main path handed it over
    got_tbl = tbl0.clone()
    got = cuda_msm.window_scan(*args[:-1], got_tbl)
    want_tbl = tbl0.clone()
    with plain_kernels():
        want, plain_ms = cuda_ms(lambda: cuda_msm.window_scan_plain(*args[:-1], want_tbl), warm=False)
    _, ms = cuda_ms(lambda: cuda_msm.window_scan(*args), reps=3)
    _, complete_ms = cuda_ms(lambda: cuda_msm.window_scan_complete(*args), reps=3)
    written = int((got_tbl != tbl0).any(dim=0).sum())
    moved = nbytes(keys, pay, table, tinf, got) + written * tbl0.shape[0] * tbl0.element_size()
    record(records, "window_scan", max_abs_err((got_tbl, *got), (want_tbl, *want)), ms, plain_ms,
           f"{note}, {written} interior buckets written; the complete body on this stream {complete_ms:.3f} ms",
           moved=moved, imad=msm_imad("window_scan", args))


@contextlib.contextmanager
def counting_doublings(tag: str, out: list):
    """While the complete scan's plain version runs, append to `out` the
    P == Q lanes of each of its mixed adds, from the stream's data whatever
    the law does with them: the accumulator and the affine point both finite
    and equal. G1's law (`madd_proj_plain`) holds a projective accumulator
    (qx z == x, qy z == y), G2's (`madd_plain`) a Jacobian one (qx z^2 == x,
    qy z^3 == y). The plain version adds onto infinity where a run starts,
    so only lanes inside a run count."""
    from keyless_zk_tpu_torch.ops import cuda_curve
    from keyless_zk_tpu_torch.ops.cuda_msm import curve_for

    name = "madd_proj_plain" if tag == "fq" else "madd_plain"
    real = getattr(cuda_curve, name)
    f = curve_for(tag).ops

    def eq(a, b):
        return (a == b).reshape(a.shape[0], -1).all(1)

    def counted(p, qx, qy, q_inf, tag_):
        if tag == "fq":
            same = eq(f.mul(qx, p.z), p.x) & eq(f.mul(qy, p.z), p.y)
        else:
            z2 = f.sqr(p.z)
            same = eq(f.mul(qx, z2), p.x) & eq(f.mul(qy, f.mul(z2, p.z)), p.y)
        out.append(int((same & ~f.is_zero(p.z) & ~q_inf).sum()))
        return real(p, qx, qy, q_inf, tag_)

    setattr(cuda_curve, name, counted)
    try:
        yield
    finally:
        setattr(cuda_curve, name, real)


def complete_scan_check(records, args, note, *, distinct_differs: bool | None) -> int:
    """K4's complete body against its plain version (the complete law), as
    `scan_check` does for the distinct body; the bound counts one affine
    doubling per lane that took it. The distinct body runs on the same
    stream: `distinct_differs` True requires it to differ from the plain
    version (the stream reaches the doubling), False to equal it, None
    only logs. Returns the doubling lanes."""
    from keyless_zk_tpu_torch.ops import cuda_msm

    tag, keys, pay, table, tinf, tbl = args
    tbl0 = tbl.clone()
    got_tbl = tbl0.clone()
    got = cuda_msm.window_scan_complete(*args[:-1], got_tbl)
    want_tbl = tbl0.clone()
    doublings: list = []
    with plain_kernels(), counting_doublings(tag, doublings):
        want, plain_ms = cuda_ms(lambda: cuda_msm.window_scan_plain(*args[:-1], want_tbl, assume_distinct=False),
                                 warm=False)
    n_dbl = sum(doublings)
    distinct_tbl = tbl0.clone()
    distinct = cuda_msm.window_scan(*args[:-1], distinct_tbl)
    distinct_err = max_abs_err((distinct_tbl, *distinct), (want_tbl, *want))
    _, ms = cuda_ms(lambda: cuda_msm.window_scan_complete(*args), reps=3)
    _, distinct_ms = cuda_ms(lambda: cuda_msm.window_scan(*args), reps=3)
    written = int((got_tbl != tbl0).any(dim=0).sum())
    moved = nbytes(keys, pay, table, tinf, got) + written * tbl0.shape[0] * tbl0.element_size()
    imad = msm_imad("window_scan_complete", args) + group_imad("dbl_affine", tag, n_dbl)
    record(records, "window_scan_complete", max_abs_err((got_tbl, *got), (want_tbl, *want)), ms, plain_ms,
           f"{note}, {written} interior buckets written, {n_dbl} doubling lanes; the distinct body "
           f"{distinct_ms:.3f} ms, equal to the plain version: {distinct_err == 0}", moved=moved, imad=imad)
    if distinct_differs is not None:
        check((distinct_err != 0) == distinct_differs,
              f"the distinct body {'equals' if distinct_differs else 'differs from'} the complete plain version "
              f"({note})")
    return n_dbl


def merge_check(records, args, note) -> None:
    """K5 against its plain version. Like K4 it writes its bucket table in
    place: each side starts from its own copy of the captured table (K4's
    interior buckets written), and the tables are compared."""
    import torch

    from keyless_zk_tpu_torch.ops import cuda_msm

    tag, keys, pts, tbl = args
    tbl0 = tbl.clone()
    got_tbl = tbl0.clone()
    cuda_msm.boundary_merge(tag, keys, pts, got_tbl)
    want_tbl = tbl0.clone()
    with plain_kernels():
        _, plain_ms = cuda_ms(lambda: cuda_msm.boundary_merge_plain(tag, keys, pts, want_tbl), warm=False)
    _, ms = cuda_ms(lambda: cuda_msm.boundary_merge(*args), reps=3)
    written = int(torch.unique(keys[(keys >= 0) & (keys < tbl.shape[1])]).numel())
    moved = nbytes(keys, pts) + written * tbl0.shape[0] * tbl0.element_size()
    record(records, "boundary_merge", max_abs_err(got_tbl, want_tbl), ms, plain_ms,
           f"{note}, {written} buckets written", moved=moved, imad=msm_imad("boundary_merge", args))


def planted(records, name, err, note) -> None:
    """An untimed kernel-vs-plain comparison on planted inputs."""
    rec = records.setdefault(name, {"max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                                    "bound_ms": 0.0})
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    log(f"kernel {name} [planted: {note}]: equal={err == 0}")
    check(err == 0, f"{name} differs from its plain version (planted: {note})")


def k5_planted(dev, records, m: int = 1 << 16) -> None:
    """K5 on planted boundary sequences of m entries, G1 and G2: leading
    sentinels, runs of random length that cross tiles, one run over 5/8 of
    the sequence (160 tiles at m = 2^16), and at the tail ids >= n_seg or a
    bucket (which the last level writes); and one key over the whole
    sequence. Each side writes its own copy of the table."""
    import torch

    from keyless_zk_tpu_torch.curves.jacobian import G1_CURVE, G2_CURVE
    from keyless_zk_tpu_torch.ops import cuda_msm, testgen

    gen = torch.Generator(device=dev)
    gen.manual_seed(41)
    n_seg = 45_078
    for tag in ("fq", "fq2"):
        curve = G1_CURVE if tag == "fq" else G2_CURVE
        x, y, inf = testgen.random_points(m, seed=43, curve=curve, device=dev)
        inf = inf.bool() | (torch.rand(m, generator=gen, device=dev) < 0.01)
        pts = cuda_msm.point_to_planes(curve.from_affine(x, y, inf), tag)
        runs = torch.randint(1, 9, (m,), generator=gen, device=dev)
        runs[100] = m * 5 // 8
        starts = torch.cumsum(runs, 0) - runs
        runs_keys = (torch.searchsorted(starts, torch.arange(m, device=dev), right=True) - 1).int()
        runs_keys[:37] = -1
        runs_keys = torch.cummax(runs_keys, 0).values.int().contiguous()
        mixed = runs_keys.clone()
        mixed[-(m // 200):] += n_seg  # ids >= n_seg
        for label, keys in (("mixed runs", mixed), ("mixed runs, a bucket last", runs_keys),
                            ("one key", torch.full((m,), 7, dtype=torch.int32, device=dev))):
            tbl0 = torch.randint(0, 1 << 16, (3 * cuda_msm.rows_for(tag), n_seg), generator=gen,
                                 dtype=torch.int32, device=dev)
            got, want = tbl0.clone(), tbl0.clone()
            cuda_msm.boundary_merge(tag, keys, pts, got)
            with plain_kernels():
                cuda_msm.boundary_merge_plain(tag, keys, pts, want)
            planted(records, "boundary_merge", max_abs_err(got, want), f"{tag} m={m} {label}")


def k7_cases(tag: str, c: int, dev) -> dict:
    """K7's planted window totals, {label: [W0, W1, ...]} (one-point
    JacPoints, lowest window first): the top and a middle window at
    infinity; W0 = 2^c W1 (add_core's doubling branch); W0 = -2^c W1
    (P + (-P), infinity); all at infinity."""
    from keyless_zk_tpu_torch.curves.jacobian import G1_CURVE, G2_CURVE, JacPoint
    from keyless_zk_tpu_torch.ops import testgen

    curve = G1_CURVE if tag == "fq" else G2_CURVE
    f = curve.ops
    x, y, inf = testgen.random_points(4, seed=47, curve=curve, device=dev)
    p = curve.dbl(curve.from_affine(x, y, inf.bool()))  # z != 1
    with plain_kernels():
        top = JacPoint(*(co[:1] for co in p))
        big = top
        for _ in range(c):
            big = curve.dbl(big)
    inf_pt = curve.infinity((1,), dev)
    return {
        "top and a middle window at infinity": [JacPoint(*(co[1:2] for co in p)), inf_pt,
                                                JacPoint(*(co[2:3] for co in p)), inf_pt],
        "W0 = 2^c W1": [big, top],
        "W0 = -2^c W1": [JacPoint(big.x, f.neg(big.y), big.z), top],
        "all at infinity": [inf_pt, inf_pt, inf_pt],
    }


def _planes(tag: str, pts: list):
    import torch

    from keyless_zk_tpu_torch.curves.jacobian import JacPoint
    from keyless_zk_tpu_torch.ops import cuda_msm

    return cuda_msm.point_to_planes(JacPoint(*(torch.cat(co) for co in zip(*pts))), tag)


def k7_planted(dev, records) -> None:
    """K7 at c = 12, G1 and G2, on the planted window totals of `k7_cases`."""
    from keyless_zk_tpu_torch.ops import cuda_msm

    c = 12
    for tag in ("fq", "fq2"):
        for label, pts in k7_cases(tag, c, dev).items():
            wins = _planes(tag, pts)
            got = cuda_msm.horner_total(tag, wins, c)
            with plain_kernels():
                want = cuda_msm.horner_total_plain(tag, wins, c)
            planted(records, "horner_total", max_abs_err(got, want), f"{tag} Wn={wins.shape[1]} c={c}, {label}")
            if label == "W0 = -2^c W1":
                check(bool((got[-cuda_msm.rows_for(tag):] == 0).all()), "K7: P + (-P) is not at infinity")


def k7_planted_batched(dev, records) -> None:
    """The batched K7 at c = 12, G1 and G2, on one batch of the four
    planted cases of `k7_cases`, each padded to four windows with
    infinity at the top (Horner's chain reaches each case's own top window
    from infinity, so every planted branch still fires)."""
    import torch

    from keyless_zk_tpu_torch.ops import cuda_msm

    c, wn = 12, 4
    for tag in ("fq", "fq2"):
        cases = k7_cases(tag, c, dev)
        pad = cases["all at infinity"][0]
        wins = torch.stack([_planes(tag, pts + [pad] * (wn - len(pts))) for pts in cases.values()], dim=1)
        got = cuda_msm.horner_total(tag, wins, c)
        with plain_kernels():
            want = cuda_msm.horner_total_plain(tag, wins, c)
        planted(records, "horner_total_batched", max_abs_err(got, want),
                f"{tag} B={wins.shape[1]} Wn={wn} c={c}: {'; '.join(cases)}")
        neg = list(cases).index("W0 = -2^c W1")
        check(bool((got[-cuda_msm.rows_for(tag):, neg] == 0).all()), "batched K7: P + (-P) is not at infinity")


def k7_batched_checks(store: dict, records: dict) -> None:
    """Each captured call of the batched K7 (the warm-up batch's window
    totals at B = 4) through the kernel at B = 1, 2 and 4 (its first B
    elements) and through its plain version. The plain version runs the
    four independent chains once; its first B columns are its result at B,
    and its time is recorded with the B = 4 comparison."""
    from keyless_zk_tpu_torch.ops import cuda_msm

    for tag in ("fq", "fq2"):
        check(any(sig[:2] == ("horner_total", tag) and len(sig[2]) == 3 for sig in store),
              f"no batched call of horner_total ({tag}) captured")
    for sig, (tag, wins, c) in store.items():
        *_, B, wn = wins.shape
        with plain_kernels():
            want, plain_ms = cuda_ms(lambda: cuda_msm.horner_total_plain(tag, wins, c), warm=False)
        for b in (1, 2, 4):
            sub = wins[:, :b].contiguous()
            got, ms = cuda_ms(lambda: cuda_msm.horner_total(tag, sub, c), reps=3)
            record(records, "horner_total_batched", max_abs_err(got, want[:, :b]), ms, plain_ms if b == B else 0.0,
                   f"{tag} B={b} Wn={wn} c={c}: {b} chains of {horner_ops(wn, c)} group ops in one launch",
                   moved=nbytes(sub, got), imad=msm_imad("horner_total", (tag, sub, c)))


def msm_kernel_checks(store: dict, records: dict, dev) -> None:
    """Each captured main-path call of K4-K7 through the kernel and through
    its plain version on the same card tensors: the outputs must be equal.
    Then K5 and K7 on planted edge cases."""
    from keyless_zk_tpu_torch.ops import cuda_msm

    for name in MSM_KERNELS:
        for tag in ("fq", "fq2"):
            check(any(sig[:2] == (name, tag) for sig in store), f"no main-path call of {name} ({tag}) captured")
    for sig, args in store.items():
        name = sig[0]
        if name == "window_scan":
            scan_check(records, args, _describe(sig))
            continue
        if name == "boundary_merge":
            merge_check(records, args, _describe(sig))
            continue
        note = _describe(sig)
        if name == "horner_total":
            _, ms = cuda_ms(lambda: cuda_msm.horner_total(*args), reps=3)
            note += f", {1e3 * ms / horner_ops(args[1].shape[-1], args[2]):.3f} us per chained op"
        compare(records, name, getattr(cuda_msm, name), getattr(cuda_msm, name + "_plain"), args, note,
                imad=msm_imad(name, args))
    k5_planted(dev, records)
    k7_planted(dev, records)


# ---- K4's complete body ----------------------------------------------------------

PLANTED_ROWS = 1 << 16


def planted_table(tag: str, dev):
    """A table of PLANTED_ROWS rows: random points, each in four
    consecutive rows, the four rows of every 97th point at infinity (zero
    coordinates), and scalars whose lowest c-bit digit is nonzero and
    shared by a point's four rows, so that every run of window 0 adds
    P + P at once. Returns (curve, x, y, inf, scalars)."""
    import torch

    from keyless_zk_tpu_torch.curves.jacobian import G1_CURVE, G2_CURVE
    from keyless_zk_tpu_torch.fields.torch_field import FR
    from keyless_zk_tpu_torch.ops import testgen
    from keyless_zk_tpu_torch.ops.msm import fused_window_bits

    curve = G1_CURVE if tag == "fq" else G2_CURVE
    n, groups = PLANTED_ROWS, PLANTED_ROWS // 4
    ux, uy, _ = testgen.random_points(groups, seed=41, curve=curve, device=dev)
    x, y = (t.repeat_interleave(4, dim=0).contiguous() for t in (ux, uy))
    inf = (torch.arange(n, device=dev) // 4) % 97 == 5
    x[inf] = 0
    y[inf] = 0
    gen = torch.Generator(device=dev)
    gen.manual_seed(42)
    scalars = rand_field(gen, n, FR, dev)
    c = fused_window_bits(n)
    digit = torch.randint(1, (1 << (c - 1)) + 1, (groups,), generator=gen, device=dev, dtype=torch.int32)
    scalars[:, 0] = (scalars[:, 0] & (0xFFFF ^ ((1 << c) - 1))) | digit.repeat_interleave(4)
    return curve, x, y, inf, scalars


def complete_planted(dev, records: dict) -> None:
    """K4's two bodies on planted tables (G1 and G2) with P + P in the
    bucket runs: `msm(..., assume_distinct=False)` equal to a double-and-add
    over K3's complete mixed add, the complete body equal to its plain
    version on the stream that msm built, the distinct body not."""
    from keyless_zk_tpu_torch.ops import cuda_msm
    from keyless_zk_tpu_torch.ops.msm import _msm_small, msm

    for tag in ("fq", "fq2"):
        t0 = time.perf_counter()
        curve, x, y, inf, scalars = planted_table(tag, dev)
        calls: dict = {}
        t1 = time.perf_counter()
        with capture_calls(cuda_msm, ("window_scan_complete",), calls):
            got = curve.decode_jacobian(msm(x, y, inf, scalars, curve=curve, assume_distinct=False))
        t2 = time.perf_counter()
        want = curve.decode_jacobian(_msm_small(x, y, inf, scalars, curve=curve))
        t3 = time.perf_counter()
        log(f"complete body, planted {tag} ({PLANTED_ROWS} rows, each point in four consecutive rows): "
            f"msm(assume_distinct=False) == K3 double-and-add: {got == want} (table {t1 - t0:.2f} s, "
            f"msm {t2 - t1:.2f} s, double-and-add {t3 - t2:.2f} s)")
        check(got == want, f"planted {tag}: msm(assume_distinct=False) differs from the double-and-add")
        (sig, args), = calls.items()
        n_dbl = complete_scan_check(records, args, f"planted: {_describe(sig)}", distinct_differs=True)
        check(n_dbl > 0, f"planted {tag}: no lane of the complete scan took the doubling")


def raw_table_msms(prover, w, dev, records: dict, counts: dict) -> None:
    """`msm(..., assume_distinct=False)` at full width on the key's raw
    tables A, B1, C (G1) and B2 (G2), which repeat points (the zkey the
    service loaded, checked equal to the setup's key), with the prover's
    windows, each equal as an affine point to the prover's MSM of the same
    witness over its deduplicated table, with both times. The launch
    counts of the four MSMs are the "complete" path's; msm_a's scan stream
    is captured and held against the plain version."""
    import numpy as np
    import torch

    from keyless_zk_tpu_torch.curves.jacobian import G1_CURVE, G2_CURVE
    from keyless_zk_tpu_torch.groth16.prover import _SPARSE_C
    from keyless_zk_tpu_torch.ops import _build, cuda_msm
    from keyless_zk_tpu_torch.ops.msm import msm

    pk = prover.pk
    pad_c = pk.n_vars - pk.points_c.x.shape[0]  # C pairs with the witness from row pad_c on

    def on_card(t):
        return (torch.from_numpy(np.ascontiguousarray(t.x).astype(np.int32)).to(dev),
                torch.from_numpy(np.ascontiguousarray(t.y).astype(np.int32)).to(dev),
                torch.from_numpy(np.asarray(t.inf, bool)).to(dev))

    runs = {  # raw table, its scalars, the prover's table and merge, curve
        "a": (on_card(pk.points_a), w, prover.points_a, prover._merge_a, G1_CURVE),
        "b1": (on_card(pk.points_b1), w, prover.points_b1, prover._merge_b1, G1_CURVE),
        "b2": (on_card(pk.points_b2), w, prover.points_b2, prover._merge_b2, G2_CURVE),
        "c": (on_card(pk.points_c), w[pad_c:], prover.points_c, prover._merge_c, G1_CURVE),
    }
    torch.cuda.synchronize()
    scan_calls: dict = {}
    got = {}
    _build.reset_launch_counts()
    for name, (raw, sc, _, _, curve) in runs.items():
        spy = capture_calls(cuda_msm, ("window_scan_complete",), scan_calls) if name == "a" else contextlib.nullcontext()
        with spy:
            got[name] = msm(*raw, sc, curve=curve, c=_SPARSE_C, assume_distinct=False)
    counts.update(_build.launch_counts())
    log(f"launch counts (complete path: the four MSMs on the raw tables): "
        f"{json.dumps({k: v for k, v in counts.items() if v})}")
    check(counts["window_scan_complete"] == 4 and counts["window_scan"] == 0,
          "the raw-table MSMs did not each launch the complete scan once, and the distinct one never")
    for name, (raw, sc, table, merge, curve) in runs.items():
        merged = prover._merge_scalars(w, merge)
        want = msm(*table, merged, curve=curve, c=_SPARSE_C)
        equal = curve.decode_jacobian(got[name]) == curve.decode_jacobian(want)
        _, raw_ms = cuda_ms(lambda: msm(*raw, sc, curve=curve, c=_SPARSE_C, assume_distinct=False), reps=3)
        _, dedup_ms = cuda_ms(lambda: msm(*table, merged, curve=curve, c=_SPARSE_C), reps=3)
        log(f"complete body, raw table msm_{name}: {raw[2].shape[0]} rows ({table[2].shape[0]} distinct), "
            f"== the prover's MSM over its deduplicated table: {equal}; msm(assume_distinct=False) on the raw "
            f"table {raw_ms:.3f} ms, the prover's (distinct body) on the deduplicated table {dedup_ms:.3f} ms")
        check(equal, f"msm_{name} on the raw table differs from the prover's deduplicated MSM")
    (sig, args), = scan_calls.items()
    complete_scan_check(records, args, f"raw msm_a stream: {_describe(sig)}", distinct_differs=None)
    del runs, got, scan_calls
    torch.cuda.empty_cache()


def redc_kernel_checks(store: dict, records: dict) -> None:
    """Each captured call of K8 (both bodies) of the matmul plan's iNTT and
    NTT through the kernel and through its plain version."""
    from keyless_zk_tpu_torch.ops import cuda_redc

    for name in REDC_KERNELS:
        check(any(sig[0] == name for sig in store), f"no call of {name} captured")
    plains = {"redc": cuda_redc.redc_columns, "redc_twiddle": cuda_redc.redc_twiddle_plain}
    for sig, args in store.items():
        n = args[0].shape[1]
        imad = n * (REDC_IMAD + (FQ_MUL_IMAD if sig[0] == "redc_twiddle" else 0))
        compare(records, sig[0], getattr(cuda_redc, sig[0]), plains[sig[0]], args, _describe(sig), imad=imad)


def ntt_pass_products(n: int, batch: int, log_line: int, final: bool, *, ab: bool = False, scale: bool = False,
                      h: bool = False) -> int:
    """Montgomery products of one K10 pass over `batch` vectors of n points:
    (L - 1) / 2 a point for 2^L-point lines (the last stage's twiddle is 1),
    two a point for the four-step twiddle of a pass that is not the last
    (its two factors' product and the multiply), and the fusions': c = a * b
    (n), a scale (one a point), h = A * B - C out of Montgomery form (2n)."""
    per_point = max(log_line - 1, 0) / 2 + (0 if final else 2)
    return int(batch * n * per_point + (n if ab else 0) + (batch * n if scale else 0) + (2 * n if h else 0))


def ntt_products(plan, batch: int, *, chain: bool = False, scale: bool = False) -> int:
    """Montgomery products of one transform of K10's plan (`chain`: the
    fused h chain, an iNTT and an NTT)."""
    passes = plan.passes
    total = 0
    for i, p in enumerate(passes):
        last = i == len(passes) - 1
        total += ntt_pass_products(plan.n, batch, p.log_line, p.final, ab=chain and i == 0,
                                   scale=(chain or scale) and last)
        if chain:
            total += ntt_pass_products(plan.n, batch, p.log_line, p.final, h=last)
    return total


def ntt_pass_checks(store: dict, records: dict) -> None:
    """Each captured call of K10 (one pass) through the kernel and through its
    plain version (K1 routed to its plain version too), with the bound."""
    from keyless_zk_tpu_torch.ops import cuda_ntt

    check(len(store) == NTT_PROVE_LAUNCHES, f"{len(store)} distinct K10 passes captured, not {NTT_PROVE_LAUNCHES}")
    for sig, args in store.items():
        _, p, batch, in_fmt, out_fmt, scale = args
        imad = FQ_MUL_IMAD * ntt_pass_products(1 << p.log_n, batch, p.log_line, p.final, ab=in_fmt == cuda_ntt.IN_AB,
                                               scale=scale is not None, h=out_fmt == cuda_ntt.OUT_H)
        compare(records, "ntt_pass", cuda_ntt.ntt_pass, cuda_ntt.ntt_pass_plain, args, _describe(sig), imad=imad)


# ---- proofs ---------------------------------------------------------------------

def prove_checked(prover, key, r, s, label):
    from keyless_zk_tpu_torch.fields import torch_field as tf
    from keyless_zk_tpu_torch.ops import testgen

    t0 = time.perf_counter()
    proof = prover.prove(key.witness, r=r, s=s)
    wall = (time.perf_counter() - t0) * 1e3
    h = tf.decode_ints(prover.last_h[0], tf.FR)
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
        5, n_vars=1000, n_public=1, domain_pow=10, n_distinct_a=900, n_distinct_b=600, n_coefs=20_000, device=dev
    )
    gpu = Groth16Prover(key.pk, dev)
    cpu = Groth16Prover(key.pk, "cpu")
    log(f"small proof plans: gpu {type(gpu.plan).__name__}, cpu {type(cpu.plan).__name__}")
    check(type(gpu.plan).__name__ == "CudaNTTPlan", "the card's small proof does not run K10's NTT")
    gpu_proof, _ = prove_checked(gpu, key, R_FIXED, S_FIXED, "small proof (gpu, K10 NTT, domain 2^10)")
    torch.set_num_threads(8)
    cpu_proof, _ = prove_checked(cpu, key, R_FIXED, S_FIXED, "small proof (cpu plain, K10's plain passes, domain 2^10)")
    equal = gpu_proof == cpu_proof
    log(f"small proof: gpu == cpu: {equal}")
    check(equal, "the GPU proof differs from the CPU proof")


def eval_ab_compare(records: dict, note: str, table, w) -> float:
    """K9 on one table and witness against its plain version (K1 routed to
    its plain version too): equal or fail, both times, the bound. Bytes:
    the table, the witness and the output once (the gathers of witness
    rows are L2 hits); multiply-adds: one CIOS product per entry and per
    witness row (its packing). Returns the kernel's ms."""
    from keyless_zk_tpu_torch.ops import cuda_eval_ab

    got, ms = cuda_ms(lambda: cuda_eval_ab.eval_ab(w, table), reps=5)
    with plain_kernels():
        want, plain_ms = cuda_ms(lambda: cuda_eval_ab.eval_ab_plain(w, table), warm=False)
    record(records, "eval_ab", max_abs_err(got, want), ms, plain_ms, note,
           moved=nbytes(w, table.row_ptr, table.src, table.val, table.part_row, got),
           imad=(table.nnz + w.shape[0]) * FQ_MUL_IMAD)
    return ms


def eval_ab_checks(label: str, prover, w, records: dict) -> None:
    """K9 on a prover's own table (entries per row: empty rows, median, p99,
    max), then the h scalars' time beside it (CUDA events)."""
    import numpy as np

    table = prover.coef_table
    n = np.diff(table.row_ptr.cpu().numpy())
    log(f"{label}: coefficient table {table.nnz} entries over {n.shape[0]} rows: {int((n == 0).sum())} empty, "
        f"median {np.median(n):.0f}, p99 {np.percentile(n, 99):.0f}, max {int(n.max())} entries per row")
    ab_ms = eval_ab_compare(records, f"{label}, the prover's table", prover.coef_table, w)
    _, h_ms = cuda_ms(lambda: prover._h_scalars(w), reps=3)
    log(f"{label}: eval_ab {ab_ms:.3f} ms of h scalars {h_ms:.3f} ms ({prover.pk.n_coefs} coefficients)")


def eval_ab_planted(dev, records: dict) -> None:
    """K9 on planted tables (ops/testgen.py `coef_table_of_lengths`) with a
    witness near r in a quarter of its rows: the keyless shape's 2^22 rows
    with an empty first row, a row of the most entries the prover takes
    (2^23 - 1), short rows, 2^20 empty rows and a last row of 20,000; one
    row of 2^22 entries among 64; rows one entry short of and one past a
    block's share of the merge path; a table with no entries."""
    import numpy as np

    from keyless_zk_tpu_torch.ops import cuda_eval_ab, testgen

    n_vars = testgen.KEYLESS_SHAPE["n_vars"]
    n_rows = 2 << testgen.KEYLESS_SHAPE["domain_pow"]
    share = cuda_eval_ab.ITEMS_PER_THREAD * cuda_eval_ab.BLOCK_THREADS
    rng = np.random.default_rng(3)
    skewed = rng.integers(0, 41, n_rows)
    skewed[0] = 0
    skewed[1] = cuda_eval_ab.MAX_ROW_ENTRIES
    skewed[2 : 1 << 21] = rng.integers(1, 4, (1 << 21) - 2)
    skewed[1 << 21 : 3 << 20] = 0
    skewed[-1] = 20000
    one = np.zeros(64, np.int64)
    one[5] = 1 << 22
    one[-1] = 3
    across = np.full(20000, share - 1)
    across[::2] = share + 1
    for i, (note, lengths, nv) in enumerate((
        ("planted: 2^22 rows, row 0 empty, row 1 of 2^23 - 1, 2^20 empty rows, last row 20000", skewed, n_vars),
        ("planted: one row of 2^22 entries among 64 rows", one, 1000),
        (f"planted: rows of {share - 1} and {share + 1} entries, a block's share {share}", across, n_vars),
        ("planted: 2^20 rows, no entries", np.zeros(1 << 20, np.int64), 100),
    )):
        table = testgen.coef_table_of_lengths(lengths, nv, 40 + i, dev)
        eval_ab_compare(records, note, table, testgen.witness_near_r(nv, 50 + i, dev))
        del table


def ntt_plans(prover, w, dev, records: dict, counts_mxu: dict) -> None:
    """K10 (the prover's plan) at the keyless shape, (3, 2^21) random values
    with 0, 1 and r - 1 planted: its NTT, iNTT and fused h chain against the
    plain version, timed beside their bounds; the full-width h scalars under
    K10, the matmul plan (K8) and the butterfly plan on the card: equal;
    each plan's iNTT, NTT and h chain ms in turns (K10's chain also unfused:
    its public transforms with K1's pointwise products between); K8's
    calls captured from the matmul plan's iNTT and NTT against their plain
    versions, with its launches; the int8 product of one matmul pass."""
    import torch

    from keyless_zk_tpu_torch.fields import torch_field as tf
    from keyless_zk_tpu_torch.ops import _build, cuda_redc
    from keyless_zk_tpu_torch.ops.mxu_ntt import MxuNTTPlan
    from keyless_zk_tpu_torch.ops.ntt import NTTPlan

    k10 = prover.plan
    n, dp = prover.pk.domain_size, prover.domain_pow
    gen = torch.Generator(device=dev).manual_seed(19)
    x = rand_field(gen, 3 * n, tf.FR, dev).reshape(3, n, 16)
    edges = tf.encode_ints([0, 1, tf.FR.p - 1], tf.FR, device=dev)
    for i in (0, n // 2, n - 3):
        x[:, i : i + 3] = edges
    ab = torch.cat([x[0], x[1]])
    note = f"(3, 2^{dp}) random, 0 / 1 / r - 1 planted"
    compare(records, "ntt_pass", k10.ntt, k10.ntt, (x,), f"ntt {note}", imad=FQ_MUL_IMAD * ntt_products(k10, 3))
    compare(records, "ntt_pass", k10.intt, k10.intt, (x,), f"intt {note}",
            imad=FQ_MUL_IMAD * ntt_products(k10, 3, scale=True))
    compare(records, "ntt_pass", k10.h_scalars, k10.h_scalars, (ab,), f"h chain (iNTT, coset, NTT, h) {note}",
            imad=FQ_MUL_IMAD * ntt_products(k10, 3, chain=True))

    def chain_unfused(plan, ab):
        a, b = ab[:n], ab[n:]
        abc = plan.intt(torch.stack([a, b, tf.mont_mul(a, b, tf.FR)]))
        abc = plan.ntt(tf.mont_mul(abc, k10.coset_powers(), tf.FR))
        return tf.from_mont(tf.sub(tf.mont_mul(abc[0], abc[1], tf.FR), abc[2], tf.FR), tf.FR)

    matmul = MxuNTTPlan(dp, dev)
    butterfly = NTTPlan(dp, dev)
    got, ab_w = prover._h_scalars(w), prover._eval_ab(w)
    equal = {label: torch.equal(chain_unfused(plan, ab_w), got)
             for label, plan in (("matmul", matmul), ("butterfly", butterfly))}
    equal["K10 unfused"] = torch.equal(chain_unfused(k10, ab), k10.h_scalars(ab))
    log(f"full width: h scalars, K10 (fused) == {json.dumps(equal)}")
    check(all(equal.values()), "the h scalars differ between K10 and another NTT plan or its unfused chain")
    for label, plan in (("K10", k10), ("matmul", matmul), ("butterfly", butterfly), ("K10", k10),
                        ("matmul", matmul), ("butterfly", butterfly)):
        _, intt_ms = cuda_ms(lambda: plan.intt(x), reps=3)
        _, ntt_ms = cuda_ms(lambda: plan.ntt(x), reps=3)
        _, chain_ms = cuda_ms(lambda: chain_unfused(plan, ab), reps=3)
        fused = f", fused h chain {cuda_ms(lambda: k10.h_scalars(ab), reps=5)[1]:.3f} ms" if plan is k10 else ""
        log(f"ntt plan {label} (3, 2^{dp}): intt {intt_ms:.3f} ms, ntt {ntt_ms:.3f} ms, "
            f"unfused h chain {chain_ms:.3f} ms{fused}")
    del butterfly

    # K8, off the prover's path: the matmul plan's iNTT and NTT
    calls: dict = {}
    _build.reset_launch_counts()
    with capture_calls(cuda_redc, REDC_KERNELS, calls):
        matmul.ntt(matmul.intt(x))
    counts_mxu.update(_build.launch_counts())
    log(f"launch counts (the matmul plan's iNTT and NTT of (3, 2^{dp})): "
        f"{json.dumps({k: v for k, v in counts_mxu.items() if v})}")
    redc_kernel_checks(calls, records)
    del calls

    # the int8 product of one radix-128 pass over the batched input
    w_big = matmul.tables[0][0]
    cols = 3 * n // 128
    planes = torch.randint(-128, 128, (cols, w_big.shape[1]), dtype=torch.int8, device=dev)
    _, mm_ms = cuda_ms(lambda: torch._int_mm(w_big, planes.t()), reps=5)
    ops = 2 * w_big.shape[0] * w_big.shape[1] * cols
    moved = nbytes(w_big, planes) + w_big.shape[0] * cols * 4
    bound = max(ops / INT8_OPS_PER_S, moved / HBM_BYTES_PER_S) * 1e3
    log(f"int8 product of one pass ({w_big.shape[0]} x {w_big.shape[1]} @ {w_big.shape[1]} x {cols}): "
        f"{mm_ms:.3f} ms, bound {bound:.3f} ms ({ops / 1e12:.3f} T int8 ops, {moved / 1e9:.3f} GB), "
        f"{len(matmul.factors)} passes per transform")


def check_k1_launches(counts: dict, path: str) -> None:
    """K1 on one proof: the decode's two inversions as two launches of
    mont_pow, and at most K1_PROVE_LAUNCHES launches of the product."""
    check(counts.get("mont_pow", 0) == 2, f"{path}: {counts.get('mont_pow', 0)} mont_pow launches, not 2")
    check(counts["mont_mul"] <= K1_PROVE_LAUNCHES,
          f"{path}: {counts['mont_mul']} K1 product launches, more than {K1_PROVE_LAUNCHES}")


def check_ntt_launches(counts: dict, path: str, proofs: int = 1) -> None:
    """K10 on `proofs` proofs: NTT_PROVE_LAUNCHES passes each; K8 none."""
    got = counts.get("ntt_pass", 0)
    check(got == NTT_PROVE_LAUNCHES * proofs, f"{path}: {got} K10 launches, not {NTT_PROVE_LAUNCHES * proofs}")
    check(counts.get("redc", 0) + counts.get("redc_twiddle", 0) == 0, f"{path}: K8 launched")


def full_width(dev, counts_out: dict, records: dict, counts_mxu: dict) -> None:
    import torch

    from keyless_zk_tpu_torch.groth16.prover import Groth16Prover
    from keyless_zk_tpu_torch.ops import _build, cuda_field, cuda_msm, cuda_ntt, testgen

    t0 = time.perf_counter()
    key = testgen.synthetic_key(2026, device=dev, **testgen.KEYLESS_SHAPE)
    torch.cuda.synchronize()
    log(f"full width: key generation {time.perf_counter() - t0:.1f} s "
        f"(n_vars {key.pk.n_vars}, domain {key.pk.domain_size}, coefficients {key.pk.n_coefs})")
    t0 = time.perf_counter()
    prover = Groth16Prover(key.pk, dev)
    torch.cuda.synchronize()
    log(f"full width: prover construction {time.perf_counter() - t0:.1f} s, NTT plan {type(prover.plan).__name__}")
    check(type(prover.plan).__name__ == "CudaNTTPlan", "the full-width proof does not run K10's NTT")

    msm_calls: dict = {}
    ntt_calls: dict = {}
    pow_calls: dict = {}
    with capture_calls(cuda_msm, MSM_KERNELS, msm_calls), capture_calls(cuda_ntt, ("ntt_pass",), ntt_calls), \
            capture_calls(cuda_field, ("mont_pow",), pow_calls):
        prove_checked(prover, key, R_FIXED, S_FIXED, "full proof warm-up (K4-K7, K10 and mont_pow inputs captured)")
    log("  phases (ms): " + json.dumps({k: round(v, 3) for k, v in prover.phase_ms.items()}))
    msm_kernel_checks(msm_calls, records, dev)
    del msm_calls
    ntt_pass_checks(ntt_calls, records)
    del ntt_calls
    decode_pow_checks(pow_calls, records)
    del pow_calls
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    walls = []
    for i in range(3):
        if i == 0:
            _build.reset_launch_counts()
        _, wall = prove_checked(prover, key, R_FIXED + i, S_FIXED + i, f"full proof {i + 1}")
        if i == 0:
            counts_out.update(_build.launch_counts())
        walls.append(wall)
        log("  phases (ms): " + json.dumps({k: round(v, 3) for k, v in prover.phase_ms.items()}))
    log(f"full width: proof wall ms {[round(w, 1) for w in walls]}, "
        f"peak device memory over the timed proofs {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"launch counts (prove path, one full proof): {json.dumps(counts_out)}")
    for name, _, _, path in KERNELS:
        if path == "prove":
            check(counts_out.get(name, 0) > 0, f"kernel {name} was not launched by the prove path")
    check(counts_out["boundary_merge"] <= 3 * 5, "K5 took more than three launches per MSM")
    check_k1_launches(counts_out, "the full-width proof")
    check(counts_out.get("window_scan_complete", 0) == 0, "the full-width proof launched the complete scan")
    check(counts_out.get("eval_ab", 0) == 1, f"{counts_out.get('eval_ab', 0)} eval_ab launches in one proof, not 1")
    check_ntt_launches(counts_out, "the full-width proof")

    w = torch.from_numpy(key.witness.astype("int32")).to(dev)
    got = prover._h_scalars(w)
    with plain_kernels():
        want = prover._h_scalars(w)
    equal = torch.equal(got, want)
    log(f"full width: h scalars kernel path == plain path: {equal}")
    check(equal, "h scalars differ between the kernel path and the plain path")
    eval_ab_checks("full width", prover, w, records)
    eval_ab_planted(dev, records)
    ntt_plans(prover, w, dev, records, counts_mxu)


# ---- the setup path ------------------------------------------------------------

def chain_circuit(domain_pow: int):
    """a == b^m, m = 2^domain_pow - 4 (one constraint per product, then the
    equality), a public, b = 3: (cs, witness ints, public wire)."""
    from keyless_zk_tpu_torch.circuits import ConstraintSystem
    from keyless_zk_tpu_torch.fields import bn254

    m = (1 << domain_pow) - 4
    cs = ConstraintSystem()
    a = cs.public_wire()
    cs.set_input_hint([a], "a")
    b = cs.new_wire()
    cs.set_input_hint([b], "b")
    x = b
    for _ in range(m - 1):
        x = cs.mul(cs.lc(x), cs.lc(b))
    cs.constrain_eq(cs.lc(x), cs.lc(a))
    w = cs.compute_witness(a=pow(3, m, bn254.R_SCALAR), b=3)
    return cs, w, a


def k3_ladder_checks(calls: dict, seen: dict, records: dict, device_s: float) -> None:
    """Each captured setup ladder call of K3 (dbl, and madd with the
    generator broadcast) through the kernel and its plain version, and K3's
    share of the device ladders: launches x ms per kernel and group."""
    from keyless_zk_tpu_torch.ops import cuda_curve

    for name in ("curve_dbl", "curve_madd"):
        for tag in ("fq", "fq2"):
            check(any(sig[0] == name and sig[-1] == tag for sig in calls), f"no setup call of {name} ({tag}) captured")
    check(set(seen) == set(calls), "a setup ladder call signature ran too few times to be captured")
    k3_seconds: dict = {}
    for sig, args in calls.items():
        name, tag = sig[0], sig[-1]
        n = args[0].x.shape[0]
        if name == "curve_dbl":
            ms = compare(records, name, cuda_curve.curve_dbl, cuda_curve.dbl_plain, args,
                         f"setup ladder step, {tag} n={n}", imad=group_imad("dbl", tag, n))
        else:
            ms = compare(records, name, cuda_curve.curve_madd, cuda_curve.madd_plain, args,
                         f"setup ladder step, {tag} n={n}, generator broadcast", imad=group_imad("madd", tag, n))
        k3_seconds[f"{name} {tag}"] = k3_seconds.get(f"{name} {tag}", 0.0) + seen[sig] * ms / 1e3
        log(f"  {seen[sig]} launches of this signature: {seen[sig] * ms / 1e3:.3f} s")
    k3_total = sum(k3_seconds.values())
    log(f"  K3 in the device ladders (s, launches x ms): {json.dumps({k: round(v, 3) for k, v in k3_seconds.items()})}, "
        f"{k3_total:.2f} s of {device_s:.2f} s, the rest {device_s - k3_total:.2f} s")


def verify_checked(vk, public: list, proof, label: str, tamper: bool = False) -> None:
    """The port's pairing check of a proof: it must verify, and with
    `tamper` the proof with one coordinate changed must not."""
    from keyless_zk_tpu_torch.groth16 import verify_groth16

    t0 = time.perf_counter()
    ok = verify_groth16(vk, public, proof.to_json_dict())
    note = f"{label}: pairing check {time.perf_counter() - t0:.1f} s, verifies {ok}"
    if tamper:
        tampered = proof.to_json_dict()
        tampered["pi_c"][0] = str(int(tampered["pi_c"][0]) + 1)
        bad = verify_groth16(vk, public, tampered)
        note += f", tampered verifies {bad}"
        check(not bad, f"{label}: a tampered proof verifies")
    log(note)
    check(ok, f"{label}: the proof does not verify")


def setup_path(dev, records: dict, path_counts: dict, domain_pow: int = 16) -> None:
    import torch

    from keyless_zk_tpu_torch.circuits import groth16_setup, r1cs_from_cs
    from keyless_zk_tpu_torch.groth16 import Groth16Prover
    from keyless_zk_tpu_torch.ops import _build

    t0 = time.perf_counter()
    cs, w, a = chain_circuit(domain_pow)
    check(cs.check_witness(w) is None, "the chain circuit's witness violates a constraint")
    r1cs = r1cs_from_cs(cs)
    log(f"setup path: chain circuit built in {time.perf_counter() - t0:.1f} s "
        f"({r1cs.n_constraints} constraints, {r1cs.n_wires} wires)")
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    res = groth16_setup(r1cs, toxic=TOXIC, device=dev)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    log(f"setup path: groth16_setup {time.perf_counter() - t0:.1f} s (host {res.seconds['host']:.1f} s, "
        f"device ladders {res.seconds['device']:.1f} s), domain {res.pk.domain_size}, "
        f"launches {json.dumps({k: v for k, v in counts.items() if v})}")
    for name, _, _, path in KERNELS:
        if path == "setup":
            check(counts.get(name, 0) > 0, f"kernel {name} was not launched by the chain setup")

    t0 = time.perf_counter()
    prover = Groth16Prover(res.pk, dev)
    witness = cs.witness_np(w)
    t1 = time.perf_counter()
    proof = prover.prove(witness, r=R_FIXED, s=S_FIXED)
    log(f"setup path: prover construction {t1 - t0:.1f} s, proof {1e3 * (time.perf_counter() - t1):.1f} ms "
        f"({type(prover.plan).__name__})")
    log("  phases (ms): " + json.dumps({k: round(v, 3) for k, v in prover.phase_ms.items()}))
    verify_checked(res.vk, [w[a]], proof, "setup path", tamper=True)
    cli_checks(res, w, dev)
    circom_checks(dev, path_counts["circom"])
    sharded_checks(res, prover, witness, proof, [w[a]], dev, records, path_counts["sharded"])


def sharded_checks(res, prover, witness, proof, public: list, dev, records: dict, counts: dict) -> None:
    """The sharded path on the chain key over a one-process NCCL group
    (127.0.0.1, a free port): the sharded prover's proof for the same r and
    s equals the single prover's and verifies (its launch counts into
    `counts`; each captured call of K3's add, which combines the MSM
    partials, against its plain version); four_step_ntt forward and inverse
    equal to the prover's plan; sharded_msm equal to msm on the H table."""
    import socket

    import torch
    import torch.distributed as dist

    from keyless_zk_tpu_torch.curves.jacobian import G1_CURVE
    from keyless_zk_tpu_torch.fields.torch_field import FR
    from keyless_zk_tpu_torch.ops import _build, cuda_curve
    from keyless_zk_tpu_torch.ops.msm import msm
    from keyless_zk_tpu_torch.parallel import distributed
    from keyless_zk_tpu_torch.parallel.sharded import four_step_ntt, make_mesh, sharded_msm
    from keyless_zk_tpu_torch.parallel.sharded_prover import ShardedGroth16Prover

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    check(distributed.initialize(f"tcp://127.0.0.1:{port}", world_size=1, rank=0, device=dev),
          "torch.distributed did not initialize")
    try:
        mesh = make_mesh()
        sharded = ShardedGroth16Prover(res.pk, mesh, dev)
        log(f"sharded: {dist.get_backend()} group of {mesh.size} on 127.0.0.1:{port}, prover construction "
            f"{time.perf_counter() - t0:.1f} s")
        calls: dict = {}
        _build.reset_launch_counts()
        with capture_calls(cuda_curve, ("curve_add",), calls):
            t0 = time.perf_counter()
            got = sharded.prove(witness, r=R_FIXED, s=S_FIXED)
            wall = (time.perf_counter() - t0) * 1e3
        counts.update(_build.launch_counts())
        same = got.to_json_dict() == proof.to_json_dict()
        log(f"sharded: chain proof {wall:.1f} ms, equal to the single prover's: {same}; phases (ms) "
            + json.dumps({k: round(v, 3) for k, v in sharded.phase_ms.items()}))
        log(f"launch counts (sharded prove path, one proof): {json.dumps(counts)}")
        check(same, "the sharded prover's proof differs from the single prover's")
        verify_checked(res.vk, public, got, "sharded chain proof")
        check(counts.get("curve_add", 0) > 0, "K3's add was not launched by the sharded prover")
        for sig, args in calls.items():
            tag = args[-1]
            compare(records, "curve_add", cuda_curve.curve_add, cuda_curve.add_plain, args,
                    f"sharded combine, {tag} n={args[0].x.shape[0]}", imad=add_imad(*args))

        gen = torch.Generator(device=dev)
        gen.manual_seed(53)
        x = rand_field(gen, prover.pk.domain_size, FR, dev)
        for inverse in (False, True):
            a, ms = cuda_ms(lambda: four_step_ntt(x, domain_pow=prover.domain_pow, mesh=mesh, inverse=inverse), reps=3)
            b, plan_ms = cuda_ms(lambda: prover.plan.intt(x) if inverse else prover.plan.ntt(x), reps=3)
            log(f"sharded: four_step_ntt{' inverse' if inverse else ''} 2^{prover.domain_pow} == the plan's: "
                f"{torch.equal(a, b)} ({ms:.3f} ms, the plan {plan_ms:.3f} ms)")
            check(torch.equal(a, b), "four_step_ntt differs from the prover's plan")
        sc = prover._merge_scalars(prover.last_h[0], prover._merge_h)
        a = G1_CURVE.decode_jacobian(_as_batch(sharded_msm(*prover.points_h, sc, curve=G1_CURVE, mesh=mesh)))
        b = G1_CURVE.decode_jacobian(_as_batch(msm(*prover.points_h, sc, curve=G1_CURVE)))
        log(f"sharded: sharded_msm == msm on the H table ({sc.shape[0]} rows): {a == b}")
        check(a == b, "sharded_msm differs from msm")
    finally:
        dist.destroy_process_group()


def run_tool(args: list, label: str, timeout: int = 300) -> subprocess.CompletedProcess:
    """`python -m <args>` from the repository root, with its exit code,
    seconds and last stderr lines logged."""
    t0 = time.perf_counter()
    try:
        out = subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True, timeout=timeout,
                             cwd=Path(__file__).resolve().parent)
    except subprocess.TimeoutExpired:
        raise Failed(f"{label} did not finish within {timeout} s") from None
    log(f"{label}: exit {out.returncode} in {time.perf_counter() - t0:.1f} s, "
        f"stderr {out.stderr.strip().splitlines()[-2:]}")
    return out


CLI_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke" / "cli"


def cli_checks(res, w: list, dev) -> None:
    """The chain key's zkey, witness and vk written to disk and proved by
    `python -m keyless_zk_tpu_torch.groth16.cli prove` in a subprocess
    (exit 0, "verified: true"); its proof through the CLI's `verify`."""
    import io

    from keyless_zk_tpu_torch.fields import bn254
    from keyless_zk_tpu_torch.groth16 import cli
    from keyless_zk_tpu_torch.groth16.wtns import save_wtns, witness_from_ints
    from keyless_zk_tpu_torch.groth16.zkey import save_zkey

    shutil.rmtree(CLI_DIR, ignore_errors=True)
    CLI_DIR.mkdir(parents=True)
    files = {name: str(CLI_DIR / name) for name in ("chain.zkey", "chain.wtns", "chain_vk.json", "proof.json",
                                                     "public.json")}
    t0 = time.perf_counter()
    save_zkey(files["chain.zkey"], res.pk)
    save_wtns(files["chain.wtns"], witness_from_ints(w, bn254.R_SCALAR))
    with open(files["chain_vk.json"], "w") as f:
        json.dump(res.vk, f)
    log(f"cli: files written in {time.perf_counter() - t0:.1f} s")
    out = run_tool(["keyless_zk_tpu_torch.groth16.cli", "prove", "--zkey", files["chain.zkey"], "--wtns",
                    files["chain.wtns"], "--vk", files["chain_vk.json"], "--device", str(dev)],
                   "cli: prove --zkey --wtns --vk")
    check(out.returncode == 0 and "verified: true" in out.stderr, f"the prove CLI failed: {out.stderr[-2000:]}")
    proof_line, public_line = out.stdout.splitlines()[:2]
    for name, line in (("proof.json", proof_line), ("public.json", public_line)):
        with open(files[name], "w") as f:
            f.write(line)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["verify", "--vk", files["chain_vk.json"], "--proof", files["proof.json"],
                       "--public", files["public.json"]])
    log(f"cli: verify on its output: exit {rc}, {buf.getvalue().strip()}")
    check(rc == 0 and buf.getvalue().strip() == "verified: true", "the CLI's verify refused the CLI's proof")


# ---- the circom route and the ceremony tools ---------------------------------------

CIRCOM_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke" / "circom"
CEREMONY_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke" / "ceremony"
# the script's 1200 s hold the chain at 2^19: at 2^20, with the bench phase,
# the script took 1135 s on the H100's host
CIRCOM_DOMAIN_POW = 19
NUM2BITS = 254


def circom_circuit(domain_pow: int):
    """The chain a == b^m (a public, b = 3 private) with an is_zero of
    x = b^(m // 2), exported in circom's wire order, and a circom-form
    Num2Bits(254) of x appended to the exported R1CS (254 rows b (b - 1) = 0
    and one row 0 * 0 = sum 2^i b_i - x: the port's `to_bits` writes its sum
    as (sum - x) * 1 = 0, which the compiler's bits lowering does not read).
    m - 1 products, the equality, two is_zero rows, 255 Num2Bits rows and
    the nPublic + 1 = 2 binding rows fill the domain 2^domain_pow.
    Returns (cs, native witness ints, r1cs, perm, bit wires, x in circom
    order, m)."""
    from keyless_zk_tpu_torch.circuits import ConstraintSystem, gadgets
    from keyless_zk_tpu_torch.circuits.r1cs_file import r1cs_circom_order
    from keyless_zk_tpu_torch.fields import bn254

    m = (1 << domain_pow) - (NUM2BITS + 1) - 4
    cs = ConstraintSystem()
    a = cs.public_wire()
    cs.set_input_hint([a], "a")
    b = cs.new_wire()
    cs.set_input_hint([b], "b")
    y = mid = b
    for k in range(2, m + 1):
        y = cs.mul(cs.lc(y), cs.lc(b))
        if k == m // 2:
            mid = y
    cs.constrain_eq(cs.lc(y), cs.lc(a))
    gadgets.is_zero(cs, cs.lc(mid))
    native = cs.compute_witness(a=pow(3, m, bn254.R_SCALAR), b=3)
    r1cs, perm = r1cs_circom_order(cs)
    p, x = r1cs.prime, perm[mid]
    bits = list(range(r1cs.n_wires, r1cs.n_wires + NUM2BITS))
    for w in bits:
        r1cs.A.append({w: 1})
        r1cs.B.append({w: 1, 0: p - 1})
        r1cs.C.append({})
    r1cs.A.append({})
    r1cs.B.append({})
    r1cs.C.append({w: pow(2, i, p) for i, w in enumerate(bits)} | {x: p - 1})
    r1cs.n_wires += NUM2BITS
    r1cs.n_constraints += NUM2BITS + 1
    return cs, native, r1cs, perm, bits, x, m


def circom_route(dev, counts: dict) -> None:
    """The circom route at 2^CIRCOM_DOMAIN_POW constraints: the circuit's .r1cs (the port's
    save_r1cs), input.json and .sym; `witness_from_input_json` in-process
    with a cold program cache (served by the compiled program, never by the
    Python solver; equal to the native witness under the permutation, its
    bits those of x, every constraint satisfied); `groth16_setup` on the
    card over the circom-order R1CS (its launch counts into `counts`); then
    `cli prove --zkey --r1cs --input --sym --vk` in a subprocess with the
    cache warm: exit 0, "verified: true", its proof verifying under the
    native pairing for a and not for a + 1."""
    import torch

    from keyless_zk_tpu_torch.circuits import circom_interop, groth16_setup
    from keyless_zk_tpu_torch.circuits.r1cs_file import save_r1cs
    from keyless_zk_tpu_torch.groth16 import pairing_native, verify_groth16
    from keyless_zk_tpu_torch.groth16.zkey import save_zkey
    from keyless_zk_tpu_torch.ops import _build

    t0 = time.perf_counter()
    cs, native, r1cs, perm, bits, x, m = circom_circuit(CIRCOM_DOMAIN_POW)
    a = native[1]
    log(f"circom: chain circuit with is_zero and Num2Bits({NUM2BITS}) built in {time.perf_counter() - t0:.1f} s "
        f"(m = {m}; circom order: {r1cs.n_constraints} constraints, {r1cs.n_wires} wires)")
    CIRCOM_DIR.mkdir(parents=True, exist_ok=True)
    files = {name: str(CIRCOM_DIR / name) for name in ("circuit.r1cs", "input.json", "circuit.sym", "circuit.zkey",
                                                        "circuit_vk.json")}
    t0 = time.perf_counter()
    save_r1cs(files["circuit.r1cs"], r1cs)
    with open(files["input.json"], "w") as f:
        json.dump({"a": str(a), "b": "3"}, f)
    with open(files["circuit.sym"], "w") as f:  # #signal, #wire, #component, name
        f.write("1,1,0,main.a\n2,2,0,main.b\n")
    cached = circom_interop.CACHE_ROOT / f"{circom_interop.r1cs_digest(files['circuit.r1cs'])}.npz"
    cached.unlink(missing_ok=True)
    log(f"circom: files written in {time.perf_counter() - t0:.1f} s (r1cs {Path(files['circuit.r1cs']).stat().st_size} "
        f"bytes); program cache {cached}")

    compiled, solved = [], []
    real_cached, real_solve = circom_interop._cached_program, circom_interop.solve_witness

    def cached_program(r, path):
        t = time.perf_counter()
        prog = real_cached(r, path)
        compiled.append((prog, time.perf_counter() - t))
        return prog

    def solve_witness(*args, **kw):
        solved.append(args)
        return real_solve(*args, **kw)

    circom_interop._cached_program, circom_interop.solve_witness = cached_program, solve_witness
    try:
        t0 = time.perf_counter()
        w = circom_interop.witness_from_input_json(files["circuit.r1cs"], files["input.json"], files["circuit.sym"])
        wall = time.perf_counter() - t0
    finally:
        circom_interop._cached_program, circom_interop.solve_witness = real_cached, real_solve
    check(len(compiled) == 1 and not solved, f"the witness was not served by the compiled program "
          f"({len(compiled)} programs, {len(solved)} Python solves)")
    prog, compile_s = compiled[0]
    known = {1: a, 2: 3}
    t0 = time.perf_counter()
    wires = prog.compute(known)
    compute_s = time.perf_counter() - t0
    ops: dict = {}
    for op, *_ in prog.program.cs.ops:
        ops[op] = ops.get(op, 0) + 1
    log(f"circom: witness_from_input_json {wall:.1f} s, of which the cold compile {compile_s:.1f} s "
        f"(ops {json.dumps(ops)}, cached: {cached.exists()}); the program's compute {compute_s:.3f} s")
    same = all(int(w[perm[i]]) == native[i] for i in range(cs.n_wires))
    bits_ok = [int(w[b]) for b in bits] == [(int(w[x]) >> i) & 1 for i in range(NUM2BITS)]
    t0 = time.perf_counter()
    violated = prog.check(wires)
    log(f"circom: witness equal to the native one under the permutation: {same}; Num2Bits bits those of x: "
        f"{bits_ok}; check {time.perf_counter() - t0:.1f} s -> {violated}")
    check(same and bits_ok, "the circom-order witness differs from the native witness")
    check(violated is None, f"the circom-order witness violates constraint {violated}")
    check({"fms", "iszero", "bits"} <= set(ops), "the compiled program lacks an fms, iszero or bits op")
    del cs, native, w, wires, prog, compiled

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    res = groth16_setup(r1cs, toxic=TOXIC, device=dev)
    torch.cuda.synchronize()
    counts.update(_build.launch_counts())
    log(f"circom: groth16_setup {time.perf_counter() - t0:.1f} s (host {res.seconds['host']:.1f} s, device ladders "
        f"{res.seconds['device']:.1f} s), domain {res.pk.domain_size}, launches "
        f"{json.dumps({k: v for k, v in counts.items() if v})}")
    check(res.pk.domain_size == 1 << CIRCOM_DOMAIN_POW, f"the circom setup's domain is {res.pk.domain_size}")
    for name, _, _, path in KERNELS:
        if path == "setup":
            check(counts.get(name, 0) > 0, f"kernel {name} was not launched by the circom setup")
    del r1cs
    t0 = time.perf_counter()
    save_zkey(files["circuit.zkey"], res.pk)
    with open(files["circuit_vk.json"], "w") as f:
        json.dump(res.vk, f)
    log(f"circom: save_zkey and the vk {time.perf_counter() - t0:.1f} s")
    del res

    out = run_tool(["keyless_zk_tpu_torch.groth16.cli", "prove", "--zkey", files["circuit.zkey"], "--r1cs",
                    files["circuit.r1cs"], "--input", files["input.json"], "--sym", files["circuit.sym"], "--vk",
                    files["circuit_vk.json"], "--device", str(dev)], "circom: cli prove --zkey --r1cs --input --sym",
                   timeout=600)
    check(out.returncode == 0 and "verified: true" in out.stderr,
          f"the circom prove CLI failed: {out.stderr[-2000:]}")
    proof_line, public_line = out.stdout.splitlines()[:2]
    proof, public = json.loads(proof_line), [int(v) for v in json.loads(public_line)]
    with open(files["circuit_vk.json"]) as f:
        vk = json.load(f)
    check(pairing_native.available(), "the native pairing did not build")
    ok, tampered = verify_groth16(vk, public, proof), verify_groth16(vk, [public[0] + 1], proof)
    log(f"circom: the CLI's proof for public {public == [a]} verifies under the native pairing {ok}, "
        f"with a + 1 {tampered}")
    check(public == [a] and ok and not tampered, "the circom CLI proof does not verify, or verifies tampered")
    shutil.rmtree(CIRCOM_DIR)


def ceremony_checks(dev) -> None:
    """The ceremony tools on the 2^16 chain key that `cli_checks` wrote: a
    release feed staged under build/chip_smoke/ceremony with file:// URLs,
    read by the default (urllib) fetch; `download_ceremony` with a wrong pin
    raises and installs nothing, with the right pins installs the assets
    byte for byte; `setup_tool cache-push` then `cache-pull` into another
    store (subprocesses) carry every file byte for byte, and `cache-pull` of
    a missing key exits 1; the prove CLI on the pulled zkey and vk with the
    chain's .wtns verifies."""
    import filecmp
    import os

    from keyless_zk_tpu_torch.tooling.ceremony import Releases, download_ceremony

    shutil.rmtree(CEREMONY_DIR, ignore_errors=True)
    release = CEREMONY_DIR / "release"
    release.mkdir(parents=True)
    shutil.copyfile(CLI_DIR / "chain.zkey", release / "prover_key.zkey")
    shutil.copyfile(CLI_DIR / "chain_vk.json", release / "verification_key.json")
    (release / "circuit_config.yaml").write_text("max_lengths: {}\nhas_input_skip_aud_checks: true\n")
    names = ("prover_key.zkey", "verification_key.json", "circuit_config.yaml")
    feed = [{"tag_name": "chip-smoke", "created_at": "2026-01-01T00:00:00Z",
             "assets": [{"name": n, "browser_download_url": (release / n).as_uri(), "url": (release / n).as_uri()}
                        for n in names]}]
    pins = {n: hashlib.sha256((release / n).read_bytes()).hexdigest() for n in names}
    bad_root = CEREMONY_DIR / "store_pinned_wrong"
    try:
        download_ceremony("chip-smoke", root=str(bad_root), releases=Releases(feed=feed),
                          checksums=pins | {"prover_key.zkey": "0" * 64})
        raise Failed("download_ceremony installed a release under a wrong pin")
    except ValueError as e:
        log(f"ceremony: a wrong pin -> {type(e).__name__}: {str(e)[:60]}...; installed: {bad_root.exists()}")
    check(not bad_root.exists(), "a wrong pin left a setup store behind")
    t0 = time.perf_counter()
    setup = download_ceremony("chip-smoke", root=str(CEREMONY_DIR / "store_a"), releases=Releases(feed=feed),
                              checksums=pins)
    same = [filecmp.cmp(release / n, Path(setup) / n.replace(".yaml", ".yml"), shallow=False) for n in names]
    log(f"ceremony: download_ceremony {time.perf_counter() - t0:.1f} s -> {setup}; assets byte-equal {same}")
    check(all(same), "the installed ceremony differs from the release's assets")

    remote = (CEREMONY_DIR / "remote").as_uri()
    out = run_tool(["keyless_zk_tpu_torch.tooling.setup_tool", "cache-push", setup, "--remote", remote],
                   "ceremony: setup_tool cache-push")
    check(out.returncode == 0, f"cache-push failed: {out.stderr[-2000:]}")
    key, root_b = os.path.basename(setup), str(CEREMONY_DIR / "store_b")
    out = run_tool(["keyless_zk_tpu_torch.tooling.setup_tool", "cache-pull", key, "--remote", remote, "--root",
                    root_b, "--slot", "default"], "ceremony: setup_tool cache-pull")
    check(out.returncode == 0, f"cache-pull failed: {out.stderr[-2000:]}")
    pulled = out.stdout.strip()
    same = sorted(os.listdir(pulled)) == sorted(os.listdir(setup)) and all(
        filecmp.cmp(Path(setup) / n, Path(pulled) / n, shallow=False) for n in os.listdir(setup))
    log(f"ceremony: pulled {pulled}: every file byte-equal to the pushed setup's: {same}")
    check(same, "the pulled setup differs from the pushed one")
    out = run_tool(["keyless_zk_tpu_torch.tooling.setup_tool", "cache-pull", "zkey-0000000000000000", "--remote",
                    remote, "--root", root_b], "ceremony: setup_tool cache-pull of a missing key")
    check(out.returncode == 1, "cache-pull of a missing key did not exit 1")
    out = run_tool(["keyless_zk_tpu_torch.groth16.cli", "prove", "--zkey", f"{pulled}/prover_key.zkey", "--wtns",
                    str(CLI_DIR / "chain.wtns"), "--vk", f"{pulled}/verification_key.json", "--device", str(dev)],
                   "ceremony: cli prove on the pulled setup")
    check(out.returncode == 0 and "verified: true" in out.stderr,
          f"the pulled setup's proof failed: {out.stderr[-2000:]}")
    shutil.rmtree(CEREMONY_DIR)


def circom_checks(dev, counts: dict) -> None:
    """The circom route at full width, then the ceremony tools."""
    t0 = time.perf_counter()
    circom_route(dev, counts)
    t1 = time.perf_counter()
    ceremony_checks(dev)
    log(f"circom_checks: {time.perf_counter() - t0:.1f} s (the circom route {t1 - t0:.1f} s, the ceremony tools "
        f"{time.perf_counter() - t1:.1f} s)")


# ---- the keyless path ------------------------------------------------------------

KEYLESS_WIRES, KEYLESS_CONSTRAINTS = 1_377_553, 1_406_751  # tests/test_full_scale_circuit.py


def msm_against_double_and_add(prover, w) -> None:
    """Each of the proof's five MSMs (the merged witness scalars, and the
    h scalars of the last proof) against a double-and-add over K3's
    complete mixed add, which takes P == Q: equal as affine points."""
    from keyless_zk_tpu_torch.curves.jacobian import G1_CURVE, G2_CURVE
    from keyless_zk_tpu_torch.groth16.prover import _SPARSE_C
    from keyless_zk_tpu_torch.ops.msm import _msm_small, msm

    tables = {
        "a": (prover.points_a, prover._merge_a, G1_CURVE, w),
        "b1": (prover.points_b1, prover._merge_b1, G1_CURVE, w),
        "b2": (prover.points_b2, prover._merge_b2, G2_CURVE, w),
        "c": (prover.points_c, prover._merge_c, G1_CURVE, w),
        "h": (prover.points_h, prover._merge_h, G1_CURVE, prover.last_h[0]),
    }
    for name, (points, merge, curve, scalars) in tables.items():
        sc = prover._merge_scalars(scalars, merge)
        kw = {"c": _SPARSE_C} if name != "h" else {}  # the prover's windows
        t0 = time.perf_counter()
        got = curve.decode_jacobian(msm(*points, sc, curve=curve, **kw))
        t1 = time.perf_counter()
        want = curve.decode_jacobian(_msm_small(*points, sc, curve=curve))
        t2 = time.perf_counter()
        equal = got == want
        log(f"keyless path: msm_{name} ({sc.shape[0]} rows) == K3 double-and-add: {equal} "
            f"(msm {t1 - t0:.2f} s, double-and-add {t2 - t1:.2f} s)")
        check(equal, f"keyless msm_{name} differs from the double-and-add over the complete mixed add")


SETUP_ROOT = Path(__file__).resolve().parent / "build" / "chip_smoke" / "setups"
SETUP_FILES = ("main.r1cs", "prover_key.zkey", "verification_key.json", "circuit_config.yml", ".complete")


@contextlib.contextmanager
def timed_calls(module, names, seconds: dict, keep: dict | None = None):
    """Wrap module.<name> for each name: its seconds go into `seconds`, and
    with `keep` its result into keep[name]."""
    saved = {name: getattr(module, name) for name in names}

    def wrap(name, real):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
            if keep is not None:
                keep[name] = out
            return out
        return call

    try:
        for name, real in saved.items():
            setattr(module, name, wrap(name, real))
        yield
    finally:
        for name, real in saved.items():
            setattr(module, name, real)


def key_differences(a, b) -> list:
    """The fields where two proving keys differ: tables array by array,
    vk points point by point."""
    import dataclasses

    import numpy as np

    diff = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name.startswith("points_"):
            same = all(np.array_equal(getattr(x, part), getattr(y, part)) for part in ("x", "y", "inf"))
        elif isinstance(x, np.ndarray):
            same = np.array_equal(x, y)
        else:
            same = x == y
        if not same:
            diff.append(f.name)
    return diff


def keyless_procure(dev, setup_counts: dict, records: dict):
    """The real keyless circuit, then `setup_tool.procure` into a cold store
    under build/: the circuit's R1CS, the setup on the card, and its files.
    Returns (cs, setup directory, the setup's SetupResult)."""
    import torch

    from keyless_zk_tpu_torch.circuits.keyless_circuit import KeylessConfig, build_keyless_circuit
    from keyless_zk_tpu_torch.ops import _build, cuda_curve
    from keyless_zk_tpu_torch.tooling import setup_tool

    cfg = KeylessConfig()
    t0 = time.perf_counter()
    cs = build_keyless_circuit(cfg)
    log(f"keyless path: circuit built in {time.perf_counter() - t0:.1f} s ({cs.n_wires} wires, "
        f"{len(cs.constraints)} constraints, {len(cs.ops)} witness ops)")
    check((cs.n_wires, len(cs.constraints)) == (KEYLESS_WIRES, KEYLESS_CONSTRAINTS),
          "the keyless circuit's wire or constraint count changed")

    shutil.rmtree(SETUP_ROOT, ignore_errors=True)
    calls: dict = {}
    seen: dict = {}
    seconds: dict = {}
    kept: dict = {}
    _build.reset_launch_counts()
    with capture_calls(cuda_curve, ("curve_dbl", "curve_madd"), calls, at=100, seen=seen), \
            timed_calls(setup_tool, ("r1cs_from_cs", "save_r1cs", "groth16_setup", "save_zkey"), seconds, kept):
        t0 = time.perf_counter()
        setup_dir = setup_tool.procure(cfg, root=str(SETUP_ROOT), cs=cs, device=dev)
        torch.cuda.synchronize()
    procure_s = time.perf_counter() - t0
    setup_counts.update(_build.launch_counts())
    res, r1cs = kept["groth16_setup"], kept.pop("r1cs_from_cs")
    log(f"keyless path: r1cs_from_cs {seconds['r1cs_from_cs']:.1f} s (nonzero terms A {sum(map(len, r1cs.A))}, "
        f"B {sum(map(len, r1cs.B))}, C {sum(map(len, r1cs.C))})")
    del r1cs
    sizes = {name: Path(setup_dir, name).stat().st_size for name in SETUP_FILES}
    log(f"keyless path: procure {procure_s:.1f} s -> {setup_dir}: save_r1cs {seconds['save_r1cs']:.1f} s, "
        f"groth16_setup {seconds['groth16_setup']:.1f} s (host {res.seconds['host']:.1f} s, device ladders "
        f"{res.seconds['device']:.1f} s), save_zkey {seconds['save_zkey']:.1f} s; domain {res.pk.domain_size}, "
        f"{res.pk.n_coefs} coefficients; file bytes {json.dumps(sizes)}")
    check(Path(setup_dir).parent == SETUP_ROOT and (SETUP_ROOT / "default").resolve() == Path(setup_dir).resolve(),
          "procure did not install the setup as the store's default")
    log(f"launch counts (keyless setup): {json.dumps(setup_counts)}")
    for name, _, _, path in KERNELS:
        if path == "setup":
            check(setup_counts.get(name, 0) > 0, f"kernel {name} was not launched by the keyless setup")
    k3_ladder_checks(calls, seen, records, res.seconds["device"])
    del calls
    torch.cuda.empty_cache()
    return cs, setup_dir, res


def keyless_witness(cs, setup_dir: str):
    """The compiled witness engine of the circuit, saved beside the zkey as
    the service's cold start does, and the test JWT's witness checked
    against every constraint. Returns (the JWT's compute_witness keyword
    arguments, its wires, its public-inputs hash)."""
    from keyless_zk_tpu_torch.circuits.keyless_circuit import KeylessConfig, to_circuit_config, witness_kwargs
    from keyless_zk_tpu_torch.circuits.witness_engine import CompiledWitnessProgram
    from keyless_zk_tpu_torch.input_processing.input_signals import derive_circuit_input_signals
    from keyless_zk_tpu_torch.input_processing.testjwt import make_test_jwt

    t0 = time.perf_counter()
    tj = make_test_jwt(seed=2026)
    t1 = time.perf_counter()
    signals, public_hash = derive_circuit_input_signals(to_circuit_config(KeylessConfig()), tj.vi)
    kw = witness_kwargs(signals)
    t2 = time.perf_counter()
    prog = CompiledWitnessProgram(cs)
    t3 = time.perf_counter()
    prog.save(str(Path(setup_dir, "witness_program.npz")))
    t4 = time.perf_counter()
    wires = prog.compute_witness(**kw)
    t5 = time.perf_counter()
    bad = prog.check_witness(wires)
    t6 = time.perf_counter()
    nonzero = float((wires != 0).any(axis=1).mean())
    bits = float(((wires[:, 1:] == 0).all(axis=1) & (wires[:, 0] <= 1)).mean())
    log(f"keyless path: test JWT {t1 - t0:.2f} s, input signals {t2 - t1:.2f} s; witness engine: compile "
        f"{t3 - t2:.1f} s, save {t4 - t3:.1f} s ({Path(setup_dir, 'witness_program.npz').stat().st_size} bytes), "
        f"compute_witness {t5 - t4:.2f} s, check_witness {t6 - t5:.1f} s -> "
        f"{'satisfied' if bad is None else f'constraint {bad} violated'}; nonzero {100 * nonzero:.1f}%, "
        f"bit-valued {100 * bits:.1f}% of {wires.shape[0]} wires")
    check(bad is None, f"the keyless witness violates constraint {bad}")
    check(prog.witness_ints(wires[1:2])[0] == public_hash,
          "the keyless witness's public wire is not the public-inputs hash")
    return kw, wires, public_hash


def start_service(dev, setup_pk):
    """A ProverServiceState warm-started from the store: the saved witness
    program, the zkey (checked equal to the setup's key before the prover
    is built), the prover; the native pairing."""
    from keyless_zk_tpu_torch.circuits.keyless_circuit import KeylessConfig, to_circuit_config
    from keyless_zk_tpu_torch.service import prover_state
    from keyless_zk_tpu_torch.service.config import ProverServiceConfig
    from keyless_zk_tpu_torch.service.jwk import JwkCache
    from keyless_zk_tpu_torch.service.training_wheels import TrainingWheelsKeyPair

    cfg = KeylessConfig()
    config = ProverServiceConfig(resources_dir=str(SETUP_ROOT), port=0, metrics_port=0, require_native_pairing=True)
    state = prover_state.ProverServiceState(
        config=config,
        circuit_config=to_circuit_config(cfg),
        keyless_config=cfg,
        tw_keypair=TrainingWheelsKeyPair.from_sk_hex(hashlib.sha256(b"chip_smoke training wheels").hexdigest()),
        jwk_cache=JwkCache(),
        device=dev,
    )
    real_load = prover_state.load_zkey

    def load_and_compare(path):
        pk = real_load(path)
        diff = key_differences(pk, setup_pk)
        log(f"service start: the loaded zkey equals the setup's key: {not diff}"
            + (f" (differs in {diff})" if diff else ""))
        check(not diff, f"the zkey loaded from the store differs from the setup's key in {diff}")
        return pk

    prover_state.load_zkey = load_and_compare
    try:
        t0 = time.perf_counter()
        state.init_prover_from_native_setup(persist=True)
        cold_s = time.perf_counter() - t0
    finally:
        prover_state.load_zkey = real_load
    steps = {k: (round(v, 2) if isinstance(v, float) else v) for k, v in state.startup_s.items()}
    log(f"service start: init_prover_from_native_setup(persist=True) {cold_s:.1f} s, steps (s) {json.dumps(steps)}, "
        f"pairing backend {state.pairing_backend}, NTT plan {type(state.prover.plan).__name__}")
    check(state.startup_s.get("warm") is True, "the service's start did not take the warm branch")
    check(state.pairing_backend == "native", f"the service verifies with the {state.pairing_backend} pairing")
    check(state.healthy() == (True, "ok"), "the service reports itself unhealthy")

    rows = {name: (getattr(setup_pk, "points_" + name).inf.shape[0], getattr(state.prover, "points_" + name)[0].shape[0])
            for name in ("a", "b1", "b2", "c", "h")}
    log(f"service start: point table rows -> distinct rows after the dedup: {json.dumps(rows)}")
    return state


def blind_against_plain(pk, points, proof) -> None:
    """The native blinding, built on this host (-march=native), against
    `blind_plain` on the keyless warm-up proof's decoded points (A, B1, B2,
    C, H) at R_FIXED, S_FIXED, and both against the warm-up proof."""
    from keyless_zk_tpu_torch.groth16 import prover as prover_mod

    t0 = time.perf_counter()
    native = prover_mod.blind(pk, *points, R_FIXED, S_FIXED)
    t1 = time.perf_counter()
    plain = prover_mod.blind_plain(pk, *points, R_FIXED, S_FIXED)
    t2 = time.perf_counter()
    log(f"keyless blind: native {(t1 - t0) * 1e3:.3f} ms, blind_plain {(t2 - t1) * 1e3:.1f} ms, "
        f"equal {native == plain}, equal to the warm-up proof {native == proof}")
    check(native == plain == proof, "the native blinding differs from blind_plain on the keyless proof's points")


def keyless_proofs(dev, state, kw, wires_ref, public_hash, records: dict, counts: dict) -> None:
    """The proofs of the test JWT through the service's witness program and
    prover: a warm-up (tampered copy refused; its blinding against
    `blind_plain`), its five MSMs against K3's double-and-add, the complete
    MSM on the key's raw tables with the warm-up witness, three timed
    proofs, their launch counts."""
    import numpy as np
    import torch

    from keyless_zk_tpu_torch.groth16 import prover as prover_mod
    from keyless_zk_tpu_torch.ops import _build, cuda_ntt

    prover, prog = state.prover, state.witness_prog
    t0 = time.perf_counter()
    wires = prog.compute_witness(**kw)
    log(f"keyless path: the service's witness program (reloaded): compute_witness {time.perf_counter() - t0:.2f} s, "
        f"equal to the compiled program's: {np.array_equal(wires, wires_ref)}")
    check(np.array_equal(wires, wires_ref), "the reloaded witness program computes another witness")
    witness = prog.witness_limbs(wires)

    real_blind, points = prover_mod.blind, []
    prover_mod.blind = lambda pk, *args: points.append(args[:5]) or real_blind(pk, *args)
    ntt_calls: dict = {}
    try:
        with capture_calls(cuda_ntt, ("ntt_pass",), ntt_calls):
            proof, wall = timed_proof(prover, witness, R_FIXED, S_FIXED)
    finally:
        prover_mod.blind = real_blind
    log(f"keyless proof warm-up: wall {wall:.1f} ms")
    log("  phases (ms): " + json.dumps({k: round(v, 3) for k, v in prover.phase_ms.items()}))
    verify_checked(state.vk, [public_hash], proof, "keyless proof warm-up", tamper=True)
    blind_against_plain(prover.pk, points[0], proof)
    ntt_pass_checks(ntt_calls, records)
    del ntt_calls
    w = torch.from_numpy(witness.astype(np.int32)).to(dev)
    msm_against_double_and_add(prover, w)
    raw_table_msms(prover, w, dev, records, counts["complete"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    walls = []
    prove_counts: dict = {}
    for i in range(3):
        if i == 0:
            _build.reset_launch_counts()
        proof, wall = timed_proof(prover, witness, R_FIXED + i, S_FIXED + i)
        if i == 0:
            prove_counts = _build.launch_counts()
        walls.append(wall)
        log(f"keyless proof {i + 1}: wall {wall:.1f} ms")
        log("  phases (ms): " + json.dumps({k: round(v, 3) for k, v in prover.phase_ms.items()}))
        verify_checked(state.vk, [public_hash], proof, f"keyless proof {i + 1}")
    log(f"keyless path: proof wall ms {[round(ms, 1) for ms in walls]}, median {sorted(walls)[1]:.1f}, "
        f"peak device memory over the timed proofs {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"launch counts (keyless prove path, one proof): {json.dumps(prove_counts)}")
    for name, _, _, path in KERNELS:
        if path == "prove":
            check(prove_counts.get(name, 0) > 0, f"kernel {name} was not launched by the keyless proof")
    check_k1_launches(prove_counts, "the keyless proof")
    check(prove_counts.get("window_scan_complete", 0) == 0, "the keyless proof launched the complete scan")
    check(prove_counts.get("eval_ab", 0) == 1, "the keyless proof did not launch eval_ab once")
    check_ntt_launches(prove_counts, "the keyless proof")
    eval_ab_checks("keyless path", prover, w, records)


# ---- batched proving ---------------------------------------------------------------

BATCH_SEEDS = (21, 22, 23, 24, 25, 26, 27, 28)
WARM_BATCH = 4  # the warm-up batch: BATCH_SEEDS[:4]


def batch_witnesses(state) -> tuple[list, list]:
    """The witness limbs and public-inputs hashes of test JWTs of
    BATCH_SEEDS, through the service's witness program."""
    from keyless_zk_tpu_torch.circuits.keyless_circuit import witness_kwargs
    from keyless_zk_tpu_torch.input_processing.input_signals import derive_circuit_input_signals
    from keyless_zk_tpu_torch.input_processing.testjwt import make_test_jwt

    t0 = time.perf_counter()
    wits, hashes = [], []
    for seed in BATCH_SEEDS:
        signals, public_hash = derive_circuit_input_signals(state.circuit_config, make_test_jwt(seed=seed).vi)
        wires = state.witness_prog.compute_witness(**witness_kwargs(signals))
        wits.append(state.witness_prog.witness_limbs(wires))
        hashes.append(public_hash)
    log(f"batch: {len(wits)} witnesses of JWT seeds {list(BATCH_SEEDS)} in {time.perf_counter() - t0:.1f} s")
    check(len(set(hashes)) == len(hashes), "the batch's JWTs give equal public-inputs hashes")
    return wits, hashes


def batched_msms_equal(prover, bp, wits, dev) -> None:
    """The batch's msm_b2 and msm_h (the batched MSM over the batch's merged
    witnesses and its h scalars) against the single prover's MSM of each
    element: equal as affine points."""
    import numpy as np
    import torch

    from keyless_zk_tpu_torch.curves.jacobian import G1_CURVE, G2_CURVE
    from keyless_zk_tpu_torch.groth16.prover import _SPARSE_C
    from keyless_zk_tpu_torch.ops.msm import msm_batch

    w = torch.from_numpy(np.stack(wits).astype(np.int32)).to(dev)
    for name, table, merge, curve, scalars, kw in (
        ("msm_b2", prover.points_b2, prover._merge_b2, G2_CURVE, w, {"c": _SPARSE_C}),
        ("msm_h", prover.points_h, prover._merge_h, G1_CURVE, bp.last_h, {}),
    ):
        got = curve.decode_jacobian(msm_batch(*table, prover._merge_scalars(scalars, merge), curve=curve, **kw))
        want = [curve.decode_jacobian(prover._msm(table, prover._merge_scalars(scalars[i : i + 1], merge), curve,
                                                  **kw))[0] for i in range(len(wits))]
        log(f"batch: {name} of B = {len(wits)} == the single prover's {name} per element: {got == want}")
        check(got == want, f"the batched {name} differs from the single prover's")


def _as_batch(p):
    """A Jacobian point as a batch of one."""
    from keyless_zk_tpu_torch.curves.jacobian import JacPoint

    return JacPoint(*(co[None] for co in p))


def batch_proofs(dev, state, records: dict, counts: dict) -> None:
    """Batched proving on the service's prover (no second prover): a warm-up
    batch of four (its K7 inputs kept, every proof verifying, a tampered one
    not, its msm_b2 and msm_h against the single prover), the batched K7
    against its plain version, then three timed batches at B = 1, 2, 4 and
    8: ms per batch, proofs_per_sec, phases, launches per batch (K9 once
    per element), peak GiB; the batch of four's launches are the record's."""
    import torch

    from keyless_zk_tpu_torch.ops import _build, cuda_msm
    from keyless_zk_tpu_torch.parallel.batch_prover import BatchProver

    wits, hashes = batch_witnesses(state)
    bp = BatchProver(state.prover, max_batch=len(wits))
    try:
        calls: dict = {}
        with capture_calls(cuda_msm, ("horner_total",), calls):
            t0 = time.perf_counter()
            proofs = bp.prove_batch(wits[:WARM_BATCH])
            wall = (time.perf_counter() - t0) * 1e3
        log(f"batch warm-up B = {WARM_BATCH}: wall {wall:.1f} ms; phases (ms) "
            + json.dumps({k: round(v, 3) for k, v in bp.phase_ms.items()}))
        for i, (proof, h) in enumerate(zip(proofs, hashes)):
            verify_checked(state.vk, [h], proof, f"batch warm-up element {i}", tamper=i == 0)
        check(not verifies(state.vk, [hashes[1]], proofs[0]),
              "a batch proof verifies against another element's public input")
        batched_msms_equal(state.prover, bp, wits[:WARM_BATCH], dev)
        k7_batched_checks(calls, records)
        del calls
        k7_planted_batched(dev, records)
        torch.cuda.empty_cache()

        for B in (1, 2, 4, 8):
            torch.cuda.reset_peak_memory_stats()
            walls = []
            for i in range(3):
                if i == 0:
                    _build.reset_launch_counts()
                t0 = time.perf_counter()
                proofs = bp.prove_batch(wits[:B])
                walls.append((time.perf_counter() - t0) * 1e3)
                if i == 0:
                    per_batch = _build.launch_counts()
                for j, proof in enumerate(proofs):
                    check(verifies(state.vk, [hashes[j]], proof), f"batch B={B} element {j} does not verify")
            med = sorted(walls)[1]
            log(f"batch B = {B}: ms per batch {[round(w, 1) for w in walls]}, median {med:.1f}, proofs_per_sec "
                f"{1e3 * B / med:.3f}, every proof verifies; peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phases (ms) of the last "
                + json.dumps({k: round(v, 3) for k, v in bp.phase_ms.items()}))
            log(f"  launch counts (one batch of {B}): {json.dumps(per_batch)}")
            for name, _, _, path in KERNELS:
                if path == "prove":
                    check(per_batch.get(name, 0) > 0, f"kernel {name} was not launched by a batch of {B}")
            check(per_batch["eval_ab"] == B, f"{per_batch['eval_ab']} eval_ab launches in a batch of {B}, not {B}")
            check_ntt_launches(per_batch, f"a batch of {B}", proofs=B)
            if B == 4:
                counts.update(per_batch)
        counts["horner_total_batched"] = counts["horner_total"]
    finally:
        bp.shutdown()


def verifies(vk, public: list, proof) -> bool:
    from keyless_zk_tpu_torch.groth16 import verify_groth16

    return verify_groth16(vk, public, proof.to_json_dict())


# ---- the service path ------------------------------------------------------------

SERVICE_SEEDS = (11, 12, 13, 14, 15)  # three sequential requests, then two at once
BATCH_SERVICE_SEEDS = (16, 17, 18, 19)  # four at once through a BatchProver


def http_call(port: int, method: str, path: str, body: bytes = b"") -> tuple:
    """(status, body bytes, wall ms) of one request to 127.0.0.1:port."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    try:
        conn.request(method, path, body=body or None, headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    return resp.status, data, (time.perf_counter() - t0) * 1e3


def check_prove_response(state, vk: dict, tj, status: int, data: bytes, label: str) -> None:
    """A 200 whose proof verifies under `vk` against the response's own
    public-inputs hash (equal to the one derived here from the JWT), and
    whose training-wheels signature verifies under the service's key over
    the BCS message rebuilt from the response alone."""
    from keyless_zk_tpu_torch.groth16 import verify_groth16
    from keyless_zk_tpu_torch.input_processing.public_inputs_hash import compute_public_inputs_hash
    from keyless_zk_tpu_torch.service.bcs import GROTH16_PROOF_AND_STATEMENT_SEED, ephemeral_signature_from_bcs
    from keyless_zk_tpu_torch.tools.full_prove import response_proof_json
    from keyless_zk_tpu_torch.utils import ed25519

    check(status == 200, f"{label}: POST /v0/prove answered {status}: {data[:300]!r}")
    payload = json.loads(data)
    pih_bytes = bytes.fromhex(payload["public_inputs_hash"])
    pih = int.from_bytes(pih_bytes, "little")
    check(pih == compute_public_inputs_hash(state.circuit_config, tj.vi, state.config.max_committed_epk_bytes),
          f"{label}: the response's public-inputs hash is not the JWT's")
    proof_ok = verify_groth16(vk, [pih], response_proof_json(payload))
    msg = (GROTH16_PROOF_AND_STATEMENT_SEED + bytes(payload["proof"]["a"]) + bytes(payload["proof"]["b"])
           + bytes(payload["proof"]["c"]) + pih_bytes)
    sig = ephemeral_signature_from_bcs(bytes.fromhex(payload["training_wheels_signature"]))
    sig_ok = ed25519.verify(state.tw_keypair.pk, msg, sig)
    log(f"  {label}: proof verifies {proof_ok}, training-wheels signature verifies {sig_ok}")
    check(proof_ok, f"{label}: the response's proof does not verify")
    check(sig_ok, f"{label}: the response's training-wheels signature does not verify")


def serve_checks(state, setup_dir: str, prove_kernels: bool = True) -> None:
    """The prover service over HTTP on 127.0.0.1 (ephemeral ports, server
    threads): three POST /v0/prove one after another and two at once, each
    200 with a proof and a training-wheels signature that verify; a
    tampered JWT 400; /healthcheck 200; the metrics text with the nine
    phases. Launch counts of one request (every prove-path kernel > 0 with
    `prove_kernels`)."""
    import threading

    from keyless_zk_tpu_torch.input_processing.testjwt import make_test_jwt, prove_request
    from keyless_zk_tpu_torch.ops import _build
    from keyless_zk_tpu_torch.service.jwk import RsaJwk
    from keyless_zk_tpu_torch.service.metrics import PROVE_PHASES
    from keyless_zk_tpu_torch.service.server import start_metrics_server, start_prover_service

    with open(Path(setup_dir, "verification_key.json")) as f:
        vk = json.load(f)
    t0 = time.perf_counter()
    jwts = [make_test_jwt(seed=s, kid=f"test-kid-{s}") for s in SERVICE_SEEDS + BATCH_SERVICE_SEEDS]
    for tj in jwts:
        state.jwk_cache.insert(tj.vi.jwt.payload.iss, RsaJwk(kid=tj.vi.jwt.header.kid, n=tj.rsa_key.n))
    log(f"service: {len(jwts)} test JWTs and their keys in the JWK cache in {time.perf_counter() - t0:.1f} s")

    srv = start_prover_service(state, 0, host="127.0.0.1")
    metrics = start_metrics_server(0, host="127.0.0.1")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    port, metrics_port = srv.server_address[1], metrics.server_address[1]
    try:
        status, data, _ = http_call(port, "GET", "/healthcheck")
        log(f"service: listening on 127.0.0.1:{port} (metrics {metrics_port}); /healthcheck {status} {data.decode()}")
        check(status == 200, "/healthcheck does not answer 200")

        def logged(i, tj, status, data, wall, counts=None):
            b = state.breakdowns[-1] if status == 200 else {}
            log(f"service request {i} (seed {SERVICE_SEEDS[i]}): {status}, wall {wall:.1f} ms; phases (ms) "
                + json.dumps({k: round(v, 3) for k, v in b.get("phases_ms", {}).items()}))
            log("  prover phases (ms): " + json.dumps({k: round(v, 3) for k, v in b.get("prover_phase_ms", {}).items()}))
            if counts is not None:
                log(f"  launch counts (one POST /v0/prove): {json.dumps(counts)}")
            check_prove_response(state, vk, tj, status, data, f"request {i}")

        for i, tj in enumerate(jwts[:3]):
            if i == 0:
                _build.reset_launch_counts()
            status, data, wall = http_call(port, "POST", "/v0/prove", json.dumps(prove_request(tj)).encode())
            counts = _build.launch_counts() if i == 0 else None
            logged(i, tj, status, data, wall, counts)
            if counts is not None and prove_kernels:
                for name, _, _, path in KERNELS:
                    if path == "prove":
                        check(counts.get(name, 0) > 0, f"kernel {name} was not launched by a prove request")

        results: dict = {}

        def concurrent(i, tj):
            results[i] = http_call(port, "POST", "/v0/prove", json.dumps(prove_request(tj)).encode())

        t0 = time.perf_counter()
        threads = [threading.Thread(target=concurrent, args=(i, jwts[i])) for i in (3, 4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        log(f"service: two requests at once in {1e3 * (time.perf_counter() - t0):.1f} ms: walls "
            f"{[round(results[i][2], 1) for i in (3, 4)]} ms; phases (ms) of the two: "
            + json.dumps([{k: round(v, 1) for k, v in b["phases_ms"].items()} for b in list(state.breakdowns)[-2:]]))
        for i in (3, 4):
            check_prove_response(state, vk, jwts[i], results[i][0], results[i][1], f"concurrent request {i}")
        batched_requests(state, vk, port, jwts[len(SERVICE_SEEDS):])

        bad = prove_request(jwts[0])
        bad["jwt_b64"] = bad["jwt_b64"][:-8] + ("AAAAAAAA" if not bad["jwt_b64"].endswith("AAAAAAAA") else "BBBBBBBB")
        status, data, wall = http_call(port, "POST", "/v0/prove", json.dumps(bad).encode())
        log(f"service: tampered JWT signature -> {status} {data.decode()[:120]} ({wall:.1f} ms)")
        check(status == 400, f"a tampered JWT answered {status}, not 400")

        status, data, _ = http_call(metrics_port, "GET", "/")
        text = data.decode()
        missing = [p for p in PROVE_PHASES if f'phase="{p}"' not in text]
        log(f"service: metrics {status}, {len(text)} bytes, prove_breakdown phases missing: {missing}")
        check(status == 200 and not missing, f"the metrics text lacks the prove_breakdown phases {missing}")
    finally:
        srv.shutdown()
        srv.server_close()
        metrics.shutdown()
        metrics.server_close()
        thread.join(timeout=10)


def batched_requests(state, vk: dict, port: int, jwts: list) -> None:
    """`batch_proving` on the running service: a BatchProver (max_batch 4)
    around its prover, four POST /v0/prove at once, each 200 and verifying;
    the walls and the batch sizes the worker drained."""
    import threading

    from keyless_zk_tpu_torch.input_processing.testjwt import prove_request
    from keyless_zk_tpu_torch.parallel.batch_prover import BatchProver

    state.config.batch_proving, state.config.max_batch = True, 4
    state.batch_prover = BatchProver(state.prover, max_batch=4)
    results: dict = {}

    def post(i, tj):
        results[i] = http_call(port, "POST", "/v0/prove", json.dumps(prove_request(tj)).encode())

    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(i, tj)) for i, tj in enumerate(jwts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        log(f"service, batch_proving: {len(jwts)} requests at once in {1e3 * (time.perf_counter() - t0):.1f} ms: "
            f"walls {[round(results[i][2], 1) for i in range(len(jwts))]} ms, batches drained "
            f"{list(state.batch_prover.batch_sizes)}; per request (batch size, generate_proof ms): "
            + json.dumps([(b["batch_size"], round(b["phases_ms"]["generate_proof"], 1))
                          for b in list(state.breakdowns)[-len(jwts):]]))
        for i, tj in enumerate(jwts):
            check_prove_response(state, vk, tj, results[i][0], results[i][1], f"batched request {i}")
    finally:
        state.batch_prover.shutdown()
        state.batch_prover = None
        state.config.batch_proving = False


def keyless_path(dev, records: dict, counts: dict) -> None:
    """The service's path: procure the setup on disk, start the service
    warm from it, prove through it, prove batches with its prover, then
    serve over HTTP."""
    import torch

    cs, setup_dir, res = keyless_procure(dev, counts["setup"], records)
    kw, wires, public_hash = keyless_witness(cs, setup_dir)
    del cs
    state = start_service(dev, res.pk)
    del res
    torch.cuda.empty_cache()
    keyless_proofs(dev, state, kw, wires, public_hash, records, counts)
    del wires
    torch.cuda.empty_cache()
    batch_proofs(dev, state, records, counts["batch"])
    torch.cuda.empty_cache()
    serve_checks(state, setup_dir)
    shutil.rmtree(SETUP_ROOT)  # ~10 GB of setup files; a failed run keeps them


def bench_quick() -> None:
    """The port's bench with BENCH_QUICK=1 in a subprocess: the devices
    child and the headline msm_g1_2^16, whose record must carry a value and
    "correct": true; that record printed on its own line. BENCH_BUDGET_S
    bounds the bench's own children, which run in their own sessions."""
    import os

    env = dict(os.environ, BENCH_QUICK="1", BENCH_BUDGET_S="240")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "keyless_zk_tpu_torch.bench"], cwd=Path(__file__).resolve().parent,
                         env=env, capture_output=True, text=True, timeout=300)
    records = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    log(f"bench (BENCH_QUICK=1): exit {out.returncode} in {time.perf_counter() - t0:.1f} s; "
        f"devices {json.dumps(records[0]) if records else None}")
    check(out.returncode == 0 and records, f"the bench failed: {out.stderr[-2000:]}")
    head = records[-1]
    print(json.dumps(head), flush=True)
    check(head.get("metric") == "msm_g1_2^16" and head.get("value") is not None and head.get("correct") is True,
          f"the bench's headline record has no checked value: {head}")


def timed_proof(prover, witness, r, s):
    """One proof and its host wall ms (it ends in the decode's readbacks)."""
    t0 = time.perf_counter()
    proof = prover.prove(witness, r=r, s=s)
    return proof, (time.perf_counter() - t0) * 1e3


PTXAS_KERNELS = ("mont_pow_kernel", "madd_kernel", "dbl_kernel", "add_kernel", "window_scan_kernel",
                 "window_scan_complete_kernel",
                 "merge_tile_kernel", "bucket_walk_kernel", "point_sum_kernel", "horner_kernel", "eval_ab_kernel",
                 "ntt_pass_kernel")


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
    counts: dict = {"prove": {}, "setup": {}, "batch": {}, "sharded": {}, "circom": {}, "complete": {}, "mxu": {}}
    try:
        log(f"card: {card}")
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
        lib, secs = _build.build()
        _build.library()
        log(f"build: {secs:.1f} s -> {lib}")
        report = _build.ptxas_report((lib.parent / "build.log").read_text(), PTXAS_KERNELS)
        log("ptxas (K1 mont_pow, K3-K7, K9, K10): " + json.dumps(report))
        check(all(any(k.startswith(name + " ") for k in report) for name in PTXAS_KERNELS),
              "build.log lacks the ptxas report of a K1 mont_pow, K3-K7, K9 or K10 kernel")
        bench_quick()
        mont_mul_checks(dev, records)
        mont_pow_checks(dev, records)
        k3_checks(dev, records)
        complete_planted(dev, records)
        small_proof(dev)
        full_width(dev, counts["prove"], records, counts["mxu"])
        torch.cuda.empty_cache()
        setup_path(dev, records, counts)
        torch.cuda.empty_cache()
        keyless_path(dev, records, counts)
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"total {time.perf_counter() - t_start:.1f} s")
    kernels = []
    for name, src, rep, path in KERNELS:
        rec = records[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": rep,
            "launches": counts[path][name],
            "max_abs_err": rec["max_abs_err"],
            "ms": round(rec["ms"], 4),
            "plain_ms": round(rec["plain_ms"], 4),
            "bound_ms": round(rec["bound_ms"], 4),
            "bound_by": "bytes" if rec["bytes_ms"] >= rec["ops_ms"] else "operations",
            "library_ms": None,  # no PyTorch call computes a BN254 field or group operation
        })
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
