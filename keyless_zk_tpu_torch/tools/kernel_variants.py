"""Time the port's kernels under variants of the shared device code, on one
NVIDIA GPU. Run from the repository root:

    python3 -m keyless_zk_tpu_torch.tools.kernel_variants [K1 K3 K4 K4c K5 K6 K7 K9]

Each variant is a textual edit of the sources, applied to a copy of csrc/
under build/ and built beside the shipped library:

- `shipped`: the sources as they are (the Montgomery product in carry
  chains; the group law's products behind a call, field.cuh `gmul`);
- `inline`: `gmul` inlined at every product of the group law;
- `wide`: the Montgomery product in 64-bit C arithmetic instead of carry
  chains (field.cuh `mul_wide`, the port's first product), its calls as
  shipped;
- `occupancy`: K4's kernel held to 128 registers (`__launch_bounds__(128,
  4)`: four blocks of 128 threads per SM where the shipped kernel fits two);
- `sliced`: K7's product steps run each Fq product on a group of 8 lanes,
  one 32-bit word each (the column sums, the Montgomery quotient and the
  carries passed by warp shuffles, the last carries and the conditional
  subtract by carry-lookahead over ballots), four products at a time,
  where the shipped kernel gives each product one lane;
- `k3_scalar`: K3 with each thread's rows read and written 4 bytes at a
  time (the access pattern of the port's first K3) instead of as 16-byte
  vectors;
- `k3_calls`: K3's G2 group law through ec.cuh's calls, as K4-K7 take it,
  instead of inlined (`Fq2K3`);
- `k3_byref`: K3's Fq product (`k3_mul`) takes its operands by reference,
  as field.cuh's `gmul` does, instead of by value;
- `k3_inline`: K3's Fq product inlined at every product;
- `k3_first`: `k3_scalar`, `k3_calls` and `k3_byref` together, G1 on
  ec.cuh's own field type, no register budget: the port's first K3
  kernels;
- `k3_budget_low`, `k3_budget_high`: K3's register budgets (blocks of 128
  per SM that ptxas must fit) below and above the shipped ones;
- `k3_add_budget_2`, `k3_add_budget_4`: the full add's budget alone at
  two blocks (before) and four, G1 and G2;
- `k3_add_branch`: the full add as ec.cuh's `add_core` (the add in every
  lane, then a branch to `dbl_core` in the lanes where P == Q: the kernel
  before the doubling ran inside the add's products);
- `k3_add_any`: `add_core` with the doubling taken once per warp behind
  `__any_sync`, every lane of such a warp computing it;
- `pow_bits`: K1's `mont_pow` bit by bit (a squaring per bit and a
  product per set bit, the element and accumulator in registers) instead
  of by fixed 4-bit windows (a 16-entry table of x^k per thread in local
  memory, 14 products, then per window four squarings and one product);
- `ab_wide`: K9's coefficient evaluation (eval_ab.cu) with each row's
  exact unreduced sum of full 8 x 8-word products in 17 words, reduced
  once per row by 2^512 (`AccWide`), instead of a Montgomery product and
  a modular add per entry (`AccProduct`);
- `ab_no_prefetch`: K9 loading each entry's operands when it consumes the
  entry, instead of one entry ahead of the product;
- `ab_prefetch_past`: K9's loads one entry ahead bounded by the table's
  end instead of by the thread's share of the merge path;
- K4's complete body ("K4c"; msm_scan.cu `scan_law`), shipped as the
  branch-free projective law on G1 (ec.cuh `madd_proj`) and madd_complete
  on G2 over `Fq2S` (field.cuh `mul_wide`, operands by value), rows read
  where they are used: `ring`, each next row
  copied into a two-slot ring in shared memory with 16-byte `cp.async`
  while the current step adds; `ring_off`, the ring's copy waited for at
  once (no overlap); `ring_1`, a ring of one slot, row t + 1 copied into
  it once row t is read (half the shared memory); `carveout`, the ring
  with the least shared-memory carveout that holds two blocks' rings
  asked for; `g1_jac`, G1 by madd_complete; `g2_proj`, G2 by the
  projective law (its 3b' a full Fq2 product); `g2_mont`, G2's product in
  field.cuh's carry chains (`mul`) by value; `g2_byref`, G2's product
  (`mul_wide`) taking references; `g2_fq2`, G2 on field.cuh's Fq2 (`gmul`:
  carry chains, references);
- the complete body's pieces on the distinct body (findings only):
  `distinct_loop`, madd_core in `scan_law`'s loop (keys two steps
  ahead); `distinct_ring`, the same with the ring; `distinct_law`, the
  complete body's coordinates and laws.

Each variant's outputs must equal the shipped library's, bit for bit, on
the same inputs (chip_smoke.py holds the shipped kernels to their plain
versions), but for the variants that change a group law (`LAW_VARIANTS`):
their scan outputs are other coordinates of the same points, so their
bucket tables, heads and tails are compared with the shipped library's as
affine points (cross-multiplied by the other side's z, on the card), not
limb for limb, and their keys exactly. A variant is timed on the kernels
it concerns: the field variants on every kernel, the others on their own.
Arguments name the kernels to run (K1, K3, K4, K4c, K5-K7, K9; all by
default), and only the variants that concern them are built. The inputs
are random, at the shapes of the full-width proof's MSMs (ops/msm.py):
msm_h's 2^25-entry G1 stream over 16 x 32769 buckets, scanned by one wave
of lanes at two and at four blocks per SM, and a G2 witness MSM's
2^20-entry stream over 22 x 2049 buckets (no entry repeats the point
before it in its lane); K7 at the witness
MSMs' 22 windows of c = 12 and msm_h's 16 of c = 16. K4's complete body
runs on those random streams and on planted ones: the streams that
`msm(..., assume_distinct=False)` scans over a 2^16-row table whose points
each fill four consecutive rows with one shared nonzero lowest digit
(chip_smoke.py's planted tables), where every bucket run of window 0 adds
P + P. Times are
CUDA-event ms per call (K4's and K5's include resetting their bucket
table), the variants in order and then in reverse; with the shipped
library K6 is also timed at several lane counts per window, and K5 at tiles
of 128, 256 and 512 entries (G1) on boundary sequences of the main path's
lengths with one key over most of the sequence, as the keyless witness
gives. K3 runs at the 2^21 setup ladder's step shapes (the doubling, and
the mixed add of the broadcast generator: G1 2^21 points, G2 2,097,150),
its mixed add with n affine points (G1 2^20, G2 2^18), its full add on
G1 2^20 + 37 and G2 2^18 + 61 points with P == Q in one lane of 64 (as
chip_smoke.py plants it) and at n = 1 (the sharded MSM's combine); and ten steps
of the small-n MSM (a doubling and a mixed add, G2, n = 3, as the chain
key's B2 table gives `_msm_small`). K9 runs on a random table of the keyless key's shape (42.7M entries
over 2^22 rows, uniform rows) with a witness near r in a quarter of its
rows. K1's `mont_pow` runs the Fq inverse
(e = p - 2) at the decode's n = 4 and n = 1 and the setup's 2^21. Per variant the
script prints the build seconds, ptxas's registers and spills and the SASS
instruction count of each kernel.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..curves import ref_curve
from ..curves.jacobian import G1_CURVE, G2_CURVE, JacPoint
from ..fields.torch_field import FQ, FR
from ..ops import _build, cuda_curve, cuda_eval_ab, cuda_field, cuda_msm, msm, testgen

KERNELS = ("mont_mul_kernel", "mont_pow_kernel", "madd_kernel", "dbl_kernel", "add_kernel", "window_scan_kernel",
           "window_scan_complete_kernel", "merge_tile_kernel", "bucket_walk_kernel", "point_sum_kernel",
           "horner_kernel", "eval_ab_kernel")

_GMUL = "template <class M>\n__device__ __noinline__ Fp<M> gmul("
_MUL = "__device__ __forceinline__ Fp<M> mul(const Fp<M>& a, const Fp<M>& b) {\n"
_SCAN_BOUNDS = "__launch_bounds__(128)\nwindow_scan_kernel("
_RUN_STEPS = "__device__ __forceinline__ void run_steps("
_SLICED_RUN_STEPS = r"""// word j of a * b * 2^-256 mod q, for lane j of a group of 8 lanes that
// holds word j of a and b. Column sums stay 64-bit and redundant through
// the eight CIOS rounds; column 0's low word is exact, so each round's
// quotient is.
__device__ __forceinline__ uint32_t sliced_mul_word(uint32_t a, uint32_t b, int j) {
  constexpr unsigned kAll = 0xffffffffu;
  const uint32_t pj = FqMod::p(j);
  uint64_t acc = 0, acc8 = 0;  // column j; column 8 (lane 7)
  for (int i = 0; i < 8; i++) {
    const uint32_t bi = __shfl_sync(kAll, b, i, 8);
    uint64_t t = (uint64_t)a * bi;
    uint32_t hi_in = __shfl_up_sync(kAll, (uint32_t)(t >> 32), 1, 8);
    acc += (uint64_t)(uint32_t)t + (j ? hi_in : 0u);
    if (j == 7) acc8 += t >> 32;
    const uint32_t m = __shfl_sync(kAll, (uint32_t)acc * FqMod::n0, 0, 8);
    t = (uint64_t)m * pj;
    hi_in = __shfl_up_sync(kAll, (uint32_t)(t >> 32), 1, 8);
    acc += (uint64_t)(uint32_t)t + (j ? hi_in : 0u);
    if (j == 7) acc8 += t >> 32;
    // divide by 2^32: column 0's low word is zero now
    const uint64_t up = __shfl_down_sync(kAll, acc, 1, 8);
    const uint64_t carry0 = acc >> 32;
    acc = j == 7 ? acc8 : up;
    if (j == 0) acc += carry0;
    if (j == 7) acc8 = 0;
  }
  // one parallel carry step leaves carries of 0 or 1, then exact
  // carry-lookahead: carry into bit j of (G|P) + G
  const uint64_t c1 = __shfl_up_sync(kAll, acc >> 32, 1, 8);
  acc = (acc & 0xffffffffull) + (j ? c1 : 0ull);
  const uint32_t x = (uint32_t)acc;
  const uint32_t up_carry = __shfl_up_sync(kAll, (uint32_t)(acc >> 32), 1, 8);  // every lane shuffles
  const uint32_t cin = j ? up_carry : 0u;
  const int shift = threadIdx.x & 24;
  uint32_t gen = (__ballot_sync(kAll, x == 0xffffffffu && cin) >> shift) & 0xff;
  uint32_t prop = (__ballot_sync(kAll, x + cin == 0xffffffffu) >> shift) & 0xff;
  uint32_t carries = ((gen | prop) + gen) ^ (gen | prop) ^ gen;
  const uint32_t w = x + cin + ((carries >> j) & 1);
  // w >= q: subtract, the borrows by the same lookahead
  gen = (__ballot_sync(kAll, w < pj) >> shift) & 0xff;
  prop = (__ballot_sync(kAll, w == pj) >> shift) & 0xff;
  const uint32_t sum = (gen | prop) + gen;
  const uint32_t borrows = sum ^ (gen | prop) ^ gen;
  return (sum >> 8) & 1 ? w : w - pj - ((borrows >> j) & 1);
}

// The product steps put each Fq product on a group of 8 lanes (lane 8 g +
// j holds word j), four products at a time; the add and sub steps run one
// operation per lane as shipped.
__device__ __forceinline__ void run_steps(Fq* slot, const uint32_t* code, int n_steps, int lane) {
  const int g = lane >> 3, j = lane & 7;
  for (int s = 0; s < n_steps; s++) {
    const uint32_t* st = code + s * kLanes;
    if ((st[0] >> 30) == 1) {
      for (int k = 0; k < kLanes && (st[k] >> 30); k += 4) {
        const uint32_t op = st[k + g];
        const uint32_t r = sliced_mul_word(slot[(op >> 10) & 1023u].v[j], slot[op & 1023u].v[j], j);
        if (op >> 30) slot[(op >> 20) & 1023u].v[j] = r;
      }
    } else {
      const uint32_t op = st[lane];
      if (op >> 30)
        slot[(op >> 20) & 1023u] = add(slot[(op >> 10) & 1023u], negate_if(slot[op & 1023u], (op >> 30) == 3));
    }
    __syncwarp();
  }
}
"""


_EVAL_ACC = "using EvalAcc = AccProduct;"
_ACC_WIDE = r"""// The row's exact sum of x * cR over 17 words (< 2^23 r^2 < 2^531, x the
// witness row mod r): per entry the full 8 x 8-word product (field.cuh's
// rows of carry chains) and a 17-word add; per row one word-wise
// Montgomery reduction by 2^512 (sixteen rounds), < 2r, and a conditional
// subtract: sum x c R * 2^-512 = sum w c R^-1 mod r.
struct AccWide {
  uint32_t t[17];
  // the witness row reduced mod r: (w * R^2 * R^-1) * 1 * R^-1
  __device__ __forceinline__ static Fr prep(const Fr& w) {
    const Fr r2 = {{0xae216da7u, 0x1bb8e645u, 0xe35c59e3u, 0x53fe3ab1u, 0x53bb8085u, 0x8c49833du, 0x7f4e44a5u,
                    0x0216d0b1u}};
    Fr one = fp_zero<FrMod>();
    one.v[0] = 1;
    return mul(mul(w, r2), one);
  }
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < 17; i++) t[i] = 0;
  }
  __device__ __forceinline__ void add_entry(const Fr& x, const Fr& c) {
    uint32_t p[17];
#pragma unroll
    for (int i = 0; i < 17; i++) p[i] = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
      mad_lo_row(p + i, x.v, c.v[i]);
      mad_hi_row(p + i, x.v, c.v[i]);
    }
    uint64_t k = 0;
#pragma unroll
    for (int i = 0; i < 17; i++) {
      k += (uint64_t)t[i] + p[i];
      t[i] = (uint32_t)k;
      k >>= 32;
    }
  }
  __device__ __forceinline__ Fr value() const {
    uint32_t u[25];
#pragma unroll
    for (int i = 0; i < 25; i++) u[i] = i < 17 ? t[i] : 0;
#pragma unroll
    for (int i = 0; i < 16; i++) {
      const uint32_t m = u[i] * FrMod::n0;
      uint64_t k = 0;
#pragma unroll
      for (int j = 0; j < 8; j++) {
        k += (uint64_t)m * FrMod::p(j) + u[i + j];
        u[i + j] = (uint32_t)k;
        k >>= 32;
      }
#pragma unroll
      for (int j = i + 8; j < 25; j++) {
        k += u[j];
        u[j] = (uint32_t)k;
        k >>= 32;
      }
    }
    return fp_csub<FrMod>(u + 16, u[24]);
  }
};

"""
_AB_PREFETCH = r"""    // the operands of entry e, and the witness row of entry e + 1, loaded
    // one entry ahead of the product
    Fr x = fp_zero<FrMod>(), c = fp_zero<FrMod>();
    int s_next = 0;
    if (e < e_lim) {
      x = load_words(wpk + 2 * (long long)__ldcs(src + e));
      c = load_words_stream(val + 2 * e);
      if (e + 1 < e_lim) s_next = __ldcs(src + e + 1);
    }
    for (long long d = d0; d < d1; d++) {
      if (e < row_end) {
        Fr xn = fp_zero<FrMod>(), cn = fp_zero<FrMod>();
        int sn = 0;
        if (e + 1 < e_lim) {
          xn = load_words(wpk + 2 * (long long)s_next);
          cn = load_words_stream(val + 2 * (e + 1));
          if (e + 2 < e_lim) sn = __ldcs(src + e + 2);
        }
        acc.add_entry(x, c);
        x = xn;
        c = cn;
        s_next = sn;
        e++;
"""
_AB_IN_TURN = r"""    for (long long d = d0; d < d1; d++) {
      if (e < row_end) {
        const int s = __ldcs(src + e);
        acc.add_entry(load_words(wpk + 2 * (long long)s), load_words_stream(val + 2 * e));
        e++;
"""
_AB_E_LIM = "const long long e_lim = e + (d1 - d0) < total - n_rows ? e + (d1 - d0) : total - n_rows;"


def _swap(old: str, new: str):
    """An edit that replaces `old`, which must occur, by `new`."""

    def edit(src: str) -> str:
        assert old in src, f"anchor not found: {old!r}"
        return src.replace(old, new)

    return edit


def _function_body(signature: str, body: str):
    """An edit that replaces the body of the function opening with
    `signature` (through its closing brace at the start of a line)."""

    def edit(src: str) -> str:
        start = src.index(signature) + len(signature)
        end = src.index("\n}\n", start) + 1
        return src[:start] + body + src[end:]

    return edit


def _chain(*edits):
    """One edit that applies `edits` in order (each may need the ones
    before it)."""

    def edit(src: str) -> str:
        for e in edits:
            src = e(src)
        return src

    return edit


def _sliced(src: str) -> str:
    start = src.index(_RUN_STEPS)
    end = src.index("\n}\n", start) + 3
    return src[:start] + _SLICED_RUN_STEPS + src[end:]


_K3_SCALAR_UNPACK = """  F r;
  uint32_t* w = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int i = 0; i < (int)sizeof(F) / 4; i++)
    w[i] = ((uint32_t)row[2 * i] & 0xffffu) | ((uint32_t)row[2 * i + 1] << 16);
  return r;
"""
_K3_SCALAR_PACK = """  const uint32_t* w = reinterpret_cast<const uint32_t*>(&a);
#pragma unroll
  for (int i = 0; i < (int)sizeof(F) / 4; i++) {
    row[2 * i] = (int32_t)(w[i] & 0xffffu);
    row[2 * i + 1] = (int32_t)(w[i] >> 16);
  }
"""
_K3_MUL = "__device__ __noinline__ Fp<FqMod> k3_mul(Fp<FqMod> a, Fp<FqMod> b)"
_K3_SCALAR = [
    ("curve_ops.cu", _function_body("__device__ __forceinline__ F unpack(const int32_t* row) {\n", _K3_SCALAR_UNPACK)),
    ("curve_ops.cu", _function_body("__device__ __forceinline__ void pack(int32_t* row, const F& a) {\n",
                                    _K3_SCALAR_PACK)),
]
_K3_CALLS = [("curve_ops.cu", _swap("using G2 = Fq2K3;", "using G2 = Fq2;"))]
_K3_BYREF = [("curve_ops.cu", _swap(_K3_MUL, _K3_MUL.replace("(Fp<FqMod> a, Fp<FqMod> b)",
                                                             "(const Fp<FqMod>& a, const Fp<FqMod>& b)")))]


def _k3_budget(g1: tuple, g2: tuple):
    """K3's register budgets: blocks per SM for (madd, dbl, add), G1 and G2."""

    def edit(src: str) -> str:
        for head, (madd, dbl, add) in (("struct Budget {\n", g1), ("struct Budget<G2> {\n", g2)):
            src, count = re.subn(re.escape(head) + r"  static constexpr int madd = \d+, dbl = \d+, add = \d+;",
                                 f"{head}  static constexpr int madd = {madd}, dbl = {dbl}, add = {add};", src)
            assert count == 1, f"curve_ops.cu: {head.strip()} not found"
        return src

    return [("curve_ops.cu", edit)]


_ADD_CALL = "store_point<F>(ox, oy, oz, i, add_complete("
_ADD_KERNEL = "template <class F>\n__global__ void __launch_bounds__(THREADS, Budget<F>::add)\nadd_kernel("
_ADD_ANY = """// ec.cuh add_core, its doubling once per warp behind __any_sync
template <class F>
__device__ __forceinline__ Jac<F> add_any(const Jac<F>& p, const Jac<F>& q) {
  F z1z1 = gsqr(p.z);
  F z2z2 = gsqr(q.z);
  F u1 = gmul(p.x, z2z2);
  F u2 = gmul(q.x, z1z1);
  F s1 = gmul(gmul(p.y, q.z), z2z2);
  F s2 = gmul(gmul(q.y, p.z), z1z1);
  F h = sub(u2, u1);
  F rr = sub(s2, s1);
  F r2 = add(rr, rr);
  F i4 = gsqr(add(h, h));
  F j = gmul(h, i4);
  F v = gmul(u1, i4);
  F x3 = sub(sub(gsqr(r2), j), add(v, v));
  F s1j = gmul(s1, j);
  F y3 = sub(gmul(r2, sub(v, x3)), add(s1j, s1j));
  F zz = sub(sub(gsqr(add(p.z, q.z)), z1z1), z2z2);
  F z3 = gmul(zz, h);
  Jac<F> out = {x3, y3, z3};
  bool p_inf = is_zero(p.z);
  bool q_inf = is_zero(q.z);
  bool d = is_zero(h) && !p_inf && !q_inf && is_zero(rr);
  if (__any_sync(__activemask(), d)) {
    Jac<F> pd = dbl_core(p);
    if (d) out = pd;
  }
  if (p_inf) out = q;
  if (q_inf) out = p;
  return out;
}

"""


def _pow_bits(src: str) -> str:
    """mont_pow_kernel's chain bit by bit (MSB-first square and multiply)."""
    head = ("__global__ void mont_pow_kernel(const int4* __restrict__ a, int4* __restrict__ out, long long n, "
            "Exponent e) {\n")
    body = """  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t w[8];
#pragma unroll
  for (int k = 0; k < 8; k++) w[k] = e.w[k];
  const Fp<M> x = load_row<M>(a + 4 * i);
  Fp<M> acc = fp_one<M>();
#pragma unroll 1
  for (int b = e.nbits - 1; b >= 0; b--) {
    acc = mul(acc, acc);
    if ((exp_digit(w, b >> 2) >> (b & 3)) & 1u) acc = mul(acc, x);
  }
  store_row(out + 4 * i, acc);
"""
    return _function_body(head, body)(src)


# ---- K4's complete body (msm_scan.cu `scan_law`) and the distinct body ----

_COMPLETE_CALL = ("  using C = Complete<F>;\n"
                  "  scan_law<typename C::Coord, typename C::Law>(keys, pay, table, tinf, tbl, n_seg, hk, hpt, tk, tpt, "
                  "L, V, l);\n")
_SCAN_LAW = "// One lane's walk with the law `Law`"
_SCAN_LAW_SIGNATURE = "int32_t* __restrict__ tpt, long long L, long long V, long long l) {\n  typename Law::Acc acc"
_INF_FIRST = "  bool inf_now = tinf[pw_now & kRowMask] != 0, inf_next = false;\n"
_INF_NEXT = "    if (t + 1 < L) inf_next = tinf[pw_next & kRowMask] != 0;\n"
_LOAD_TABLE = "    load_affine(reinterpret_cast<const int4*>(table + (pw_now & kRowMask) * 2 * Field<F>::rows), x2, y2);\n"
_LAUNCH = "  auto kernel = complete ? window_scan_complete_kernel<F> : window_scan_kernel<F>;\n  kernel<<<blocks, threads, 0, s>>>("
_RING_HELPERS = """constexpr int kScanThreads = 128;

// int4 words of one table row; a ring slot holds one more, so that the eight
// threads of a quarter warp read their 16-byte words from distinct banks
template <class F>
__host__ __device__ constexpr int row_words() {
  return Field<F>::rows / 2;
}

template <class F>
constexpr int ring_bytes() {
  return 2 * kScanThreads * (row_words<F>() + 1) * (int)sizeof(int4);
}

template <class F>
__device__ __forceinline__ int4* ring_slot(int4* ring, long long s) {
  return ring + (s * kScanThreads + threadIdx.x) * (row_words<F>() + 1);
}

__device__ __forceinline__ void cp_async16(int4* smem, const int4* gmem) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\\n" ::"n"(N) : "memory");
}

template <class F>
__device__ __forceinline__ void fetch_row(int4* slot, const int32_t* table, int pw) {
  const int4* row = reinterpret_cast<const int4*>(table + (pw & kRowMask) * 2 * Field<F>::rows);
#pragma unroll
  for (int k = 0; k < row_words<F>(); k++) cp_async16(slot + k, row + k);
}

"""
# the ring: each thread copies its row t + 1 into the other of two slots in
# shared memory (16-byte cp.async) while step t adds, and reads row t from
# its slot; the complete kernel gets the ring as dynamic shared memory
_RING_EDITS = (
    _swap(_SCAN_LAW, _RING_HELPERS + _SCAN_LAW),
    _swap(_SCAN_LAW_SIGNATURE, _SCAN_LAW_SIGNATURE.replace("long long l) {", "long long l,\n"
                                                           "                         int4* ring) {")),
    _swap(_INF_FIRST, "  fetch_row<F>(ring_slot<F>(ring, 0), table, pw_now);\n  cp_async_commit();\n" + _INF_FIRST),
    _swap(_INF_NEXT, "    if (t + 1 < L) {\n"
                     "      fetch_row<F>(ring_slot<F>(ring, (t + 1) & 1), table, pw_next);\n"
                     "      inf_next = tinf[pw_next & kRowMask] != 0;\n    }\n"
                     "    cp_async_commit();\n"),
    _swap(_LOAD_TABLE, "    cp_async_wait<1>();\n    load_affine(ring_slot<F>(ring, t & 1), x2, y2);\n"),
    _swap(_COMPLETE_CALL, "  extern __shared__ int4 ring[];\n" + _COMPLETE_CALL.replace("L, V, l);", "L, V, l, ring);")),
    _swap(_LAUNCH, _LAUNCH.replace(
        "  kernel<<<blocks, threads, 0, s>>>(",
        "  const int smem = complete ? ring_bytes<typename Complete<F>::Coord>() : 0;\n"
        "  if (smem > 48 * 1024) cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);\n"
        "  kernel<<<blocks, threads, smem, s>>>(")),
)


def _ring(*more):
    """The ring, then the edits `more` of the ringed source, as one edit."""
    return [("msm_scan.cu", _chain(*_RING_EDITS, *more))]


# one slot: row t + 1 is copied into it once row t has been read from it
_RING_1 = _ring(
    _swap("      fetch_row<F>(ring_slot<F>(ring, (t + 1) & 1), table, pw_next);\n", ""),
    _swap("    }\n    cp_async_commit();\n", "    }\n"),
    _swap("    cp_async_wait<1>();\n    load_affine(ring_slot<F>(ring, t & 1), x2, y2);\n",
          "    cp_async_wait<0>();\n    load_affine(ring_slot<F>(ring, 0), x2, y2);\n"
          "    if (t + 1 < L) fetch_row<F>(ring_slot<F>(ring, 0), table, pw_next);\n"
          "    cp_async_commit();\n"),
    _swap("  return 2 * kScanThreads", "  return kScanThreads"),
)
# the least shared-memory carveout (percent of 228 KB) that holds two blocks' rings
_CARVEOUT = _ring(_swap("  kernel<<<blocks, threads, smem, s>>>(", (
    "  if (smem) cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,\n"
    "                                 (2 * (smem + 1024) * 100 + 228 * 1024 - 1) / (228 * 1024));\n"
    "  kernel<<<blocks, threads, smem, s>>>(")))

# 3b' = 3 * 3 / (9 + u) = (81 - 9u) / 82 on the twist, Montgomery words
_G2_PROJ = """
__device__ __forceinline__ Fq2S mul_b3(const Fq2S& a) {
  constexpr uint32_t c0[8] = {0xb62e0d6au, 0x3baa927cu, 0xd1b664fdu, 0xd71e7c52u,
                              0xd95d4664u, 0x03873e63u, 0x082ab8f4u, 0x0e75b5b1u};
  constexpr uint32_t c1[8] = {0x7596fe35u, 0xaab7c666u, 0xbb6a27bau, 0x31d21a78u,
                              0x680401ffu, 0x85dd7297u, 0xdf39a7e9u, 0x03c52d6au};
  Fq2S b3;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    b3.c0.v[i] = c0[i];
    b3.c1.v[i] = c1[i];
  }
  return gmul(a, b3);
}

__device__ __noinline__ Proj<Fq2S> madd_proj(const Proj<Fq2S>& p, const Fq2S& x2, const Fq2S& y2, bool q_inf,
                                             bool fold, Jac<Fq2S>& pj) {
  return kzk::madd_proj<Fq2S>(p, x2, y2, q_inf, fold, pj);
}
"""
_FQ2S_LOAD = "  y = {kzk::load_row<FqMod>(row + 8), kzk::load_row<FqMod>(row + 12)};\n}\n"

_DISTINCT_KERNEL = """// the two bodies are two kernels, so that ptxas reports each on its own
template <class F>
__global__ void __launch_bounds__(128)
window_scan_kernel(const int32_t* __restrict__ keys, const int32_t* __restrict__ pay,
                   const int32_t* __restrict__ table, const uint8_t* __restrict__ tinf,
                   int32_t* __restrict__ tbl, long long n_seg, int32_t* __restrict__ hk,
                   int32_t* __restrict__ hpt, int32_t* __restrict__ tk, int32_t* __restrict__ tpt, long long L,
                   long long V) {
  long long l = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (l >= V) return;
  scan_lane<F>(keys, pay, table, tinf, tbl, n_seg, hk, hpt, tk, tpt, L, V, l);
}
"""
_COMPLETE_KERNEL = "// F: the group's coordinate field (Fp<FqMod> or Fq2)\n"
_CORE_LAW = """template <class F>
struct CoreLaw {  // madd_core, the distinct body's law
  using Acc = Jac<F>;
  static constexpr bool folds = false;
  static __device__ __forceinline__ Acc start(const F& x2, const F& y2, bool q_inf) {
    return {x2, y2, q_inf ? Field<F>::zero() : Field<F>::one()};
  }
  static __device__ __forceinline__ Acc step(const Acc& acc, const F& x2, const F& y2, bool q_inf, bool same,
                                             bool ended, Jac<F>& done) {
    return same ? madd_core(acc, x2, y2, q_inf) : acc;
  }
  static __device__ __forceinline__ Jac<F> to_jac(const Acc& acc) { return acc; }
};

"""


def _distinct(coord_law: str, ring: bool = False):
    """The distinct body's kernel on `scan_law` with `coord_law`
    ("<coordinates>, <law>"), and with the ring."""
    call = f"  scan_law<{coord_law}>(keys, pay, table, tinf, tbl, n_seg, hk, hpt, tk, tpt, L, V, l{', ring' * ring});\n"
    kernel = (_CORE_LAW + _DISTINCT_KERNEL.replace("  scan_lane<F>(keys, pay, table, tinf, tbl, n_seg, hk, hpt, "
                                                   "tk, tpt, L, V, l);\n", "  extern __shared__ int4 ring[];\n" * ring
                                                   + call))
    edits = (_swap(_DISTINCT_KERNEL, ""), _swap(_COMPLETE_KERNEL, kernel + "\n" + _COMPLETE_KERNEL))
    if ring:
        return _ring(*edits, _swap("complete ? ring_bytes<typename Complete<F>::Coord>() : 0", "ring_bytes<F>()"))
    return [("msm_scan.cu", edit) for edit in edits]


_AB_WIDE = [("eval_ab.cu", _swap(_EVAL_ACC, _ACC_WIDE + "using EvalAcc = AccWide;"))]
_AB_NO_PREFETCH = [("eval_ab.cu", _swap(_AB_PREFETCH, _AB_IN_TURN))]

# name -> ([(source file, edit)], applied in order; the kernels it concerns: None for all)
VARIANTS = {
    "shipped": ([], None),
    "inline": ([("field.cuh", _swap(_GMUL, _GMUL.replace("__noinline__", "__forceinline__")))], None),
    "wide": ([("field.cuh", _function_body(_MUL, "  return mul_wide(a, b);\n"))], None),
    "occupancy": ([("msm_scan.cu", _swap(_SCAN_BOUNDS, _SCAN_BOUNDS.replace("(128)", "(128, 4)")))], ("K4",)),
    "sliced": ([("msm_reduce.cu", _sliced)], ("K7",)),
    "k3_scalar": (_K3_SCALAR, ("K3",)),
    "k3_calls": (_K3_CALLS, ("K3",)),
    "k3_byref": (_K3_BYREF, ("K3",)),
    "k3_inline": ([("curve_ops.cu", _swap(_K3_MUL, _K3_MUL.replace("__noinline__", "__forceinline__")))], ("K3",)),
    "k3_first": (_K3_SCALAR + _K3_CALLS + _K3_BYREF + _k3_budget((1, 1, 1), (1, 1, 1))
                 + [("curve_ops.cu", _swap("using G1 = FqK3;", "using G1 = Fp<FqMod>;"))], ("K3",)),
    "k3_budget_low": (_k3_budget((1, 2, 1), (3, 1, 1)), ("K3",)),
    "k3_budget_high": (_k3_budget((3, 6, 3), (5, 3, 2)), ("K3",)),
    "k3_add_budget_2": (_k3_budget((2, 4, 2), (4, 2, 2)), ("K3",)),
    "k3_add_budget_4": (_k3_budget((2, 4, 4), (4, 2, 4)), ("K3",)),
    "k3_add_branch": ([("curve_ops.cu", _swap(_ADD_CALL, _ADD_CALL.replace("add_complete", "add_core")))], ("K3",)),
    "k3_add_any": ([("curve_ops.cu", _swap(_ADD_KERNEL, _ADD_ANY + _ADD_KERNEL)),
                    ("curve_ops.cu", _swap(_ADD_CALL, _ADD_CALL.replace("add_complete", "add_any")))], ("K3",)),
    "pow_bits": ([("mont_mul.cu", _pow_bits)], ("K1",)),
    "ab_wide": (_AB_WIDE, ("K9",)),
    "ab_no_prefetch": (_AB_NO_PREFETCH, ("K9",)),
    "ab_prefetch_past": ([("eval_ab.cu", _swap(_AB_E_LIM, "const long long e_lim = total - n_rows;"))], ("K9",)),
    "ring": (_ring(), ("K4c",)),
    "ring_off": (_ring(_swap("cp_async_wait<1>();", "cp_async_wait<0>();")), ("K4c",)),
    "ring_1": (_RING_1, ("K4c",)),
    "carveout": (_CARVEOUT, ("K4c",)),
    "g1_jac": ([("msm_scan.cu", _swap("  using Coord = Fp<FqMod>;\n  using Law = ProjLaw<Coord>;",
                                      "  using Coord = Fp<FqMod>;\n  using Law = JacLaw<Coord>;"))], ("K4c",)),
    "g2_proj": ([("msm_scan.cu", _swap(_FQ2S_LOAD, _FQ2S_LOAD + _G2_PROJ)),
                 ("msm_scan.cu", _swap("  using Coord = Fq2S;\n  using Law = JacLaw<Coord>;",
                                       "  using Coord = Fq2S;\n  using Law = ProjLaw<Coord>;"))], ("K4c",)),
    "g2_mont": ([("msm_scan.cu", _swap("{ return mul_wide(a, b); }", "{ return mul(a, b); }"))], ("K4c",)),
    "g2_byref": ([("msm_scan.cu", _swap("scan_mul(Fp<FqMod> a, Fp<FqMod> b)",
                                        "scan_mul(const Fp<FqMod>& a, const Fp<FqMod>& b)"))], ("K4c",)),
    "g2_fq2": ([("msm_scan.cu", _swap("  using Coord = Fq2S;", "  using Coord = Fq2;"))], ("K4c",)),
    "distinct_loop": (_distinct("F, CoreLaw<F>"), ("K4",)),
    "distinct_ring": (_distinct("F, CoreLaw<F>", ring=True), ("K4",)),
    "distinct_law": (_distinct("typename Complete<F>::Coord, typename Complete<F>::Law"), ("K4",)),
}
# variants whose scan outputs are other coordinates of the same points
LAW_VARIANTS = ("g1_jac", "g2_proj", "distinct_law")


def concerns(variant: str, label: str) -> bool:
    """Whether a variant is run on the case `label` (which starts with its
    kernel's id)."""
    scope = VARIANTS[variant][1]
    return scope is None or label.split()[0] in scope


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 3) -> float:
    """ms per call of fn over `reps` calls, after one untimed call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def sass_sizes(lib_path) -> dict:
    """SASS instructions per kernel of a built library (cuobjdump -sass)."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True, check=True).stdout
    out = {}
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        name = body.split("\n", 1)[0]
        for k in KERNELS:
            if _build.mangles(k, name):
                out[k + _build.field_suffix(name)] = len(re.findall(r"/\*[0-9a-f]{4,}\*/\s+\S", body))
    return out


def build_variants(names) -> dict:
    """Build the variants `names`, four at a time; {name: loaded library}.
    A variant that nvcc refuses is reported and left out."""
    root = _build.BUILD_ROOT.parent / "variants"

    def one(name):
        edits = VARIANTS[name][0]
        csrc = _build.CSRC
        if edits:
            csrc = root / name
            shutil.rmtree(csrc, ignore_errors=True)
            shutil.copytree(_build.CSRC, csrc)
            for file, edit in edits:
                (csrc / file).write_text(edit((csrc / file).read_text()))
        return name, _build.build(csrc)

    def attempt(name):
        try:
            return one(name)
        except RuntimeError as e:  # nvcc refused the variant: reported, and the run fails
            return name, e

    libs = {}
    with ThreadPoolExecutor(4) as pool:
        for name, built in pool.map(attempt, names):
            if isinstance(built, RuntimeError):
                log(f"build {name}: FAILED {built}")
                continue
            path, secs = built
            report = _build.ptxas_report((path.parent / "build.log").read_text(), KERNELS)
            log(f"build {name}: {secs:.1f} s; ptxas {json.dumps(report)}")
            log(f"  sass instructions {json.dumps(sass_sizes(path))}")
            libs[name] = _build.load(path)
    return libs


TABLE_POINTS = {"fq": 1 << 16, "fq2": 1 << 12}  # distinct points of the random tables


def point_table(tag: str, n_distinct: int, rows: int, dev):
    """(rows + 1, 2R) affine x||y table of n_distinct random points repeated,
    and its infinity flags; the last row is the infinity sentinel."""
    curve = G1_CURVE if tag == "fq" else G2_CURVE
    R = cuda_msm.rows_for(tag)
    x, y, inf = testgen.random_points(n_distinct, seed=5, curve=curve, device=dev)
    t = torch.cat([x.reshape(n_distinct, R), y.reshape(n_distinct, R)], 1).repeat(rows // n_distinct, 1)
    t = torch.cat([t, torch.zeros((1, 2 * R), dtype=t.dtype, device=dev)]).int().contiguous()
    tinf = torch.cat([inf.bool().repeat(rows // n_distinct), torch.ones(1, dtype=torch.bool, device=dev)])
    return t, tinf.contiguous()


def scan_stream(n_seg: int, entries: int, V: int, n_rows: int, n_points: int, gen, dev):
    """K4's (L, V) keys and payloads: sorted random bucket ids, padded with
    the sentinel n_seg to whole lanes; no entry repeats the point of the
    entry just before it in its lane (the distinct body's precondition;
    row r of the table holds point r % n_points)."""
    L = -(-entries // V)
    ids = torch.sort(torch.randint(0, n_seg, (entries,), generator=gen, device=dev)).values
    ids = torch.nn.functional.pad(ids, (0, L * V - entries), value=n_seg)
    lane = torch.randint(0, n_rows, (V, L), generator=gen, device=dev)
    for _ in range(3):
        dup = torch.zeros_like(lane, dtype=torch.bool)
        dup[:, 1:] = lane[:, 1:] % n_points == lane[:, :-1] % n_points
        lane = torch.where(dup, (lane + 1) % n_rows, lane)
    neg = torch.randint(0, 2, (V, L), generator=gen, device=dev)
    keys = ids.reshape(V, L).int().T.contiguous()
    pay = (lane | (neg << 30)).int().T.contiguous()
    return keys, pay


def bucket_planes(tag: str, table, tinf, n: int, gen):
    """(3R, n) Jacobian planes (z = 1, or 0 at infinity) of random table rows."""
    curve = G1_CURVE if tag == "fq" else G2_CURVE
    R = cuda_msm.rows_for(tag)
    idx = torch.randint(0, table.shape[0], (n,), generator=gen, device=table.device)
    rows = table[idx]
    z = curve.ops.select(tinf[idx], curve.ops.zeros((n,), table.device), curve.ops.const(1, (n,), table.device))
    p = JacPoint(cuda_msm.rows_to_coord(rows[:, :R], tag), cuda_msm.rows_to_coord(rows[:, R:], tag), z)
    return cuda_msm.point_to_planes(p, tag)


def planted_stream(tag: str, dev):
    """The (keys, pay, table, tinf, n_seg) that K4's complete body scans in
    `msm(..., assume_distinct=False)` over a planted 2^16-row table: random
    points each in four consecutive rows (the rows of every 97th point at
    infinity, zero coordinates) and scalars whose lowest c-bit digit is
    nonzero and shared by a point's four rows, so that the bucket runs of
    window 0 add P + P (chip_smoke.py's planted tables)."""
    curve = G1_CURVE if tag == "fq" else G2_CURVE
    n, groups = 1 << 16, 1 << 14
    ux, uy, _ = testgen.random_points(groups, seed=41, curve=curve, device=dev)
    x, y = (t.repeat_interleave(4, dim=0).contiguous() for t in (ux, uy))
    inf = (torch.arange(n, device=dev) // 4) % 97 == 5
    x[inf] = 0
    y[inf] = 0
    gen = torch.Generator(device=dev)
    gen.manual_seed(42)
    scalars = torch.randint(0, 1 << 16, (n, 16), generator=gen, dtype=torch.int32, device=dev)
    scalars[:, 15] = scalars[:, 15] % (FR.p >> 240)
    c = msm.fused_window_bits(n)
    digit = torch.randint(1, (1 << (c - 1)) + 1, (groups,), generator=gen, device=dev, dtype=torch.int32)
    scalars[:, 0] = (scalars[:, 0] & (0xFFFF ^ ((1 << c) - 1))) | digit.repeat_interleave(4)
    calls = []
    real = cuda_msm.window_scan_complete

    def capture(*args):
        calls.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args))
        return real(*args)

    capture.launches = 0  # the launch wrapper counts on whatever the module's name holds
    cuda_msm.window_scan_complete = capture
    try:
        msm.msm(x, y, inf, scalars, curve=curve, assume_distinct=False)
    finally:
        cuda_msm.window_scan_complete = real
    (_, keys, pay, table, tinf, tbl), = calls
    return keys, pay, table, tinf, tbl.shape[1]


def same_points(tag: str, a, b) -> bool:
    """Whether the (3R, n) Jacobian planes a and b hold the same points, on
    the card: both at infinity (z == 0), or x_a z_b^2 == x_b z_a^2 and
    y_a z_b^3 == y_b z_a^3."""
    f = cuda_msm.curve_for(tag).ops
    p, q = cuda_msm.planes_to_point(a, tag), cuda_msm.planes_to_point(b, tag)
    n = a.shape[1]

    def eq(u, v):
        return (u == v).reshape(n, -1).all(1)

    pi, qi = f.is_zero(p.z), f.is_zero(q.z)
    zp2, zq2 = f.sqr(p.z), f.sqr(q.z)
    same = eq(f.mul(p.x, zq2), f.mul(q.x, zp2)) & eq(f.mul(p.y, f.mul(zq2, q.z)), f.mul(q.y, f.mul(zp2, p.z)))
    return bool(((pi & qi) | (~pi & ~qi & same)).all())


def same_scan(tag: str, got, want) -> bool:
    """A scan's (table, head keys, heads, tail keys, tails) against
    another's: keys exactly, points as affine points."""
    tbl, hk, hpt, tk, tpt = got
    return (torch.equal(hk, want[1]) and torch.equal(tk, want[3])
            and all(same_points(tag, g, w) for g, w in ((tbl, want[0]), (hpt, want[2]), (tpt, want[4]))))


def merge_inputs(tag: str, m: int, table, gen):
    """A K5 boundary sequence of m entries like the main path's: one key
    (window 0's digit-1 bucket) over 90% of it, then runs of one to eight
    entries; points from the table."""
    dev = table[0].device
    runs = torch.randint(1, 9, (m,), generator=gen, device=dev)
    runs[0] = m * 9 // 10
    starts = torch.cumsum(runs, 0) - runs
    keys = (torch.searchsorted(starts, torch.arange(m, device=dev), right=True)).int().contiguous()
    return keys, bucket_planes(tag, *table, m, gen)


def k3_batch(tag: str, n: int, seed: int, dev):
    """n Jacobian points (z != 1, a doubling of random affine points) and n
    affine points, each 2^14 random points repeated."""
    curve = G1_CURVE if tag == "fq" else G2_CURVE
    m = 1 << 14
    x, y, inf = testgen.random_points(m, seed=seed, curve=curve, device=dev)
    qx, qy, qinf = testgen.random_points(m, seed=seed + 1, curve=curve, device=dev)
    reps = -(-n // m)

    def rep(t):
        return t.repeat(reps, *([1] * (t.dim() - 1)))[:n].contiguous()

    p = curve.dbl(curve.from_affine(x, y, inf.bool()))
    return JacPoint(*(rep(c) for c in p)), (rep(qx), rep(qy), rep(qinf.bool()))


def add_batch(tag: str, n: int, seed: int, dev):
    """Two Jacobian batches for the full add (z != 1): q equals p, with
    another z, in the lanes i % 64 == 2, random elsewhere."""
    curve = G1_CURVE if tag == "fq" else G2_CURVE
    f = curve.ops
    p, _ = k3_batch(tag, n, seed, dev)
    q, _ = k3_batch(tag, n, seed + 2, dev)
    l2 = f.sqr(p.z)  # p scaled by lam = p.z: the same point
    same = JacPoint(f.mul(p.x, l2), f.mul(p.y, f.mul(l2, p.z)), f.mul(p.z, p.z))
    q = curve.select(torch.arange(n, device=dev) % 64 == 2, same, q)
    return p, JacPoint(*(c.contiguous() for c in q))


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: CUDA is not available; this script needs one NVIDIA GPU", file=sys.stderr)
        return 2
    kernels = set(argv) or {"K1", "K3", "K4", "K4c", "K5", "K6", "K7", "K9"}
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True, check=True).stdout.strip()
    log(f"card: {card}")
    t0 = time.perf_counter()
    names = [name for name, (_, scope) in VARIANTS.items() if scope is None or kernels & set(scope)]
    libs = build_variants(names)
    shipped_library = _build.library
    k6_budget = cuda_msm._BUCKET_LANES, cuda_msm._MIN_BUCKETS_PER_LANE
    merge_tiles = dict(cuda_msm._MERGE_TILE)

    def use(name):
        _build.library = lambda: libs[name]

    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    cases = []
    if "K1" in kernels:
        a = torch.randint(0, 1 << 16, (1 << 22, 16), generator=gen, dtype=torch.int32, device=dev)
        b = torch.randint(0, 1 << 16, (1 << 22, 16), generator=gen, dtype=torch.int32, device=dev)
        a[:, 15] = a[:, 15] % (FR.p >> 240)
        b[:, 15] = b[:, 15] % (FR.p >> 240)
        cases.append(("K1 mont_mul fr 2^22", lambda: cuda_field.mont_mul(a, b, FR)))
        for n in (4, 1, 1 << 21):
            x = a[:n].clone()
            x[:, 15] = x[:, 15] % (FQ.p >> 240)
            cases.append((f"K1 mont_pow fq n={n}, e = p - 2", lambda x=x: cuda_field.mont_pow(x, FQ.p - 2, FQ)))
    if "K3" in kernels:
        for tag, n, n_affine in (("fq", 1 << 21, 1 << 20), ("fq2", 2_097_150, 1 << 18)):
            curve = G1_CURVE if tag == "fq" else G2_CURVE
            g = curve.encode_affine([ref_curve.G1_GEN if tag == "fq" else ref_curve.G2_GEN], device=dev)
            p, _ = k3_batch(tag, n, 61, dev)
            cases.append((f"K3 dbl {tag} n={n} (setup step)", lambda p=p, tag=tag: cuda_curve.curve_dbl(p, tag)))
            cases.append((f"K3 madd {tag} n={n}, generator broadcast (setup step)",
                          lambda p=p, g=g, tag=tag: cuda_curve.curve_madd(p, *g, tag)))
            pa, q = k3_batch(tag, n_affine, 63, dev)
            cases.append((f"K3 madd {tag} n={n_affine}, nq=n",
                          lambda p=pa, q=q, tag=tag: cuda_curve.curve_madd(p, *q, tag)))
        for tag, n in (("fq", (1 << 20) + 37), ("fq2", (1 << 18) + 61)):
            p, q = add_batch(tag, n, 67, dev)
            cases.append((f"K3 add {tag} n={n}, P == Q in one lane of 64",
                          lambda p=p, q=q, tag=tag: cuda_curve.curve_add(p, q, tag)))
            p1, q1 = (JacPoint(*(c[1:2].contiguous() for c in pt)) for pt in (p, q))
            cases.append((f"K3 add {tag} n=1 (the sharded combine's)",
                          lambda p=p1, q=q1, tag=tag: cuda_curve.curve_add(p, q, tag)))
        small, q3 = k3_batch("fq2", 3, 65, dev)

        def steps(p=small, q=q3):
            for _ in range(10):
                p = cuda_curve.curve_madd(cuda_curve.curve_dbl(p, "fq2"), *q, "fq2")
            return p

        cases.append(("K3 dbl then madd fq2 n=3, nq=n, 10 steps (the small-n MSM's)", steps))
    tables = {}
    scan_tags = {}  # K4 and K4c cases: label -> field
    if kernels & {"K4", "K4c", "K5", "K6", "K7"}:
        tables = {"fq": point_table("fq", TABLE_POINTS["fq"], 1 << 21, dev),
                  "fq2": point_table("fq2", TABLE_POINTS["fq2"], 1 << 12, dev)}
    for tag, wn, nb, entries, V in (("fq", 16, 32769, 1 << 25, msm._SCAN_LANES),
                                    ("fq", 16, 32769, 1 << 25, 2 * msm._SCAN_LANES),
                                    ("fq2", 22, 2049, 1 << 20, 1 << 15)):
        if not kernels & {"K4", "K4c"}:
            break
        table, tinf = tables[tag]
        keys, pay = scan_stream(wn * nb, entries, V, table.shape[0] - 1, TABLE_POINTS[tag], gen, dev)
        tbl = torch.zeros((3 * cuda_msm.rows_for(tag), wn * nb), dtype=torch.int32, device=dev)
        for body, kernel in (("K4 window_scan", cuda_msm.window_scan), ("K4c window_scan_complete",
                                                                        cuda_msm.window_scan_complete)):
            if body.split()[0] not in kernels or (body.startswith("K4c") and V == 2 * msm._SCAN_LANES):
                continue

            def scan(kernel=kernel, tag=tag, keys=keys, pay=pay, table=table, tinf=tinf, tbl=tbl):
                tbl.zero_()
                return (tbl, *kernel(tag, keys, pay, table, tinf, tbl))

            label = f"{body} {tag} L={keys.shape[0]} V={V} over {wn} x {nb} buckets, random"
            scan_tags[label] = tag
            cases.append((label, scan))
    for tag in ("fq", "fq2") if "K4c" in kernels else ():
        keys, pay, table, tinf, n_seg = planted_stream(tag, dev)
        tbl = torch.zeros((3 * cuda_msm.rows_for(tag), n_seg), dtype=torch.int32, device=dev)

        def scan(tag=tag, keys=keys, pay=pay, table=table, tinf=tinf, tbl=tbl):
            tbl.zero_()
            return (tbl, *cuda_msm.window_scan_complete(tag, keys, pay, table, tinf, tbl))

        label = f"K4c window_scan_complete {tag} L={keys.shape[0]} V={keys.shape[1]} over {n_seg} buckets, planted"
        scan_tags[label] = tag
        cases.append((label, scan))
    k6_tables = {}
    for tag, wn, nb in (("fq", 16, 32769), ("fq", 22, 2049), ("fq2", 22, 2049)):
        if "K6" not in kernels:
            break
        R = cuda_msm.rows_for(tag)
        k6_tables[(tag, wn, nb)] = bucket_planes(tag, *tables[tag], wn * nb, gen).reshape(3 * R, wn, nb).contiguous()
        cases.append((f"K6 weighted_bucket_total {tag} Wn={wn} NB={nb}",
                      lambda tag=tag, t=k6_tables[(tag, wn, nb)]: cuda_msm.weighted_bucket_total(tag, t)))
    for tag, wn, c in (("fq", 22, 12), ("fq2", 22, 12), ("fq", 16, 16)):
        if "K7" not in kernels:
            break
        R = cuda_msm.rows_for(tag)
        wins = bucket_planes(tag, *tables[tag], wn, gen).reshape(3 * R, wn).contiguous()
        cases.append((f"K7 horner_total {tag} Wn={wn} c={c}",
                      lambda tag=tag, w=wins, c=c: cuda_msm.horner_total(tag, w, c)))
    merges = []
    if "K5" in kernels:
        merges = [(tag, m, n_seg, *merge_inputs(tag, m, tables[tag], gen)) for tag, m, n_seg in
                  (("fq", 1 << 16, 22 * 2049), ("fq", 67_584, 16 * 32769), ("fq2", 1 << 16, 22 * 2049))]
    for tag, m, n_seg, keys, pts in merges:
        tbl = torch.zeros((3 * cuda_msm.rows_for(tag), n_seg), dtype=torch.int32, device=dev)

        def merge(tag=tag, keys=keys, pts=pts, tbl=tbl):
            tbl.zero_()
            cuda_msm.boundary_merge(tag, keys, pts, tbl)
            return tbl

        cases.append((f"K5 boundary_merge {tag} m={m}", merge))

    if "K9" in kernels:
        shape = testgen.KEYLESS_SHAPE
        n_rows = 2 << shape["domain_pow"]
        lengths = np.bincount(np.random.default_rng(9).integers(0, n_rows, shape["n_coefs"]), minlength=n_rows)
        ab_table = testgen.coef_table_of_lengths(lengths, shape["n_vars"], 9, dev)
        ab_w = testgen.witness_near_r(shape["n_vars"], 10, dev)
        cases.append((f"K9 eval_ab keyless shape, {shape['n_coefs']} entries over {n_rows} rows",
                      lambda: cuda_eval_ab.eval_ab(ab_w, ab_table)))

    ok = set(libs) == set(names)
    results: dict = {}
    try:
        for label, fn in cases:
            use("shipped")
            out = fn()
            want = [t.clone() for t in (out if isinstance(out, tuple) else (out,))]
            names = [name for name in libs if concerns(name, label)]
            for name in names:
                use(name)
                out = fn()
                got = out if isinstance(out, tuple) else (out,)
                use("shipped")  # the comparison's field products
                if name in LAW_VARIANTS and label in scan_tags:
                    equal = same_scan(scan_tags[label], got, want)
                    log(f"{label}: {name} the same points as shipped: {equal}")
                else:
                    equal = all(torch.equal(g, w) for g, w in zip(got, want))
                    log(f"{label}: {name} equal to shipped: {equal}")
                ok &= equal
            order = names + names[::-1]
            for name in order:
                use(name)
                ms = cuda_ms(fn)
                results.setdefault(label, {}).setdefault(name, []).append(round(ms, 4))
                log(f"{label}: {name} {ms:.3f} ms")
        use("shipped")
        for (tag, wn, nb), t in k6_tables.items():
            for lanes in (256, 512, 1024, 2048, 4096):
                if wn * lanes > 1 << 17 or nb // lanes < 2:
                    continue
                cuda_msm._BUCKET_LANES, cuda_msm._MIN_BUCKETS_PER_LANE = wn * lanes, 1
                assert cuda_msm.bucket_threads(tag, wn, nb) == lanes
                ms = cuda_ms(lambda: cuda_msm.weighted_bucket_total(tag, t))
                results.setdefault(f"K6 {tag} Wn={wn} NB={nb} by lanes per window", {})[lanes] = round(ms, 4)
                log(f"K6 {tag} Wn={wn} NB={nb}: {lanes} lanes per window {ms:.3f} ms (shipped)")
        for tag, m, n_seg, keys, pts in merges:
            tbl = torch.zeros((3 * cuda_msm.rows_for(tag), n_seg), dtype=torch.int32, device=dev)
            want = None
            for tile in (128, 256, 512) if tag == "fq" else (64, 128, 256):
                cuda_msm._MERGE_TILE[tag] = tile
                tbl.zero_()
                cuda_msm.boundary_merge(tag, keys, pts, tbl)
                want = tbl.clone() if want is None else want
                equal = torch.equal(tbl, want)
                ok &= equal
                ms = cuda_ms(lambda: cuda_msm.boundary_merge(tag, keys, pts, tbl))
                results.setdefault(f"K5 {tag} m={m} by tile", {})[tile] = round(ms, 4)
                log(f"K5 {tag} m={m}: tiles of {tile}, {len(cuda_msm.merge_levels(m, tile))} launches, "
                    f"{ms:.3f} ms, table equal to the first tile's: {equal} (shipped)")
            cuda_msm._MERGE_TILE[tag] = merge_tiles[tag]
    finally:
        _build.library = shipped_library
        cuda_msm._BUCKET_LANES, cuda_msm._MIN_BUCKETS_PER_LANE = k6_budget
        cuda_msm._MERGE_TILE.update(merge_tiles)
    log(f"total {time.perf_counter() - t0:.1f} s")
    log(card)
    print(json.dumps({"ok": ok, "card": card, "ms": results}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
