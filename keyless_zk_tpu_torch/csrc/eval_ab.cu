// K9: the coefficient evaluation (eval_ab) of the h scalars,
// out[row] = sum over the row's coefficient entries of w[src] * c * R^-1
// mod r, for the 2 * domain rows of the a|b vectors.
//
// Replaces no Pallas kernel: the JAX package evaluates the table in XLA
// (keyless_zk_tpu/groth16/prover.py `_eval_ab_fused`: per 2^22-entry
// chunk a product, an 8-bit split, a cumsum and two boundary gathers). Its
// port in plain PyTorch (ops/cuda_eval_ab.py `eval_ab_plain`) ran that in
// 11 chunks of int64 scans, ~310 ms a proof on the H100, the card's largest
// cost in a proof; this kernel reads each entry once instead.
//
// Layout (ops/cuda_eval_ab.py `CoefTable`): the entries sorted by row,
// `row_ptr` (n_rows + 1 offsets), `src` (int32 witness rows) and `val` (the
// coefficient times R mod r as 8 little-endian 32-bit words, 32 bytes).
//
// Work split: merge path over the row ends and the entries (Merrill and
// Garland's SpMV). The n_rows + nnz items are cut into equal shares of
// `items` per thread (3, ops/cuda_eval_ab.py ITEMS_PER_THREAD), whatever
// the rows' lengths: `part_row` holds the row each thread starts in
// (computed once, from row_ptr). A thread consumes an entry while its
// index is below the current row's end, else the row's end, where it
// writes the row. The row in progress at a thread's end is its carry: runs
// of equal carry rows inside a block are summed in shared memory and added
// to the row where a later thread of the block wrote it; the block's last
// run becomes the block's carry, and a second kernel adds runs of block
// carries into their rows, a warp to a run. Every row, empty ones
// included, is written by the thread that consumes its end, and every sum
// is exact mod r, so any order gives the same limbs.
//
// Arithmetic (`AccProduct`): the witness is packed once into 8-word rows
// times R^-1 (a product by the standard one), so that each entry is one
// Montgomery product (field.cuh `mul`, CIOS in carry chains), w R^-1 * cR
// * R^-1 = w c R^-1, and a modular add into the thread's sum. The product's
// operands are loaded one entry ahead of it. The other design, the row's
// unreduced double-width sum reduced once per row, is
// tools/kernel_variants.py `ab_wide`: on the H100 its best share (8 items)
// took 2.83 ms on the keyless shape against 1.98 ms for this one at 3
// (PERF.md).
//
// Bound on the H100: max(bytes / 3.35 TB/s, 32-bit multiply-adds / 16.7
// T/s), bytes = 36 per entry (index and value, streamed once) + the
// witness in (64 per row) + the output (64 per row) + row_ptr and
// part_row; multiply-adds = 264 per entry and per witness row (one CIOS
// product each). At the keyless table's 42.7M entries that is ~1.9 GB
// against 11.6 G multiply-adds: the products bound it (0.70 ms against
// ~0.6 ms of bytes). What the design does about it: one product per entry
// and none per row, no int64 and no second pass over the entries, small
// shares so that many threads have loads in flight; the table streams in
// with cache-streaming loads, so that the packed witness (44 MB at the
// keyless width) stays in the 50 MB L2 for the gathers.

#include <climits>
#include <cuda_runtime.h>

#include "field.cuh"

using namespace kzk;

namespace {

constexpr int kThreads = 128;  // threads per block of the merge-path kernel

using Fr = Fp<FrMod>;

// 8 words from two 16-byte vectors
__device__ __forceinline__ Fr load_words(const uint4* p) {
  const uint4 a = p[0], b = p[1];
  return {{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}

// the same, streamed: read once, evicted first
__device__ __forceinline__ Fr load_words_stream(const uint4* p) {
  const uint4 a = __ldcs(p), b = __ldcs(p + 1);
  return {{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}

__device__ __forceinline__ void store_words(uint4* p, const Fr& a) {
  p[0] = make_uint4(a.v[0], a.v[1], a.v[2], a.v[3]);
  p[1] = make_uint4(a.v[4], a.v[5], a.v[6], a.v[7]);
}

// A Montgomery product per entry, a modular add into the row's sum.
struct AccProduct {
  Fr s;
  // the witness row as the products take it: w * R^-1 mod r
  __device__ __forceinline__ static Fr prep(const Fr& w) {
    Fr one = fp_zero<FrMod>();
    one.v[0] = 1;
    return mul(w, one);
  }
  __device__ __forceinline__ void clear() { s = fp_zero<FrMod>(); }
  __device__ __forceinline__ void add_entry(const Fr& x, const Fr& c) { s = add(s, mul(x, c)); }
  __device__ __forceinline__ Fr value() const { return s; }
};

using EvalAcc = AccProduct;

// w: (n, 16) int32 limbs -> wpk: (n, 8) words, EvalAcc::prep of each row
__global__ void eval_ab_pack_kernel(const int4* __restrict__ w, uint4* __restrict__ wpk, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  store_words(wpk + 2 * i, EvalAcc::prep(load_row<FrMod>(w + 4 * i)));
}

__global__ void __launch_bounds__(kThreads)
eval_ab_kernel(const uint4* __restrict__ wpk, const int* __restrict__ src, const uint4* __restrict__ val,
               const int* __restrict__ row_ptr, const int* __restrict__ part_row, int n_rows, long long total,
               int items, int4* __restrict__ out, int* __restrict__ carry_row, uint4* __restrict__ carry_val) {
  __shared__ int s_row[kThreads];
  __shared__ Fr s_val[kThreads];
  const int j = threadIdx.x;
  const long long d0 = (blockIdx.x * (long long)kThreads + j) * items;
  int r = n_rows;  // the row in progress at the thread's end (n_rows: none)
  EvalAcc acc;
  acc.clear();
  if (d0 < total) {
    r = part_row[blockIdx.x * kThreads + j];
    long long e = d0 - r;
    const long long d1 = d0 + items < total ? d0 + items : total;
    // the thread consumes at most d1 - d0 of the entries from e on
    const long long e_lim = e + (d1 - d0) < total - n_rows ? e + (d1 - d0) : total - n_rows;
    int row_end = r < n_rows ? row_ptr[r + 1] : INT_MAX;
    // the operands of entry e, and the witness row of entry e + 1, loaded
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
      } else {
        store_row(out + 4 * (long long)r, acc.value());
        acc.clear();
        r++;
        row_end = r < n_rows ? row_ptr[r + 1] : INT_MAX;
      }
    }
  }
  s_row[j] = r;
  s_val[j] = acc.value();
  __syncthreads();
  // one thread per run of equal carry rows sums the run
  if (r < n_rows && (j == 0 || s_row[j - 1] != r)) {
    Fr sum = s_val[j];
    int k = j + 1;
    for (; k < kThreads && s_row[k] == r; k++) sum = add(sum, s_val[k]);
    if (k < kThreads) {  // thread k consumed the row's end and wrote it
      int4* row = out + 4 * (long long)r;
      store_row(row, add(load_row<FrMod>(row), sum));
    } else {
      carry_row[blockIdx.x] = r;
      store_words(carry_val + 2 * (long long)blockIdx.x, sum);
    }
  }
  if (j == kThreads - 1 && r >= n_rows) carry_row[blockIdx.x] = n_rows;
}

// out[row] += each run of block carries aimed at it. One warp per 32
// carries: each run that starts among them is summed by the whole warp,
// its lanes striding over the run and then adding across the warp, so a
// row over many blocks costs its run's length / 32 adds in turn.
__global__ void eval_ab_carry_kernel(const int* __restrict__ carry_row, const uint4* __restrict__ carry_val,
                                     int n_blocks, int n_rows, int4* __restrict__ out) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long base = (blockIdx.x * (long long)blockDim.x + threadIdx.x) - lane;
  const long long i = base + lane;
  const int r = i < n_blocks ? carry_row[i] : n_rows;
  unsigned starts = __ballot_sync(kAll, r < n_rows && (i == 0 || carry_row[i - 1] != r));
  while (starts) {
    const int first = __ffs(starts) - 1;
    starts &= starts - 1;
    const int row = __shfl_sync(kAll, r, first);
    Fr sum = fp_zero<FrMod>();
    bool single = true;  // a run of one carry: its sum is lane 0's already
    for (long long k = base + first + lane;; k += 32) {
      const bool in_run = k < n_blocks && carry_row[k] == row;
      if (in_run) sum = add(sum, load_words(carry_val + 2 * k));
      const unsigned in_lanes = __ballot_sync(kAll, in_run);
      if (!in_lanes) break;
      single = single && in_lanes == 1u && k == base + first + lane;
    }
    if (!single) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        Fr other;
#pragma unroll
        for (int w = 0; w < 8; w++) other.v[w] = __shfl_down_sync(kAll, sum.v[w], off);
        sum = add(sum, other);
      }
    }
    if (lane == 0) {
      int4* dst = out + 4 * (long long)row;
      store_row(dst, add(load_row<FrMod>(dst), sum));
    }
  }
}

}  // namespace

// w: (n_vars, 16) int32 standard-form limbs; wpk: (n_vars, 8) int32
// scratch; src: (nnz,) int32; val: (nnz, 8) int32 words; row_ptr:
// (n_rows + 1,) int32; part_row: (n_threads,) int32, n_threads =
// ceil((n_rows + nnz) / items); carry_row: (n_blocks,) int32 and
// carry_val: (n_blocks, 8) int32 scratch, n_blocks = ceil(n_threads /
// threads); out: (n_rows, 16) int32. `threads` must be the kernel's block
// size (the wrapper's count of blocks rests on it).
extern "C" int kzk_eval_ab(const void* w, long long n_vars, void* wpk, const void* src, const void* val,
                           const void* row_ptr, const void* part_row, long long n_rows, long long nnz, int items,
                           int threads, void* carry_row, void* carry_val, void* out, void* stream) {
  if (threads != kThreads || items < 1 || n_rows > INT_MAX || nnz > INT_MAX) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_vars > 0)
    eval_ab_pack_kernel<<<(n_vars + 255) / 256, 256, 0, s>>>((const int4*)w, (uint4*)wpk, n_vars);
  const long long total = n_rows + nnz;
  const long long n_threads = (total + items - 1) / items;
  const long long n_blocks = (n_threads + kThreads - 1) / kThreads;
  eval_ab_kernel<<<n_blocks, kThreads, 0, s>>>((const uint4*)wpk, (const int*)src, (const uint4*)val,
                                                (const int*)row_ptr, (const int*)part_row, (int)n_rows, total,
                                                items, (int4*)out, (int*)carry_row, (uint4*)carry_val);
  eval_ab_carry_kernel<<<(n_blocks + 255) / 256, 256, 0, s>>>((const int*)carry_row, (const uint4*)carry_val,
                                                             (int)n_blocks, (int)n_rows, (int4*)out);
  return (int)cudaGetLastError();
}
