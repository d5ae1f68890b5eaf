// K5: the segmented sums of the MSM's head/tail boundary sequence, written
// into the bucket table.
//
// Replaces keyless_zk_tpu/ops/pallas_msm.py `boundary_merge`
// (`_build_merge` pallas_call, body `_merge_kernel_body` +
// `_suffix_passes`); its contract is keyless_zk_tpu/ops/msm_sim.py
// `boundary_merge`, whose segment leaders the JAX orchestrator overlays
// into its bucket table. The TPU kernel runs Hillis-Steele passes inside one
// program with a data-derived trip count: log2(longest segment) complete
// adds on every entry. The port's first kernel took the same passes, one
// launch each, after a host sync for their count, and the orchestrator
// overlaid the leaders with a scatter and a second sync. The keyless
// witness makes one segment span nearly the whole sequence (window 0's
// digit-1 bucket), so that was 16 passes of m adds where fewer than m adds
// are needed.
//
// Here the reduction is work-efficient and writes the table itself. A block
// loads a tile of J consecutive entries (keys and limb planes coalesced)
// and reduces it by a segmented halving tree in shared memory: the node
// over [lo, hi) keeps its first segment's partial at lo and its last
// segment's at hi - 1 (one partial if one key spans it, which its keys show,
// as they are sorted). Merging two nodes adds the left's last partial to
// the right's first where their keys agree, and a segment bounded on both
// sides inside the node is complete: its total goes straight into column
// `key` of the table (ids outside [0, n_seg) are never written, and their
// partials are not added). The tile's first and last segments may go on past
// its edges: they go up as (key, partial) pairs, two per tile (the second
// at infinity if one key spans the tile), and the same kernel reduces that
// shorter sequence, until one tile holds it all and writes its first and
// last segments too. Every key's total is written once. At the main path's
// m = 2^16 and J = 256 that is three launches with fewer than m + m / 128
// adds, and no host sync (the launches follow from m alone).
//
// The adds happen in another order than the contract's, so the totals
// agree with it as affine points; ops/cuda_msm.py's plain version runs this
// schedule, bit-equal to the kernel.
//
// Bound on the H100: one complete add per entry whose key equals its
// predecessor's (integer multiply-adds), spread over m / J blocks at the
// first level; the last levels are a few blocks and log2 J dependent adds.

#include <climits>

#include <cuda_runtime.h>

#include "ec.cuh"

using namespace kzk;

namespace {

template <class F>
__device__ __forceinline__ void put_total(int32_t* tbl, long long n_seg, int key, const Jac<F>& p) {
  if (key >= 0 && key < n_seg) store_jac(tbl, n_seg, key, p);
}

}  // namespace

// keys: (n,) sorted; pts: (3R, n). Block b reduces entries [b J, b J + J)
// (J = blockDim.x, a power of two; past n: key INT_MAX, infinity) and
// writes the totals of its complete segments into tbl (3R, n_seg). With
// `final` (one block) it writes its first and last segments too; else it
// writes them to keys_out (2 * gridDim,) and pts_out (3R, 2 * gridDim).
template <class F, int JMAX>
__global__ void __launch_bounds__(JMAX)
merge_tile_kernel(const int32_t* __restrict__ keys, const int32_t* __restrict__ pts, long long n,
                  int32_t* __restrict__ keys_out, int32_t* __restrict__ pts_out, int32_t* __restrict__ tbl,
                  long long n_seg, int final) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int J = blockDim.x;
  Jac<F>* part = reinterpret_cast<Jac<F>*>(smem);
  int* key = reinterpret_cast<int*>(part + J);
  const int j = threadIdx.x;
  const long long i = blockIdx.x * (long long)J + j;
  key[j] = i < n ? keys[i] : INT_MAX;
  part[j] = i < n ? load_jac<F>(pts, n, i) : jac_infinity<F>();
  __syncthreads();
  for (int s = 1; s < J; s <<= 1) {
    const int lo = 2 * s * j;  // thread j merges the node [lo, lo + 2s)
    if (lo < J) {
      const int mid = lo + s, hi = lo + 2 * s - 1;
      const int kl = key[mid - 1], kr = key[mid];
      const bool l_one = key[lo] == kl, r_one = kr == key[hi];
      if (kl == kr) {
        const Jac<F> l_last = part[l_one ? lo : mid - 1];
        const Jac<F> m = kl >= 0 && kl < n_seg ? add_core(l_last, part[mid]) : l_last;
        if (l_one)
          part[lo] = m;  // the node's first segment (all of it if r_one)
        else if (r_one)
          part[hi] = m;  // its last
        else
          put_total(tbl, n_seg, kl, m);  // bounded inside the node
      } else {
        if (!l_one) put_total(tbl, n_seg, kl, part[mid - 1]);
        if (!r_one)
          put_total(tbl, n_seg, kr, part[mid]);
        else
          part[hi] = part[mid];
      }
    }
    __syncthreads();
  }
  if (j != 0) return;
  const int kf = key[0], kl = key[J - 1];
  if (final) {
    put_total(tbl, n_seg, kf, part[0]);
    if (kl != kf) put_total(tbl, n_seg, kl, part[J - 1]);
    return;
  }
  const long long m_out = 2LL * gridDim.x, o = 2LL * blockIdx.x;
  keys_out[o] = kf;
  keys_out[o + 1] = kl;
  store_jac(pts_out, m_out, o, part[0]);
  store_jac(pts_out, m_out, o + 1, kl == kf ? jac_infinity<F>() : part[J - 1]);
}

template <class F, int JMAX>
static int launch_merge(const void* keys, const void* pts, long long n, void* keys_out, void* pts_out, void* tbl,
                        long long n_seg, int J, cudaStream_t s) {
  if (J < 4 || J > JMAX || (J & (J - 1))) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)J * (sizeof(Jac<F>) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(merge_tile_kernel<F, JMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + J - 1) / J;
  merge_tile_kernel<F, JMAX><<<tiles, J, smem, s>>>((const int32_t*)keys, (const int32_t*)pts, n, (int32_t*)keys_out,
                                                    (int32_t*)pts_out, (int32_t*)tbl, n_seg, tiles == 1);
  return (int)cudaGetLastError();
}

// One level: keys (n,) int32, pts (3R, n) int32; tiles of J entries (a
// power of two, 4 <= J <= 512 for G1, 256 for G2); tbl (3R, n_seg) int32,
// updated in place; keys_out (2 T,), pts_out (3R, 2 T) for T = ceil(n / J)
// tiles (unused when T == 1, the last level).
extern "C" int kzk_boundary_merge_level(const void* keys, const void* pts, long long n, void* keys_out,
                                        void* pts_out, void* tbl, long long n_seg, int J, int g2, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (g2) return launch_merge<Fq2, 256>(keys, pts, n, keys_out, pts_out, tbl, n_seg, J, s);
  return launch_merge<Fp<FqMod>, 512>(keys, pts, n, keys_out, pts_out, tbl, n_seg, J, s);
}
