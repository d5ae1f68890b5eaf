// K5: one pass of the segmented suffix sum over the MSM's head/tail
// boundary sequence.
//
// Replaces keyless_zk_tpu/ops/pallas_msm.py `boundary_merge`
// (`_build_merge` pallas_call, body `_merge_kernel_body` +
// `_suffix_passes`); its contract is keyless_zk_tpu/ops/msm_sim.py
// `boundary_merge`. Pass s: out[i] = in[i] + in[i + 2^s] where both carry
// the same bucket key, else in[i] (Hillis-Steele). After enough passes the
// first (leader) entry of each equal-key segment holds the segment total,
// which is all that ops/msm.py reads.
//
// The TPU kernel runs every pass inside one program over VMEM-resident
// blocks, with a data-derived trip count read from SMEM. Hopper has no
// grid-wide barrier between passes in a plain launch, so each pass is one
// launch over ping-pong buffers, and the wrapper reads the pass count to
// the host (one sync per MSM). The adds happen in the same order as the
// contract's, so the totals match it bit for bit.
//
// Bound on the H100: one complete Jacobian add per entry per pass (the
// sequence is 2 * V * n_chunks entries, tens of thousands), so a pass is a
// few microseconds of integer multiplies across the card; loads and stores
// are coalesced limb planes.

#include <cuda_runtime.h>

#include "ec.cuh"

using namespace kzk;

template <class F>
__global__ void __launch_bounds__(128)
merge_pass_kernel(const int32_t* __restrict__ keys, const int32_t* __restrict__ in,
                  int32_t* __restrict__ out, long long m, long long s) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= m) return;
  Jac<F> a = load_jac<F>(in, m, i);
  if (i + s < m && keys[i + s] == keys[i]) a = add_core(a, load_jac<F>(in, m, i + s));
  store_jac(out, m, i, a);
}

// keys: (m,) int32; in, out: (3R, m) int32 point planes; s: the shift 2^pass.
extern "C" int kzk_boundary_merge_pass(const void* keys, const void* in, void* out, long long m,
                                       long long s, int g2, void* stream) {
  if (m == 0) return 0;
  const int threads = 128;
  long long blocks = (m + threads - 1) / threads;
  cudaStream_t st = (cudaStream_t)stream;
  if (g2)
    merge_pass_kernel<Fq2><<<blocks, threads, 0, st>>>((const int32_t*)keys, (const int32_t*)in,
                                                       (int32_t*)out, m, s);
  else
    merge_pass_kernel<Fp<FqMod>><<<blocks, threads, 0, st>>>((const int32_t*)keys, (const int32_t*)in,
                                                             (int32_t*)out, m, s);
  return (int)cudaGetLastError();
}
