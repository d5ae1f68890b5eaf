// K3: batched complete group-law ops -- mixed add, doubling and full add --
// on G1 (Fq) and G2 (Fq2) point batches.
//
// Replaces keyless_zk_tpu/ops/pallas_curve.py `madd_pallas`, `dbl_pallas`
// and `add_pallas` (one `_build` pallas_call with three bodies), whose only
// caller is key setup's fixed-base ladder (circuits/setup.py). The TPU
// kernels relayout every coordinate to limb-major (R, tiles, 8, 128) blocks
// padded to 1024 points so that each field op fills the vector registers.
// Here one thread owns one point: it reads its coordinates straight from
// the port's (n, 16) / (n, 2, 16) int32 rows (64 or 128 contiguous bytes),
// runs the group law in 32-bit words in registers (ec.cuh) and writes the
// result rows; nothing is relaid or padded.
//
// The mixed add is the complete one (ec.cuh `madd_complete`: infinity on
// either side, P == Q by the affine doubling, P == -Q), unlike K4's scan,
// which skips P == Q. The mixed add's affine operand may be one point for
// the whole batch (nq == 1), as the setup's generator is.
//
// Bound on the H100: integer multiply-adds. A G1 doubling is 7 Montgomery
// products and a mixed add 11 (G2: three Fq products each) against 384
// bytes (G1) or 768 bytes (G2) of points in and out, so the kernels are
// ALU-bound; the design keeps every intermediate in registers and touches
// each input and output row once.

#include <cuda_runtime.h>

#include "ec.cuh"

using namespace kzk;

namespace {

template <class F>
__device__ __forceinline__ Jac<F> load_point(const int32_t* x, const int32_t* y, const int32_t* z, long long i) {
  constexpr int R = Field<F>::rows;
  return {Field<F>::load(x + i * R, 1), Field<F>::load(y + i * R, 1), Field<F>::load(z + i * R, 1)};
}

template <class F>
__device__ __forceinline__ void store_point(int32_t* x, int32_t* y, int32_t* z, long long i, const Jac<F>& p) {
  constexpr int R = Field<F>::rows;
  Field<F>::store(x + i * R, 1, p.x);
  Field<F>::store(y + i * R, 1, p.y);
  Field<F>::store(z + i * R, 1, p.z);
}

template <class F>
__global__ void __launch_bounds__(128)
madd_kernel(const int32_t* __restrict__ ax, const int32_t* __restrict__ ay, const int32_t* __restrict__ az,
            const int32_t* __restrict__ qx, const int32_t* __restrict__ qy, const uint8_t* __restrict__ qinf,
            int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long n,
            long long nq) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  constexpr int R = Field<F>::rows;
  long long iq = nq == 1 ? 0 : i;
  Jac<F> r = madd_complete(load_point<F>(ax, ay, az, i), Field<F>::load(qx + iq * R, 1),
                           Field<F>::load(qy + iq * R, 1), qinf[iq] != 0);
  store_point<F>(ox, oy, oz, i, r);
}

template <class F>
__global__ void __launch_bounds__(128)
dbl_kernel(const int32_t* __restrict__ ax, const int32_t* __restrict__ ay, const int32_t* __restrict__ az,
           int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  store_point<F>(ox, oy, oz, i, dbl_core(load_point<F>(ax, ay, az, i)));
}

template <class F>
__global__ void __launch_bounds__(128)
add_kernel(const int32_t* __restrict__ ax, const int32_t* __restrict__ ay, const int32_t* __restrict__ az,
           const int32_t* __restrict__ bx, const int32_t* __restrict__ by, const int32_t* __restrict__ bz,
           int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  store_point<F>(ox, oy, oz, i, add_core(load_point<F>(ax, ay, az, i), load_point<F>(bx, by, bz, i)));
}

constexpr int THREADS = 128;

long long blocks_for(long long n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

// Coordinates are contiguous (n, R) int32 rows, R = 16 (G1) or 32 (G2:
// c0 limbs then c1 limbs); g2 selects the field. q rows and qinf repeat
// over the batch when nq == 1.
extern "C" int kzk_curve_madd(const void* ax, const void* ay, const void* az, const void* qx, const void* qy,
                              const void* qinf, void* ox, void* oy, void* oz, long long n, long long nq, int g2,
                              void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  auto a = [](const void* p) { return (const int32_t*)p; };
  auto o = [](void* p) { return (int32_t*)p; };
  if (g2)
    madd_kernel<Fq2><<<blocks_for(n), THREADS, 0, s>>>(a(ax), a(ay), a(az), a(qx), a(qy), (const uint8_t*)qinf,
                                                        o(ox), o(oy), o(oz), n, nq);
  else
    madd_kernel<Fp<FqMod>><<<blocks_for(n), THREADS, 0, s>>>(a(ax), a(ay), a(az), a(qx), a(qy),
                                                              (const uint8_t*)qinf, o(ox), o(oy), o(oz), n, nq);
  return (int)cudaGetLastError();
}

extern "C" int kzk_curve_dbl(const void* ax, const void* ay, const void* az, void* ox, void* oy, void* oz,
                             long long n, int g2, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  auto a = [](const void* p) { return (const int32_t*)p; };
  auto o = [](void* p) { return (int32_t*)p; };
  if (g2)
    dbl_kernel<Fq2><<<blocks_for(n), THREADS, 0, s>>>(a(ax), a(ay), a(az), o(ox), o(oy), o(oz), n);
  else
    dbl_kernel<Fp<FqMod>><<<blocks_for(n), THREADS, 0, s>>>(a(ax), a(ay), a(az), o(ox), o(oy), o(oz), n);
  return (int)cudaGetLastError();
}

extern "C" int kzk_curve_add(const void* ax, const void* ay, const void* az, const void* bx, const void* by,
                             const void* bz, void* ox, void* oy, void* oz, long long n, int g2, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  auto a = [](const void* p) { return (const int32_t*)p; };
  auto o = [](void* p) { return (int32_t*)p; };
  if (g2)
    add_kernel<Fq2><<<blocks_for(n), THREADS, 0, s>>>(a(ax), a(ay), a(az), a(bx), a(by), a(bz), o(ox), o(oy),
                                                       o(oz), n);
  else
    add_kernel<Fp<FqMod>><<<blocks_for(n), THREADS, 0, s>>>(a(ax), a(ay), a(az), a(bx), a(by), a(bz), o(ox),
                                                             o(oy), o(oz), n);
  return (int)cudaGetLastError();
}
