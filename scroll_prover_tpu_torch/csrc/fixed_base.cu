// K5: fixed-base s_i * G over 64 windows of 4 bits from an affine table.
//
// Replaces the JAX package's ops/fixed_base.py `_fb_kernel` (called through
// `_accumulate_tile`). One thread per scalar walks the 64 windows: one
// complete mixed add (RCB15 alg. 8) of table[w][digit] per non-zero digit, a
// zero digit keeps the accumulator. The (64, 16, 2) affine table is 64 KiB as
// 32-bit words and sits in shared memory (dynamic, above the 48 KiB default).
//
// Layout: table (64, 16, 2, 16) int32 limbs, digits (64, n) int32 (coalesced
// per window), out (3, n, 16) projective X, Y, Z limbs.
//
// Bound on the H100: operations. Per scalar ~60 mixed adds of 11 Montgomery
// products each against 64 x 4 B of digits and 3 x 64 B of output.
#include "bn254.cuh"

constexpr int FB_WINDOWS = 64;
constexpr int FB_DIGITS = 16;
constexpr size_t FB_SMEM = (size_t)FB_WINDOWS * FB_DIGITS * 2 * sizeof(Fe);

__global__ void __launch_bounds__(256) k5_fixed_base(
    int32_t* __restrict__ out, const int32_t* __restrict__ table,
    const int32_t* __restrict__ digs, long long n, CurveParams cv) {
  extern __shared__ Fe tbl[];  // [w][d][coord]
  for (int e = threadIdx.x; e < FB_WINDOWS * FB_DIGITS * 2; e += blockDim.x)
    tbl[e] = load_fe(table + (long long)e * 16, 1);
  __syncthreads();
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    Pt acc = pt_identity(cv);
    for (int w = 0; w < FB_WINDOWS; ++w) {
      int d = digs[(long long)w * n + i];
      if (d != 0) {
        const Fe* q = tbl + (w * FB_DIGITS + d) * 2;
        acc = madd(acc, q[0], q[1], cv);
      }
    }
    store_fe(out + i * 16, 1, acc.x);
    store_fe(out + (n + i) * 16, 1, acc.y);
    store_fe(out + (2 * n + i) * 16, 1, acc.z);
  }
}

extern "C" int spt_fixed_base(int32_t* out, const int32_t* table, const int32_t* digs,
                              long long n, CurveParams cv, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(k5_fixed_base, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)FB_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132LL * 8) blocks = 132LL * 8;
  k5_fixed_base<<<grid_for(blocks * threads, threads), threads, FB_SMEM, (cudaStream_t)stream>>>(
      out, table, digs, n, cv);
  return (int)cudaGetLastError();
}
