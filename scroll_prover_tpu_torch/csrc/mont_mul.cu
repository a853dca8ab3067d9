// K1: elementwise Montgomery product over Fr or Fq (modulus passed in).
//
// Replaces the JAX package's ops/ntt_tile.py `_mul_kernel` (called through `lm_mul`):
// the four-step twiddle multiply, the n^-1 scale and every field_ops.mont_mul
// on a CUDA tensor. One thread per element, grid-stride. Operands are
// addressed as base + e * elem_stride + l * limb_stride, so one kernel serves
// limb-major (16, N) planes, row-major (..., 16) columns, and a scalar
// broadcast over a column (elem_stride 0) without materializing it.
//
// Bound on the H100: bytes. Each product moves 3 x 64 B of int32-held limbs
// and does ~2 x 64 32-bit multiply-adds, well under the card's integer rate
// per byte; the design keeps one pass over memory and no temporaries.
#include "bn254.cuh"

__global__ void __launch_bounds__(256) k1_mont_mul(
    int32_t* __restrict__ out, const int32_t* __restrict__ a, const int32_t* __restrict__ b,
    long long n, long long a_es, long long a_ls, long long b_es, long long b_ls,
    long long o_es, long long o_ls, FieldParams fp) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n; e += stride) {
    Fe x = load_fe(a + e * a_es, a_ls);
    Fe y = load_fe(b + e * b_es, b_ls);
    store_fe(out + e * o_es, o_ls, mont_mul(x, y, fp));
  }
}

extern "C" int spt_mont_mul(int32_t* out, const int32_t* a, const int32_t* b, long long n,
                            long long a_es, long long a_ls, long long b_es, long long b_ls,
                            long long o_es, long long o_ls, FieldParams fp, void* stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  k1_mont_mul<<<grid_for(blocks * threads, threads), threads, 0, (cudaStream_t)stream>>>(
      out, a, b, n, a_es, a_ls, b_es, b_ls, o_es, o_ls, fp);
  return (int)cudaGetLastError();
}
