// K2: all k <= 8 radix-2 DIF stages of a batched 2^k-point Fr NTT.
//
// Replaces the JAX package's ops/ntt_tile.py `_bntt_kernel` (called through `_bntt`).
// One block per row of m = 2^k elements, held in shared memory as 8 x 32-bit
// words (8 KiB at m = 256, two buffers), m/2 threads. Pease constant
// geometry: every stage pairs v[i] with v[i + m/2] and writes the sum and
// the twiddled difference interleaved, so all stages share one access
// pattern; the output stays bit-reversed, and the per-stage twiddles come
// from the host plan's Pease table (ntt_tile.TiledDomain._twpack), so the
// composed permutation `_stored_perm` still applies.
//
// Layout: in/out (16, B, m) int32 limb planes (limb-major, coalesced along
// the row), twiddles (k, 16, m/2).
//
// Bound on the H100: operations. A row is read and written once (2 x 64 B
// per element) while each element sees k Montgomery products and k add/sub
// pairs in shared memory; nothing touches device memory between stages.
#include "bn254.cuh"

__global__ void __launch_bounds__(128) k2_bntt(
    int32_t* __restrict__ out, const int32_t* __restrict__ in, const int32_t* __restrict__ tw,
    int k, long long B, FieldParams fp) {
  __shared__ Fe buf[2][256];
  const int m = 1 << k, h = m >> 1;
  const int t = threadIdx.x;
  const long long plane = B * (long long)m;
  for (long long row = blockIdx.x; row < B; row += gridDim.x) {
    const int32_t* src = in + row * m;
    buf[0][t] = load_fe(src + t, plane);
    buf[0][t + h] = load_fe(src + t + h, plane);
    __syncthreads();
    int cur = 0;
    for (int s = 0; s < k; ++s) {
      Fe u = buf[cur][t], w = buf[cur][t + h];
      Fe tws = load_fe(tw + (long long)s * 16 * h + t, h);
      Fe sum = add_mod(u, w, fp);
      Fe dif = mont_mul(sub_mod(u, w, fp), tws, fp);
      buf[cur ^ 1][2 * t] = sum;
      buf[cur ^ 1][2 * t + 1] = dif;
      cur ^= 1;
      __syncthreads();
    }
    int32_t* dst = out + row * m;
    store_fe(dst + t, plane, buf[cur][t]);
    store_fe(dst + t + h, plane, buf[cur][t + h]);
    __syncthreads();
  }
}

extern "C" int spt_bntt(int32_t* out, const int32_t* in, const int32_t* tw, int k, long long B,
                        FieldParams fp, void* stream) {
  if (k < 1 || k > 8) return (int)cudaErrorInvalidValue;
  const int threads = 1 << (k - 1);
  long long blocks = B < 0x7FFFFFFFLL ? B : 0x7FFFFFFFLL;
  k2_bntt<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(out, in, tw, k, B, fp);
  return (int)cudaGetLastError();
}
