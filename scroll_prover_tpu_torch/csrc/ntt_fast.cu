// K7 and K8: one radix-2 DIF level (K7) or two fused levels (K8, radix 4) of
// a 2^k-point Fr NTT on limb-major (16, n) planes.
//
// K7 replaces the JAX package's ops/ntt_fast.py `_butterfly_kernel` (called
// through `butterfly_t`); K8 replaces `_butterfly4_kernel` (called through
// `butterfly4_t`).
//
// The JAX stage sliced u and w out of the (16, blocks, 2, half) view,
// gathered the stage's twiddles into a new plane with jnp.take and stacked
// the two outputs back. Here each kernel reads its operands from the stage's
// view by stride and the twiddle at (j << s) & (n/2 - 1) straight from the
// one (16, n/2) table, and writes its outputs to the positions it read:
// no gather, no stack, one pass over memory per launch.
//
// K7, level s, butterfly j < n/2 (half = n >> (s+1)): block b = j / half,
// jj = j % half, u = x[b][0][jj], w = x[b][1][jj];
//   out[b][0][jj] = u + w, out[b][1][jj] = (u - w) * tw[jj << s].
// K8, levels s and s+1, radix-4 butterfly j < n/4 (q = n >> (s+2)):
// b = j / q, jp = j % q, v_i = x[b][i][jp];
//   s0 = v0 + v2, d0 = (v0 - v2) ta, s1 = v1 + v3, d1 = (v1 - v3) tb,
//   y0 = s0 + s1, y1 = (s0 - s1) tc, y2 = d0 + d1, y3 = (d0 - d1) tc,
// ta = tw[jp << s], tb = tw[(jp + q) << s], tc = tw[jp << (s+1)].
//
// Bound on the H100: bytes. A butterfly moves 64 B per element in and out
// (plus its twiddles) for one Montgomery product per output pair, far below
// the card's integer rate per byte.
#include "bn254.cuh"

__global__ void __launch_bounds__(256) k7_butterfly(
    int32_t* __restrict__ out, const int32_t* __restrict__ x, const int32_t* __restrict__ tw,
    int k, int s, FieldParams fp) {
  const long long n = 1LL << k, nh = n >> 1;
  const int hb = k - s - 1;  // log2(half)
  const long long half_mask = (1LL << hb) - 1;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < nh; j += stride) {
    const long long jj = j & half_mask;
    const long long iu = ((j >> hb) << (hb + 1)) + jj;
    const long long iw = iu + (1LL << hb);
    Fe u = load_fe(x + iu, n);
    Fe w = load_fe(x + iw, n);
    Fe t = load_fe(tw + ((jj << s) & (nh - 1)), nh);
    store_fe(out + iu, n, add_mod(u, w, fp));
    store_fe(out + iw, n, mont_mul(sub_mod(u, w, fp), t, fp));
  }
}

__global__ void __launch_bounds__(256) k8_butterfly4(
    int32_t* __restrict__ out, const int32_t* __restrict__ x, const int32_t* __restrict__ tw,
    int k, int s, FieldParams fp) {
  const long long n = 1LL << k, nh = n >> 1, nq = n >> 2;
  const int qb = k - s - 2;  // log2(q)
  const long long q = 1LL << qb;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < nq; j += stride) {
    const long long jp = j & (q - 1);
    const long long i0 = ((j >> qb) << (qb + 2)) + jp;
    Fe v0 = load_fe(x + i0, n);
    Fe v1 = load_fe(x + i0 + q, n);
    Fe v2 = load_fe(x + i0 + 2 * q, n);
    Fe v3 = load_fe(x + i0 + 3 * q, n);
    Fe ta = load_fe(tw + ((jp << s) & (nh - 1)), nh);
    Fe tb = load_fe(tw + (((jp + q) << s) & (nh - 1)), nh);
    Fe tc = load_fe(tw + ((jp << (s + 1)) & (nh - 1)), nh);
    Fe s0 = add_mod(v0, v2, fp);
    Fe d0 = mont_mul(sub_mod(v0, v2, fp), ta, fp);
    Fe s1 = add_mod(v1, v3, fp);
    Fe d1 = mont_mul(sub_mod(v1, v3, fp), tb, fp);
    store_fe(out + i0, n, add_mod(s0, s1, fp));
    store_fe(out + i0 + q, n, mont_mul(sub_mod(s0, s1, fp), tc, fp));
    store_fe(out + i0 + 2 * q, n, add_mod(d0, d1, fp));
    store_fe(out + i0 + 3 * q, n, mont_mul(sub_mod(d0, d1, fp), tc, fp));
  }
}

static inline unsigned ntt_grid(long long work, int threads) {
  long long blocks = (work + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  return grid_for(blocks * threads, threads);
}

extern "C" int spt_butterfly(int32_t* out, const int32_t* x, const int32_t* tw, int k, int s,
                             FieldParams fp, void* stream) {
  if (k < 1 || s < 0 || s >= k) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  k7_butterfly<<<ntt_grid(1LL << (k - 1), threads), threads, 0, (cudaStream_t)stream>>>(
      out, x, tw, k, s, fp);
  return (int)cudaGetLastError();
}

extern "C" int spt_butterfly4(int32_t* out, const int32_t* x, const int32_t* tw, int k, int s,
                              FieldParams fp, void* stream) {
  if (k < 2 || s < 0 || s + 1 >= k) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  k8_butterfly4<<<ntt_grid(1LL << (k - 2), threads), threads, 0, (cudaStream_t)stream>>>(
      out, x, tw, k, s, fp);
  return (int)cudaGetLastError();
}
