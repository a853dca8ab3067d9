// K6: v1 bucket accumulation with signed 4-bit digits over G1.
//
// Replaces the JAX package's ops/msm_tile.py `_msm_kernel` (called through
// `_msm_buckets_lanes` and `_msm_buckets_lanes_batch`).
//
// The TPU kernel carried a (9, 16, 8, 128) bucket scratch along a sequential
// point-tile grid axis. Hopper blocks run in no fixed order, so the order is
// fixed inside a thread instead: thread (cw, lane), cw a (column, window)
// pair, owns the lane's 8 live buckets (768 B of local memory) and walks
// points i = lane, lane + M, lane + 2M, ... in ascending tile order, one
// RCB15 mixed add per non-zero digit (y negated when the sign is set; digit
// 0 is skipped, so bucket 0 stays the identity). The plain version in
// ops/msm_tile.py adds in the same order, so the per-lane projective table
// matches it limb for limb.
//
// Layout: px, py (16, n) limb planes with n = tiles * M; digits, signs
// (CW, n) int32; out (CW, 9, 3, 16, M) int32 limbs. Neighbouring threads
// take neighbouring lanes of one cw, so point, digit and output accesses
// coalesce; the 64 windows of a column read the same points through L2.
//
// Bound on the H100: operations. Each live digit costs one mixed add (11
// Montgomery products) against 2 x 96 B of bucket traffic in local memory
// and 4 B of digit; the design keeps no bucket in device memory until the
// final store.
#include "bn254.cuh"

constexpr int B4 = 9;       // buckets 0..8; 0 stays the identity
constexpr int LIVE = B4 - 1;

__global__ void __launch_bounds__(128) k6_msm4_lanes(
    int32_t* __restrict__ out, const int32_t* __restrict__ px, const int32_t* __restrict__ py,
    const int32_t* __restrict__ digs, const int32_t* __restrict__ signs, long long n,
    long long CW, long long M, CurveParams cv) {
  long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= CW * M) return;
  long long cw = g / M, lane = g % M;
  const Pt ident = pt_identity(cv);
  Pt bk[LIVE];
#pragma unroll
  for (int b = 0; b < LIVE; ++b) bk[b] = ident;
  const int32_t* dg = digs + cw * n;
  const int32_t* sg = signs + cw * n;
  for (long long i = lane; i < n; i += M) {
    int d = dg[i];
    if (d == 0) continue;
    Fe qx = load_fe(px + i, n);
    Fe qy = load_fe(py + i, n);
    if (sg[i]) qy = neg_mod(qy, cv.fq);
    bk[d - 1] = madd(bk[d - 1], qx, qy, cv);
  }
  // out[cw][b][c][l][lane]: limb stride M, coordinate stride 16 M
  int32_t* o = out + cw * (B4 * 3 * 16) * M + lane;
  const long long cs = 16 * M;
  store_fe(o, M, ident.x);
  store_fe(o + cs, M, ident.y);
  store_fe(o + 2 * cs, M, ident.z);
  for (int b = 0; b < LIVE; ++b) {
    int32_t* ob = o + (long long)(b + 1) * 3 * cs;
    store_fe(ob, M, bk[b].x);
    store_fe(ob + cs, M, bk[b].y);
    store_fe(ob + 2 * cs, M, bk[b].z);
  }
}

extern "C" int spt_msm4_lanes(int32_t* out, const int32_t* px, const int32_t* py,
                              const int32_t* digs, const int32_t* signs, long long n, long long CW,
                              long long M, CurveParams cv, void* stream) {
  const int threads = 128;
  k6_msm4_lanes<<<grid_for(CW * M, threads), threads, 0, (cudaStream_t)stream>>>(
      out, px, py, digs, signs, n, CW, M, cv);
  return (int)cudaGetLastError();
}
