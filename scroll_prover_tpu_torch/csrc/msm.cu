// K3 and K4: Pippenger bucket accumulation and bucket reduction over G1.
//
// K3 replaces the JAX package's ops/msm_tile.py `_msm_accum_kernel` (called through
// `_accum_v2`); K4 replaces `_lane_reduce_kernel` (called through `_lane_reduce_v2`).
//
// K3: thread (cw, s) — cw a (column, window) pair, s one of S slices — walks
// points i = s, s + S, ..., s + (P-1)S (neighbouring threads read
// neighbouring points, so the limb-plane loads coalesce) and mixed-adds each
// point, y negated when the signed digit's sign is set, into its own bucket
// |digit| (1..32; digit 0 is skipped, as the TPU kernel discarded bucket 0).
// The thread's 32 buckets are 3 KiB of 32-bit words in device memory, read
// and written 96 B at a time. Blocks run in no order, so nothing is carried
// between them; K4 sums the slices.
// K4: one halving round per launch; thread (cw, j) adds slice point j and
// j + S/2 (complete projective add). log2(S) launches leave one bucket
// table per cw.
//
// Layout: px, py (16, n) limb planes; digits, signs (CW, n) int32; buckets
// (CW, S, 32, 3, 8) int32 words.
//
// Bound on the H100: operations. Each point costs one mixed add (11
// Montgomery products) per window against 96 B of bucket read + write; the
// slices (P = 256 points) keep ~CW x n/256 threads in flight.
#include "bn254.cuh"

constexpr int NB = 32;        // buckets 1..32 for signed 6-bit digits
constexpr int PT_WORDS = 24;  // X, Y, Z as 8 words each

__global__ void __launch_bounds__(128) k3_msm_accum(
    int32_t* __restrict__ buckets, const int32_t* __restrict__ px, const int32_t* __restrict__ py,
    const int32_t* __restrict__ digs, const int32_t* __restrict__ signs, long long n,
    long long CW, long long S, long long P, CurveParams cv) {
  long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= CW * S) return;
  long long cw = g / S, s = g % S;
  int32_t* mine = buckets + g * (NB * PT_WORDS);
  const Pt ident = pt_identity(cv);
  for (int b = 0; b < NB; ++b) {
    store_words(mine + b * PT_WORDS, ident.x);
    store_words(mine + b * PT_WORDS + 8, ident.y);
    store_words(mine + b * PT_WORDS + 16, ident.z);
  }
  const int32_t* dg = digs + cw * n;
  const int32_t* sg = signs + cw * n;
  for (long long t = 0; t < P; ++t) {
    long long i = s + S * t;
    if (i >= n) break;
    int d = dg[i];
    if (d == 0) continue;
    Fe qx = load_fe(px + i, n);
    Fe qy = load_fe(py + i, n);
    if (sg[i]) qy = neg_mod(qy, cv.fq);
    int32_t* bk = mine + (d - 1) * PT_WORDS;
    Pt cur;
    cur.x = load_words(bk);
    cur.y = load_words(bk + 8);
    cur.z = load_words(bk + 16);
    Pt nxt = madd(cur, qx, qy, cv);
    store_words(bk, nxt.x);
    store_words(bk + 8, nxt.y);
    store_words(bk + 16, nxt.z);
  }
}

__global__ void __launch_bounds__(128) k4_msm_reduce(
    int32_t* __restrict__ out, const int32_t* __restrict__ in, long long CW, long long HN,
    CurveParams cv) {
  long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= CW * HN) return;
  long long cw = g / HN, j = g % HN;
  const int32_t* a = in + (cw * 2 * HN + j) * PT_WORDS;
  const int32_t* b = a + HN * PT_WORDS;
  Pt p, q;
  p.x = load_words(a);
  p.y = load_words(a + 8);
  p.z = load_words(a + 16);
  q.x = load_words(b);
  q.y = load_words(b + 8);
  q.z = load_words(b + 16);
  Pt r = padd(p, q, cv);
  int32_t* o = out + g * PT_WORDS;
  store_words(o, r.x);
  store_words(o + 8, r.y);
  store_words(o + 16, r.z);
}

extern "C" int spt_msm_accum(int32_t* buckets, const int32_t* px, const int32_t* py,
                             const int32_t* digs, const int32_t* signs, long long n, long long CW,
                             long long S, long long P, CurveParams cv, void* stream) {
  const int threads = 128;
  k3_msm_accum<<<grid_for(CW * S, threads), threads, 0, (cudaStream_t)stream>>>(
      buckets, px, py, digs, signs, n, CW, S, P, cv);
  return (int)cudaGetLastError();
}

extern "C" int spt_msm_reduce(int32_t* out, const int32_t* in, long long CW, long long HN,
                              CurveParams cv, void* stream) {
  const int threads = 128;
  k4_msm_reduce<<<grid_for(CW * HN, threads), threads, 0, (cudaStream_t)stream>>>(
      out, in, CW, HN, cv);
  return (int)cudaGetLastError();
}
