// K3 and K4: Pippenger bucket accumulation and the reduction to one point per
// column over G1.
//
// K3 replaces the JAX package's ops/msm_tile.py `_msm_accum_kernel` (called through
// `_accum_v2`); K4 replaces `_lane_reduce_kernel` (called through `_lane_reduce_v2`)
// together with the host fold `_host_fold_mont` that followed it there.
//
// K3 sorts, then accumulates with every bucket in registers; no bucket
// table lives in device memory. Four kernels on one stream, one wrapper call:
//   k3_count    block (cw, tile of K3_TILE points): live points per bucket
//               |digit| (shared-memory counters) -> cnt (CW, 32, tiles);
//   k3_scan     block per cw: exclusive prefix sums of cnt in (bucket, tile)
//               order, in place, and each bucket's run (start, length);
//   k3_scatter  warp per (cw, tile): a stable counting sort, each lane's rank
//               among the lanes of equal digit from __match_any_sync, writes
//               point index | sign << 31 into its bucket's run of perm (CW, n),
//               so every run holds its points in ascending index;
//   k3_msm_accum thread (cw, bucket b, slot u < 4S) keeps one projective
//               bucket in registers and mixed-adds run entries u, u + 4S,
//               u + 8S, ... in order (y negated by the sign): a warp takes 32
//               slots of one run, so its lanes add the same number of points
//               (one apart at most) and read neighbouring run entries. The
//               block then folds slots s, s + S, s + 2S, s + 3S through
//               shared memory into output slot s, two halvings of complete
//               adds: (u_s + u_{s+2S}) + (u_{s+S} + u_{s+3S}).
//               The adds of a thread form one dependent chain, so the kernel
//               wants many short chains: 4S accumulating slots per run, S in
//               the output for K4 (on the H100, four slots per output slot
//               beat one and two, and eight gained nothing).
// Digit 0 lands in no run. Points come from a packed affine table, (n, 2, 8)
// 32-bit words: four 16-byte loads each.
//
// K4 takes K3's (C * W, S, 32) slot table to one projective point per column
// in two kernels, every add a complete one (no branch on the data), in the
// order of its plain version (ops/msm_tile.py `_msm_reduce_plain`):
//   k4_slot_sums    block per (cw, 4 buckets), 32 threads a bucket: thread
//                   s < S/2 loads slots s and s + S/2 with 16-byte loads and
//                   adds them into shared memory, then the block halves in
//                   place (slot s adds slot s + h for h = S/4, ..., 1: the
//                   tree of `_lane_reduce_plain`), each round on its lowest
//                   threads, so the idle ones are whole warps until the last
//                   rounds -> bucket sums (C * W, 32) in a small scratch table;
//   k4_window_fold  block per column: warp per window, lane b holding bucket
//                   b + 1, sum_b b * B_b by two Hillis-Steele scans of five
//                   shuffle steps each (a suffix scan, then a prefix scan:
//                   ops/msm.py `_weighted_windows`), the window sums in shared
//                   memory; then one thread folds them from the most
//                   significant down, c doublings and one add per window
//                   (ops/msm.py `_fold_windows`).
// Of the table only 96 B a column goes back to the host, which converts it
// to affine with one inversion. The slot tree is bound by operations and
// keeps the card busy (CW * 8 blocks of 128 threads); the window scans and
// the fold are dependent chains (10 adds per window, ~300 point operations
// per column) that sit far below any throughput bound, short beside the
// host fold they replace.
//
// Layout: pts (n, 2, 8) words; digits, signs (CW, n) int32; buckets
// (CW, S, 32, 3, 8) int32 words; scratch perm (CW, n), cnt (CW, 32, tiles),
// run (CW, 32, 2) int32; K4's bucket sums (CW, 32, 3, 8) and its output
// (C, 3, 8) words.
//
// Bound on the H100: operations. Each live digit costs one mixed add, whose
// 11 Montgomery products the bound counts exactly (b3 = 9 is multiplied by
// additions); its bytes are 64 B of point, 8 B of digit and sign and 8 B of
// run entry, and a bucket leaves the registers once.
#include "bn254.cuh"

constexpr int NB = 32;          // buckets 1..32 for signed 6-bit digits
constexpr int PT_WORDS = 24;    // X, Y, Z as 8 words each
constexpr int K3_TILE = 4096;   // points per counting-sort tile
constexpr int SCATTER_WARPS = 4;
constexpr int K3_FOLD = 4;         // accumulating slots per output slot, a power of two
constexpr int K3_ACC_BLOCK = 256;  // >= 64 output slots x K3_FOLD: a run never straddles blocks

__global__ void __launch_bounds__(256) k3_count(int* __restrict__ cnt, const int32_t* __restrict__ digs,
                                                long long n, int tiles) {
  __shared__ int h[NB + 1];
  const long long cw = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  if (threadIdx.x <= NB) h[threadIdx.x] = 0;
  __syncthreads();
  const long long lo = (long long)tile * K3_TILE;
  const long long hi = lo + K3_TILE < n ? lo + K3_TILE : n;
  const int32_t* dg = digs + cw * n;
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) atomicAdd(&h[dg[i]], 1);
  __syncthreads();
  if (threadIdx.x < NB) cnt[(cw * NB + threadIdx.x) * tiles + tile] = h[threadIdx.x + 1];
}

__global__ void __launch_bounds__(1024) k3_scan(int* __restrict__ cnt, int* __restrict__ run, int tiles) {
  __shared__ int part[1024];
  const long long cw = blockIdx.x;
  int* c = cnt + cw * NB * tiles;
  const int m = NB * tiles, t = threadIdx.x;
  const int per = (m + blockDim.x - 1) / blockDim.x;
  const int a = t * per < m ? t * per : m;
  const int b = a + per < m ? a + per : m;
  int s = 0;
  for (int j = a; j < b; ++j) s += c[j];
  part[t] = s;
  __syncthreads();
  for (int o = 1; o < (int)blockDim.x; o <<= 1) {  // inclusive scan of the chunk sums
    const int v = t >= o ? part[t - o] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  int acc = part[t] - s;
  for (int j = a; j < b; ++j) {
    const int v = c[j];
    c[j] = acc;
    acc += v;
  }
  __syncthreads();
  if (t < NB) {
    const int start = c[t * tiles];
    const int end = t + 1 < NB ? c[(t + 1) * tiles] : part[blockDim.x - 1];
    run[(cw * NB + t) * 2] = start;
    run[(cw * NB + t) * 2 + 1] = end - start;
  }
}

__global__ void __launch_bounds__(32 * SCATTER_WARPS) k3_scatter(
    int32_t* __restrict__ perm, const int* __restrict__ off, const int32_t* __restrict__ digs,
    const int32_t* __restrict__ signs, long long n, long long CW, int tiles) {
  __shared__ int pos_s[SCATTER_WARPS][NB + 1];
  const unsigned FULL = 0xFFFFFFFFu;
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * SCATTER_WARPS + wid;
  if (item >= CW * tiles) return;  // whole warps leave together
  const long long cw = item / tiles;
  const int tile = (int)(item % tiles);
  int* pos = pos_s[wid];
  pos[lane + 1] = off[(cw * NB + lane) * tiles + tile];
  __syncwarp();
  const long long lo = (long long)tile * K3_TILE;
  const long long hi = lo + K3_TILE < n ? lo + K3_TILE : n;
  const int32_t* dg = digs + cw * n;
  const int32_t* sg = signs + cw * n;
  int32_t* out = perm + cw * n;
  for (long long c = lo; c < hi; c += 32) {
    const long long i = c + lane;
    int d = 0;
    uint32_t e = 0;
    if (i < hi) {
      d = dg[i];
      e = (uint32_t)i | (sg[i] ? 0x80000000u : 0u);
    }
    const unsigned grp = __match_any_sync(FULL, d);
    if (d) out[pos[d] + __popc(grp & ((1u << lane) - 1))] = (int32_t)e;
    __syncwarp();
    if (d && lane == __ffs(grp) - 1) pos[d] += __popc(grp);
    __syncwarp();
  }
}

__global__ void __launch_bounds__(K3_ACC_BLOCK, 2) k3_msm_accum(
    int32_t* __restrict__ buckets, const uint4* __restrict__ pts, const int32_t* __restrict__ perm,
    const int* __restrict__ run, long long n, long long CW, long long S, CurveParams cv) {
  __shared__ uint32_t part[PT_WORDS][K3_ACC_BLOCK];  // word-major: no bank conflicts
  const long long SF = S * K3_FOLD;  // slots of a run; SF divides the block
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = g < CW * NB * SF;
  const long long u = g % SF, cb = g / SF;  // cb = cw * NB + bucket - 1
  Pt acc = pt_identity(cv);
  if (live) {
    const int32_t* r = perm + (cb / NB) * n + run[cb * 2];
    const long long len = run[cb * 2 + 1];
    for (long long j = u; j < len; j += SF) {
      const uint32_t e = (uint32_t)r[j];
      const uint4* q = pts + (long long)(e & 0x7FFFFFFFu) * 4;
      const uint4 x0 = q[0], x1 = q[1], y0 = q[2], y1 = q[3];
      const Fe qx = {{x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w}};
      Fe qy = {{y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w}};
      if (e >> 31) qy = neg_mod(qy, cv.fq);
      acc = madd(acc, qx, qy, cv);
    }
  }
  // fold slots u = s + f S into output slot s by halvings through shared
  // memory, two points live at a time: slot u < h adds slot u + h for
  // h = 2S, S (complete adds), as the plain version does
  Pt sum = acc;
  for (long long h = SF / 2; h >= S; h /= 2) {
    __syncthreads();
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      part[w][threadIdx.x] = sum.x.w[w];
      part[8 + w][threadIdx.x] = sum.y.w[w];
      part[16 + w][threadIdx.x] = sum.z.w[w];
    }
    __syncthreads();
    if (u < h) {
      const int t = threadIdx.x + (int)h;
      Pt other;
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        other.x.w[w] = part[w][t];
        other.y.w[w] = part[8 + w][t];
        other.z.w[w] = part[16 + w][t];
      }
      sum = padd(sum, other, cv);
    }
  }
  if (!live || u >= S) return;
  uint4* o = reinterpret_cast<uint4*>(buckets + (((cb / NB) * S + u) * NB + cb % NB) * PT_WORDS);
  o[0] = make_uint4(sum.x.w[0], sum.x.w[1], sum.x.w[2], sum.x.w[3]);
  o[1] = make_uint4(sum.x.w[4], sum.x.w[5], sum.x.w[6], sum.x.w[7]);
  o[2] = make_uint4(sum.y.w[0], sum.y.w[1], sum.y.w[2], sum.y.w[3]);
  o[3] = make_uint4(sum.y.w[4], sum.y.w[5], sum.y.w[6], sum.y.w[7]);
  o[4] = make_uint4(sum.z.w[0], sum.z.w[1], sum.z.w[2], sum.z.w[3]);
  o[5] = make_uint4(sum.z.w[4], sum.z.w[5], sum.z.w[6], sum.z.w[7]);
}

constexpr int K4_SLOT_BUCKETS = 4;                 // buckets per block of the slot tree
constexpr int K4_SLOT_THREADS = 32 * K4_SLOT_BUCKETS;  // 32 threads a bucket: S / 2 <= 32
constexpr int K4_FOLD_WARPS = 8;                   // windows scanned at once per column
constexpr int K4_MAX_W = 64;                       // windows a column may have (43 for c = 6)

__device__ __forceinline__ Pt load_pt(const int32_t* src) {
  Pt p;
  p.x = load_words(src);
  p.y = load_words(src + 8);
  p.z = load_words(src + 16);
  return p;
}

__device__ __forceinline__ void store_pt(int32_t* dst, const Pt& p) {
  store_words(dst, p.x);
  store_words(dst + 8, p.y);
  store_words(dst + 16, p.z);
}

// point i of a word-major shared table of n points (word j at sm[j * n + i]:
// neighbouring points in neighbouring banks)
__device__ __forceinline__ Pt smem_pt(const uint32_t* sm, int n, int i) {
  Pt p;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    p.x.w[j] = sm[j * n + i];
    p.y.w[j] = sm[(8 + j) * n + i];
    p.z.w[j] = sm[(16 + j) * n + i];
  }
  return p;
}

__device__ __forceinline__ void smem_put(uint32_t* sm, int n, int i, const Pt& p) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sm[j * n + i] = p.x.w[j];
    sm[(8 + j) * n + i] = p.y.w[j];
    sm[(16 + j) * n + i] = p.z.w[j];
  }
}

// the point of lane + d (down) or lane - d (up); a lane without one gets its own
__device__ __forceinline__ Pt shfl_pt(const Pt& p, int d, bool down) {
  const unsigned FULL = 0xFFFFFFFFu;
  Pt r;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    r.x.w[j] = down ? __shfl_down_sync(FULL, p.x.w[j], d) : __shfl_up_sync(FULL, p.x.w[j], d);
    r.y.w[j] = down ? __shfl_down_sync(FULL, p.y.w[j], d) : __shfl_up_sync(FULL, p.y.w[j], d);
    r.z.w[j] = down ? __shfl_down_sync(FULL, p.z.w[j], d) : __shfl_up_sync(FULL, p.z.w[j], d);
  }
  return r;
}

// block (cw, K4_SLOT_BUCKETS buckets): thread (bucket bl, s < S/2) loads
// slots s and s + S/2 and adds them into shared memory, then each halving
// h = S/4, ..., 1 runs on the lowest h threads of each bucket, slot s adding
// slot s + h in place (no thread reads a slot another writes in its round)
__global__ void __launch_bounds__(K4_SLOT_THREADS) k4_slot_sums(
    int32_t* __restrict__ sums, const int32_t* __restrict__ tbl, int S, CurveParams cv) {
  __shared__ uint32_t part[PT_WORDS * K4_SLOT_THREADS];  // bucket bl's slot s at bl * 32 + s
  const long long cw = blockIdx.x / (NB / K4_SLOT_BUCKETS);
  const int b0 = (int)(blockIdx.x % (NB / K4_SLOT_BUCKETS)) * K4_SLOT_BUCKETS;
  const int t = threadIdx.x;
  int h = S >> 1;
  const int w1 = h ? h : 1;  // threads a bucket in the first halving
  if (t < w1 * K4_SLOT_BUCKETS) {
    const int bl = t / w1, s = t % w1;
    const int32_t* base = tbl + ((cw * S + s) * NB + b0 + bl) * PT_WORDS;
    Pt v = load_pt(base);
    if (h) v = padd(v, load_pt(base + (long long)h * NB * PT_WORDS), cv);
    smem_put(part, K4_SLOT_THREADS, bl * 32 + s, v);
  }
  for (h >>= 1; h >= 1; h >>= 1) {
    __syncthreads();
    if (t < h * K4_SLOT_BUCKETS) {
      const int i = (t / h) * 32 + t % h;
      smem_put(part, K4_SLOT_THREADS, i,
               padd(smem_pt(part, K4_SLOT_THREADS, i), smem_pt(part, K4_SLOT_THREADS, i + h), cv));
    }
  }
  __syncthreads();
  if (t < K4_SLOT_BUCKETS)
    store_pt(sums + (cw * NB + b0 + t) * PT_WORDS, smem_pt(part, K4_SLOT_THREADS, t * 32));
}

// block per column: warp per window (lane b holding bucket b + 1) scans
// sum_b b * B_b into shared memory, then thread 0 folds the windows
__global__ void __launch_bounds__(32 * K4_FOLD_WARPS) k4_window_fold(
    int32_t* __restrict__ out, const int32_t* __restrict__ sums, int W, int c, CurveParams cv) {
  __shared__ uint32_t win[PT_WORDS * K4_MAX_W];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long col = blockIdx.x;
  for (int w = warp; w < W; w += K4_FOLD_WARPS) {
    Pt v = load_pt(sums + ((col * W + w) * NB + lane) * PT_WORDS);
    for (int s = 1; s < 32; s <<= 1) {  // suffix sums: lane b adds lane b + s
      const Pt t = padd(v, shfl_pt(v, s, true), cv);
      if (lane + s < 32) v = t;
    }
    for (int s = 1; s < 32; s <<= 1) {  // their prefix sums: lane b adds lane b - s
      const Pt t = padd(v, shfl_pt(v, s, false), cv);
      if (lane >= s) v = t;
    }
    if (lane == 31) smem_put(win, K4_MAX_W, w, v);  // sum_b b * B_b
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  Pt acc = pt_identity(cv);
  for (int w = W - 1; w >= 0; --w) {
    for (int i = 0; i < c; ++i) acc = pdbl(acc, cv);
    acc = padd(acc, smem_pt(win, K4_MAX_W, w), cv);
  }
  store_pt(out + col * PT_WORDS, acc);
}

extern "C" int spt_msm_accum(int32_t* buckets, const int32_t* pts, const int32_t* digs,
                             const int32_t* signs, int32_t* perm, int* cnt, int* run, long long n,
                             long long CW, long long S, int tiles, CurveParams cv, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  k3_count<<<(unsigned)(CW * tiles), 256, 0, st>>>(cnt, digs, n, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  k3_scan<<<(unsigned)CW, 1024, 0, st>>>(cnt, run, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  k3_scatter<<<grid_for(CW * tiles * 32, 32 * SCATTER_WARPS), 32 * SCATTER_WARPS, 0, st>>>(
      perm, cnt, digs, signs, n, CW, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  k3_msm_accum<<<grid_for(CW * NB * S * K3_FOLD, K3_ACC_BLOCK), K3_ACC_BLOCK, 0, st>>>(
      buckets, reinterpret_cast<const uint4*>(pts), perm, run, n, CW, S, cv);
  return (int)cudaGetLastError();
}

extern "C" int spt_msm_slot_sums(int32_t* sums, const int32_t* tbl, long long CW, int S, CurveParams cv,
                                 void* stream) {
  if (S < 1 || S > 2 * 32) return (int)cudaErrorInvalidValue;
  k4_slot_sums<<<(unsigned)(CW * (NB / K4_SLOT_BUCKETS)), K4_SLOT_THREADS, 0, (cudaStream_t)stream>>>(
      sums, tbl, S, cv);
  return (int)cudaGetLastError();
}

extern "C" int spt_msm_window_fold(int32_t* out, const int32_t* sums, long long C, int W, int c, CurveParams cv,
                                   void* stream) {
  if (W > K4_MAX_W) return (int)cudaErrorInvalidValue;
  k4_window_fold<<<(unsigned)C, 32 * K4_FOLD_WARPS, 0, (cudaStream_t)stream>>>(out, sums, W, c, cv);
  return (int)cudaGetLastError();
}
