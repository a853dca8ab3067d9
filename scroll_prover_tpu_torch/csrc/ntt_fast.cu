// K7 and K8: one radix-2 DIF level (K7) or two fused levels (K8, radix 4) of
// a 2^k-point Fr NTT on limb-major (16, n) planes, through tiles in shared
// memory.
//
// K7 replaces the JAX package's ops/ntt_fast.py `_butterfly_kernel` (called
// through `butterfly_t`); K8 replaces `_butterfly4_kernel` (called through
// `butterfly4_t`). Each reads its operands from the stage's view and writes
// its outputs to the positions it read: no gather, no stack, one pass over
// memory per launch.
//
// Twiddles come from per-level tables, limb-major (16, n): level s is
// omega^(jj * 2^s) for jj < n >> (s+1), at columns [n - (n >> s), ...)
// (ops/ntt_fast.py `level_tables`; its first half is the one (16, n/2)
// table, each later level every other entry of the one before; column
// n - 1 is padding). Level s's table is the first period of the plane the
// JAX stage gathers with jnp.take.
//
// K7, level s, butterfly j < n/2 (half = n >> (s+1)): block b = j / half,
// jj = j % half, u = x[b][0][jj], w = x[b][1][jj], t = level s [jj];
//   out[b][0][jj] = u + w, out[b][1][jj] = (u - w) * t.
// K8, levels s and s+1, radix-4 butterfly j < n/4 (q = n >> (s+2)):
// b = j / q, jp = j % q, v_i = x[b][i][jp];
//   s0 = v0 + v2, d0 = (v0 - v2) ta, s1 = v1 + v3, d1 = (v1 - v3) tb,
//   y0 = s0 + s1, y1 = (s0 - s1) tc, y2 = d0 + d1, y3 = (d0 - d1) tc,
// ta = level s [jp], tb = level s [jp + q], tc = level s+1 [jp]
// (= omega^(jp 2^s), omega^((jp + q) 2^s), omega^(jp 2^(s+1))).
//
// Bound on the H100: bytes. A butterfly moves 64 B per element in and out
// (plus its twiddles) for one Montgomery product per output pair, far below
// the card's integer rate per byte.
//
// Design. R = 2 (K7) or 4 (K8) operands per butterfly, h (half or q)
// elements apart. The plane is cut into tiles of E = 2^lg_e elements (2^8
// by default, from the tile sweep in chip_smoke.py: four resident blocks
// of 128 threads per SM), all 16 limb rows: one contiguous run when the
// butterfly's span R h fits in E, else R runs of E / R elements at the
// partner offsets (`kf_pos`). Either way a tile moves in 16-byte copies,
// neighbouring threads on neighbouring addresses of one limb row, so every
// sector is whole at every stride (the thread-per-butterfly kernel this
// replaced loaded 4 bytes a limb, and at h < 8 half of each sector it
// fetched was the partner's). Its twiddles move beside it: a warp reads
// one level's consecutive entries (the one (16, n/2) table it replaced
// was read 2^s entries apart, at s >= 3 a sector for each 4-byte limb,
// which held the middle levels at 26-40% of their bound on an H100).
//
// A block stays resident and walks its tiles through two buffers in
// shared memory: the next tile's copies (cp.async, the plane's marked to
// leave L2 first) are in flight while this tile's radix-2 stages run in
// shared memory and it is stored, with 16-byte stores also marked to
// leave L2 first. K8 is two stages: (v0, v2) and (v1, v3) with ta and tb,
// a barrier, then (s0, s1) and (d0, d1) with tc, so it runs with K7's
// registers. A thread takes butterflies u = tid, tid + T, ...; a warp's
// 32 butterflies at h < 32 would hit each bank R (or 2) times, so element
// e sits at slot e ^ kf_swz(e), which gives operand i of each group of
// butterflies a bank range of its own (bijective, conflict-free at h = 1,
// 2, 4, 8, 16). The XOR keeps groups of four whole except at h = 1 and 2,
// where the landed groups are permuted in place (`kf_unswz`). Outputs go
// back to the slots they came from and the tile leaves as it came.
// ops/ntt_fast.py `_tile_plan` mirrors this index arithmetic, and its
// tests hold it.
#include "bn254.cuh"

#define KF_THREADS 256
#define KF_LG_TILE_MAX 10  // two buffers of 2^10 elements fill an SM's shared memory

struct KfGeom {
  int lg_r, lg_h, lg_e, lg_hl;  // log2 of R, h, E and the tile's local distance
  long long base, jp0;          // the tile's first position, and its first jp
};

// tile t of a launch: one run when whole butterfly blocks fit in E, else
// 2^lg_tpb tiles per butterfly block, R runs each
__device__ __forceinline__ KfGeom kf_geom(int lg_r, int k, int s, int lg_e, long long t) {
  KfGeom g;
  g.lg_r = lg_r;
  g.lg_h = k - s - lg_r;
  g.lg_e = lg_e;
  if (g.lg_h + lg_r <= lg_e) {
    g.lg_hl = g.lg_h;
    g.base = t << lg_e;
    g.jp0 = 0;
  } else {
    g.lg_hl = lg_e - lg_r;
    const int lg_tpb = g.lg_h + lg_r - lg_e;
    g.jp0 = (t & ((1LL << lg_tpb) - 1)) << g.lg_hl;
    g.base = ((t >> lg_tpb) << (g.lg_h + lg_r)) + g.jp0;
  }
  return g;
}

// position in the plane of tile element e: group gg of the tile, operand i,
// offset r
__device__ __forceinline__ long long kf_pos(const KfGeom& g, int e) {
  const int gg = e >> (g.lg_hl + g.lg_r), i = (e >> g.lg_hl) & ((1 << g.lg_r) - 1);
  const int r = e & ((1 << g.lg_hl) - 1);
  return g.base + ((long long)gg << (g.lg_h + g.lg_r)) + ((long long)i << g.lg_h) + r;
}

// the XOR that places tile element e in shared memory (slot e ^ kf_swz(e)):
// a multiple of the local distance, taken from bits above those it changes
__device__ __forceinline__ int kf_swz(const KfGeom& g, int e) {
  if (g.lg_hl >= 5) return 0;
  if (g.lg_hl + g.lg_r <= 5) return ((e >> 5) & ((1 << g.lg_r) - 1)) << g.lg_hl;
  return ((e >> (g.lg_hl + g.lg_r)) & ((32 >> g.lg_hl) - 1)) << g.lg_hl;
}

// slot j of the result holds v[j ^ m] (m < 4): the XOR within a 4-slot group
__device__ __forceinline__ int4 kf_perm(int4 v, int m) {
  if (m & 1) v = make_int4(v.y, v.x, v.w, v.z);
  if (m & 2) v = make_int4(v.z, v.w, v.x, v.y);
  return v;
}

// --- asynchronous copies into shared memory (cp.async) ------------------------

__device__ __forceinline__ uint32_t kf_saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes of a plane read once: L2 evicts them first
__device__ __forceinline__ void kf_cp16_stream(int32_t* dst, const int32_t* src, uint64_t policy) {
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(kf_saddr(dst)), "l"(src),
               "l"(policy));
}

__device__ __forceinline__ void kf_cp16(int32_t* dst, const int32_t* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(kf_saddr(dst)), "l"(src));
}

__device__ __forceinline__ void kf_cp4(int32_t* dst, const int32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(kf_saddr(dst)), "l"(src));
}

// the tile's limbs and its twiddles into buffer `sm` (limb planes of E
// words, then limb planes of TW twiddle words), all as copies in flight.
// The tile moves in groups of four elements, 16 bytes a copy: element e to
// slot e ^ (kf_swz(e) & ~3) of each limb plane (kf_unswz then moves it
// within its group where the local distance is 1 or 2). Twiddle run j of
// RUNS (K7: level s from jp0; K8: level s from jp0 and jp0 + q, level s+1
// from jp0), hl entries each, goes to [j hl, (j + 1) hl) of each twiddle
// plane, 16 bytes a copy where hl >= 4. A tile of two elements (n = 2)
// moves one limb at a time.
template <int RUNS>
__device__ __forceinline__ void kf_issue(int32_t* sm, const int32_t* x, const int32_t* twl, long long n, int s,
                                         const KfGeom& g, uint64_t policy) {
  const int E = 1 << g.lg_e, hl = 1 << g.lg_hl, TW = RUNS * hl;
  int32_t* st = sm + 16 * E;
  const long long lvl = n - (n >> s), q = 1LL << g.lg_h;
  if (g.lg_hl >= 2) {  // a level's table starts at a multiple of 2h: whole 16-byte groups
    const int lg_c = g.lg_hl - 2;
    for (int v = threadIdx.x; v < 16 * RUNS << lg_c; v += blockDim.x) {
      const int l = v / (RUNS << lg_c), j = (v >> lg_c) % RUNS, c = (v & ((1 << lg_c) - 1)) << 2;
      const long long at = (j == 2 ? lvl + 2 * q : j == 1 ? lvl + q : lvl) + g.jp0 + c;
      kf_cp16(st + l * TW + j * hl + c, twl + l * n + at);
    }
  } else {
    for (int v = threadIdx.x; v < 16 * TW; v += blockDim.x) {
      const int l = v / TW, j = (v % TW) >> g.lg_hl, c = v & (hl - 1);
      const long long at = (j == 2 ? lvl + 2 * q : j == 1 ? lvl + q : lvl) + g.jp0 + c;
      kf_cp4(st + l * TW + j * hl + c, twl + l * n + at);
    }
  }
  if (g.lg_e >= 2) {
    const int lg_c = g.lg_e - 2;
#pragma unroll 4
    for (int v = threadIdx.x; v < 16 << lg_c; v += blockDim.x) {
      const int l = v >> lg_c, e = (v & ((1 << lg_c) - 1)) << 2;
      kf_cp16_stream(sm + l * E + (e ^ (kf_swz(g, e) & ~3)), x + l * n + kf_pos(g, e), policy);
    }
  } else {
    for (int v = threadIdx.x; v < 16 * E; v += blockDim.x) {
      const int l = v >> g.lg_e, e = v & (E - 1);
      kf_cp4(sm + l * E + (e ^ kf_swz(g, e)), x + l * n + kf_pos(g, e));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// local distance 1 or 2 (tiles of four or more): each landed group of four
// to its slots e ^ kf_swz(e), in place
__device__ __forceinline__ void kf_unswz(int32_t* sm, const KfGeom& g) {
  const int E = 1 << g.lg_e, lg_c = g.lg_e - 2;
  for (int v = threadIdx.x; v < 16 << lg_c; v += blockDim.x) {
    const int l = v >> lg_c, e = (v & ((1 << lg_c) - 1)) << 2, f = kf_swz(g, e);
    int4* grp = reinterpret_cast<int4*>(sm + l * E + (e ^ (f & ~3)));
    *grp = kf_perm(*grp, f & 3);
  }
}

// the tile out of buffer `sm` to its positions: 16-byte stores, L2 evicting
// them first (a tile of two elements, n = 2, one limb at a time)
__device__ __forceinline__ void kf_store(const int32_t* sm, int32_t* out, long long n, const KfGeom& g) {
  const int E = 1 << g.lg_e;
  if (g.lg_e >= 2) {
    const int lg_c = g.lg_e - 2;
#pragma unroll 4
    for (int v = threadIdx.x; v < 16 << lg_c; v += blockDim.x) {
      const int l = v >> lg_c, e = (v & ((1 << lg_c) - 1)) << 2;
      const int f = kf_swz(g, e);
      const int4 a = *reinterpret_cast<const int4*>(sm + l * E + (e ^ (f & ~3)));
      __stcs(reinterpret_cast<int4*>(out + l * n + kf_pos(g, e)), kf_perm(a, f & 3));
    }
  } else {
    for (int v = threadIdx.x; v < 16 * E; v += blockDim.x) {
      const int l = v >> g.lg_e, e = v & (E - 1);
      out[l * n + kf_pos(g, e)] = sm[l * E + (e ^ kf_swz(g, e))];
    }
  }
}

// an element in limb planes of stride E: 16-bit limbs 2w and 2w + 1 make word w
__device__ __forceinline__ Fe kf_read(const int32_t* sm, int E, int slot) {
  Fe a;
#pragma unroll
  for (int w = 0; w < 8; ++w) a.w[w] = (uint32_t)sm[2 * w * E + slot] | ((uint32_t)sm[(2 * w + 1) * E + slot] << 16);
  return a;
}

__device__ __forceinline__ void kf_write(int32_t* sm, int E, int slot, const Fe& a) {
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    sm[2 * w * E + slot] = (int32_t)(a.w[w] & 0xFFFFu);
    sm[(2 * w + 1) * E + slot] = (int32_t)(a.w[w] >> 16);
  }
}

// one radix-2 stage over the tile, E / 2 butterflies on operand pairs of
// the R-operand groups: K7's (0, 1) with twiddle run 0; K8's first stage
// (a, a + 2) with run a (ta, tb), its second (2a, 2a + 1) with run 2 (tc).
// The outputs go to the slots of the inputs; a warp takes 32 consecutive
// groups m at one a, whose operands lie in 32 banks (kf_swz).
__device__ __forceinline__ void kf_stage(int32_t* sm, const int32_t* st, int TW, const KfGeom& g, int stage,
                                         const FieldParams& fp) {
  const int E = 1 << g.lg_e, lg_m = g.lg_e - g.lg_r, hl = 1 << g.lg_hl;
  for (int u = threadIdx.x; u < E >> 1; u += blockDim.x) {
    const int a = u >> lg_m, m = u & ((1 << lg_m) - 1), jt = m & (hl - 1);
    const int i0 = g.lg_r == 1 ? 0 : stage == 0 ? a : 2 * a;
    const int i1 = g.lg_r == 1 ? 1 : stage == 0 ? a + 2 : 2 * a + 1;
    const int run = g.lg_r == 1 ? 0 : stage == 0 ? a : 2;
    const int e0 = ((m >> g.lg_hl) << (g.lg_hl + g.lg_r)) + jt;
    const int ea = e0 + (i0 << g.lg_hl), eb = e0 + (i1 << g.lg_hl);
    const int sa = ea ^ kf_swz(g, ea), sb = eb ^ kf_swz(g, eb);
    const Fe u0 = kf_read(sm, E, sa), u1 = kf_read(sm, E, sb);
    const Fe t = kf_read(st, TW, run * hl + jt);
    kf_write(sm, E, sa, add_mod(u0, u1, fp));
    kf_write(sm, E, sb, mont_mul(sub_mod(u0, u1, fp), t, fp));
  }
}

// LG_R = 1: K7 (radix 2, one stage); LG_R = 2: K8 (radix 4, two stages).
// Each block walks tiles blockIdx.x, + gridDim.x, ... through two buffers:
// the next tile's copies are in flight while this one's stages run and it
// is stored.
template <int LG_R>
__device__ __forceinline__ void kf_butterfly(int32_t* __restrict__ out, const int32_t* __restrict__ x,
                                             const int32_t* __restrict__ twl, int k, int s, int lg_e,
                                             const FieldParams& fp) {
  extern __shared__ int32_t kf_smem[];  // two buffers of (E + TW) limb words x 16
  constexpr int RUNS = LG_R == 1 ? 1 : 3;
  const long long n = 1LL << k, tiles = 1LL << (k - lg_e);
  const int E = 1 << lg_e, TW = RUNS << kf_geom(LG_R, k, s, lg_e, 0).lg_hl, BUF = 16 * (E + TW);
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  long long t = blockIdx.x;
  if (t < tiles) kf_issue<RUNS>(kf_smem, x, twl, n, s, kf_geom(LG_R, k, s, lg_e, t), policy);
  for (int i = 0; t < tiles; ++i, t += gridDim.x) {
    int32_t* cur = kf_smem + (i & 1) * BUF;
    const long long tn = t + gridDim.x;
    if (tn < tiles) {
      kf_issue<RUNS>(kf_smem + ((i + 1) & 1) * BUF, x, twl, n, s, kf_geom(LG_R, k, s, lg_e, tn), policy);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this tile's copies, not the next one's
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const KfGeom g = kf_geom(LG_R, k, s, lg_e, t);
    if (g.lg_hl < 2 && lg_e >= 2) {
      kf_unswz(cur, g);
      __syncthreads();
    }
#pragma unroll
    for (int stage = 0; stage < LG_R; ++stage) {
      kf_stage(cur, cur + 16 * E, TW, g, stage, fp);
      __syncthreads();
    }
    kf_store(cur, out, n, g);
    __syncthreads();  // the buffer is free for the tile after next
  }
}

__global__ void __launch_bounds__(KF_THREADS) k7_butterfly(
    int32_t* __restrict__ out, const int32_t* __restrict__ x, const int32_t* __restrict__ twl, int k, int s,
    int lg_e, FieldParams fp) {
  kf_butterfly<1>(out, x, twl, k, s, lg_e, fp);
}

__global__ void __launch_bounds__(KF_THREADS) k8_butterfly4(
    int32_t* __restrict__ out, const int32_t* __restrict__ x, const int32_t* __restrict__ twl, int k, int s,
    int lg_e, FieldParams fp) {
  kf_butterfly<2>(out, x, twl, k, s, lg_e, fp);
}

// E = 2^lg_e elements per tile for a launch at 2^k (lg_e <= 0: the default),
// or -1 where the tile cannot be taken: R runs need at least 4 elements each
static int kf_lg_tile(int lg_r, int k, int s, int lg_e) {
  if (lg_e <= 0) lg_e = 8;
  if (lg_e > k) lg_e = k;
  if (lg_e > KF_LG_TILE_MAX || (k - s > lg_e && lg_e - lg_r < 2)) return -1;
  return lg_e;
}

static int kf_threads(int lg_e) {
  const int b = 1 << (lg_e - 1);  // radix-2 butterflies per stage
  return b < 32 ? 32 : b < KF_THREADS ? b : KF_THREADS;
}

static const void* kf_kernel(int lg_r) {
  return lg_r == 1 ? (const void*)k7_butterfly : (const void*)k8_butterfly4;
}

// two buffers, each the tile's 16 limb planes of E words and at most
// (R - 1) E / R twiddles' 16 limbs; above the 48 KiB default the attribute
static cudaError_t kf_smem_bytes(int lg_r, int lg_e, size_t* bytes) {
  *bytes = (size_t)2 * 16 * sizeof(int32_t) * ((2 << lg_e) - (1 << (lg_e - lg_r)));
  static size_t allowed[3] = {0, 48 << 10, 48 << 10};
  if (*bytes > allowed[lg_r]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kf_kernel(lg_r), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
    if (err != cudaSuccess) return err;
    allowed[lg_r] = *bytes;
  }
  return cudaSuccess;
}

// blocks of a launch: every tile once, at most as many blocks as the card
// holds at once (each walks its tiles), from the runtime's occupancy
static cudaError_t kf_blocks(int lg_r, int lg_e, size_t bytes, long long tiles, unsigned* blocks) {
  static int resident[3][KF_LG_TILE_MAX + 1], sms;
  if (!sms) {
    int dev;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  int& r = resident[lg_r][lg_e];
  if (!r) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r, kf_kernel(lg_r), kf_threads(lg_e), bytes);
    if (err != cudaSuccess) return err;
    if (!r) return cudaErrorInvalidConfiguration;
  }
  const long long most = (long long)r * sms;
  *blocks = (unsigned)(tiles < most ? tiles : most);
  return cudaSuccess;
}

static int kf_launch(int lg_r, int32_t* out, const int32_t* x, const int32_t* twl, int k, int s, int lg_e,
                     FieldParams fp, void* stream) {
  if (k < lg_r || k > 30 || s < 0 || s > k - lg_r) return (int)cudaErrorInvalidValue;
  lg_e = kf_lg_tile(lg_r, k, s, lg_e);
  if (lg_e < 1 || ((uintptr_t)x | (uintptr_t)out | (uintptr_t)twl) % 16) return (int)cudaErrorInvalidValue;
  size_t bytes;
  unsigned blocks;
  cudaError_t err = kf_smem_bytes(lg_r, lg_e, &bytes);
  if (err == cudaSuccess) err = kf_blocks(lg_r, lg_e, bytes, 1LL << (k - lg_e), &blocks);
  if (err != cudaSuccess) return (int)err;
  if (lg_r == 1)
    k7_butterfly<<<blocks, kf_threads(lg_e), bytes, (cudaStream_t)stream>>>(out, x, twl, k, s, lg_e, fp);
  else
    k8_butterfly4<<<blocks, kf_threads(lg_e), bytes, (cudaStream_t)stream>>>(out, x, twl, k, s, lg_e, fp);
  return (int)cudaGetLastError();
}

extern "C" int spt_butterfly(int32_t* out, const int32_t* x, const int32_t* twl, int k, int s, int lg_e,
                             FieldParams fp, void* stream) {
  return kf_launch(1, out, x, twl, k, s, lg_e, fp, stream);
}

extern "C" int spt_butterfly4(int32_t* out, const int32_t* x, const int32_t* twl, int k, int s, int lg_e,
                              FieldParams fp, void* stream) {
  return kf_launch(2, out, x, twl, k, s, lg_e, fp, stream);
}

// occupancy of K7 (radix 2) or K8 (radix 4) at E = 2^lg_e: out[0] resident
// blocks per SM (the runtime's figure for this build), out[1] registers per
// thread, out[2] threads per block, out[3] dynamic shared bytes per block
extern "C" int spt_butterfly_occupancy(int radix, int lg_e, int* out) {
  const int lg_r = radix == 2 ? 1 : radix == 4 ? 2 : 0;
  if (!lg_r || lg_e < lg_r + 2 || lg_e > KF_LG_TILE_MAX) return (int)cudaErrorInvalidValue;
  size_t bytes;
  cudaError_t err = kf_smem_bytes(lg_r, lg_e, &bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kf_kernel(lg_r), kf_threads(lg_e), bytes);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, kf_kernel(lg_r));
  if (err != cudaSuccess) return (int)err;
  out[1] = a.numRegs;
  out[2] = kf_threads(lg_e);
  out[3] = (int)bytes;
  return (int)cudaSuccess;
}
