// K2: one pass of the four-step Fr NTT, with the data movement of the pass
// folded in: one launch per level of the plan (ops/ntt_tile.py TiledDomain).
//
// Replaces the JAX package's ops/ntt_tile.py `_bntt_kernel` (called through
// `_bntt`) and, inside the four-step engine, the twiddle product
// `_mul_kernel` (called through `lm_mul`), the transposes around them and
// the final gather and n^-1 scale.
//
// A column is n = 2^lg_n elements, (C, n, 16) int32 limbs, 64 contiguous
// bytes per element, in and out. A pass at one level splits each column into
// groups of S * m elements (S = 2^lg_s, m = 2^k <= 256); row i1 < S of a
// group is the m elements at group + i1 + i * S. The pass runs every row's
// NTT and writes each output, in its bit-reversed slot q, back to
// group + i1 + q * S: the (m x S) view of the group, transposed in place.
// That is the layout the next level reads as contiguous groups of S, so no
// pass ever moves data between levels. A pass may also
//   - multiply each element by a per-position table `pre` as it loads (a
//     coset scale before a forward transform);
//   - multiply slot q of row i1 by twmid[i1, q] (the four-step twiddles,
//     (S, m, 16)) after the row NTT;
//   - write slot q to its natural position (last pass only: the plan's
//     final permutation, which is the lg_n-bit reversal of the position),
//     times n^-1 and a per-position table `post`.
// Passes that do not permute may run in place: a block writes only the
// slots it read.
//
// Tiling: a block takes T = E / m rows of one column, min(256, E / 2)
// threads, E / 2 butterflies per stage. E is 512 elements by default, 256
// at k <= 4 (the short leaf rows: rows of 16 sixteen to a block, 128
// threads; twice the resident blocks per SM made that leaf ~10% faster on
// the H100, where the k = 8 passes were faster at 512). The caller may pick
// E = 2^lg_e (m <= E <= 2048; a strided level needs S >= T): chip_smoke.py
// times other tile sizes with it. Neighbouring rows of a
// strided level (S >= T) are neighbouring addresses, so consecutive threads
// load and store consecutive 64-byte elements; a leaf row is contiguous.
// The last pass takes its rows in bit-reversed order and stores rows
// fastest: slot q of row R then lands at R + brev_k(q) * 2^(lg_n - k), so
// each slot of a tile writes a run of T neighbouring elements, not single
// ones. The rows sit in dynamic shared memory as 8 x 32-bit words, two
// buffers of E (64 E bytes: 32 KiB at E = 512); the stages are Pease's
// constant geometry with the host plan's tables (`_twpack`), as in the JAX
// kernel: every stage pairs v[j] with v[j + m/2] and writes the sum and the
// twiddled difference to 2j and 2j + 1, so the output is bit-reversed.
// Blocks of one tile in each column are neighbours in the grid, so twmid,
// pre and post are read from device memory about once.
//
// Bound on the H100: operations. Per element the pass reads and writes 64 B
// and runs k/2 Montgomery products in the stages plus one for each of twmid,
// pre, n^-1 and post that it applies (272 32-bit multiplies each).
#include "bn254.cuh"

#define K2_LG_TILE_MAX 11
#define K2_THREADS 256

__device__ __forceinline__ long long k2_brev(long long v, int bits) {
  return bits ? (long long)(__brevll((unsigned long long)v) >> (64 - bits)) : 0;
}

// position in the column of slot i of tile row t (row R = r0 + t). A strided
// row (lg_s > 0) is the m elements at group + i1 + i * S; a leaf row
// (lg_s = 0) is group R, m contiguous elements, taken in bit-reversed row
// order when brev_bits > 0.
__device__ __forceinline__ long long k2_pos(int t, int i, int k, int lg_s, long long r0, int brev_bits) {
  const long long R = r0 + t;
  if (lg_s == 0) return ((brev_bits ? k2_brev(R, brev_bits) : R) << k) + i;
  return ((R >> lg_s) << (lg_s + k)) + (R & ((1LL << lg_s) - 1)) + ((long long)i << lg_s);
}

__global__ void __launch_bounds__(K2_THREADS) k2_ntt_pass(
    int32_t* out, const int32_t* in, const int32_t* __restrict__ tw, const int32_t* __restrict__ twmid,
    const int32_t* __restrict__ pre, const int32_t* __restrict__ post, const int32_t* __restrict__ ninv,
    int last, int k, int lg_s, int lg_n, int lg_e, int cols, FieldParams fp) {
  extern __shared__ Fe k2_smem[];  // two buffers of E, indexed by offset (no
                                   // pointer array: it would sit in local memory)
  const int m = 1 << k, h = m >> 1, E = 1 << lg_e;
  const int lg_t = lg_e - k;  // rows per tile
  const int c = blockIdx.x % cols;
  const long long r0 = (long long)(blockIdx.x / cols) << lg_t;
  const long long col = (long long)c << lg_n;
  // the last pass (a leaf, lg_s = 0) takes its rows bit-reversed: its slot
  // q of row R goes to the natural position R + brev_k(q) << (lg_n - k)
  const int brev_bits = last ? lg_n - k : 0;
  const int th = threadIdx.x;

  // element order e -> (t, i): rows fastest where neighbouring rows are
  // neighbouring addresses (strided rows; the last pass's outputs), slots
  // fastest along a leaf row
  for (int e = th; e < E; e += blockDim.x) {
    const int t = lg_s ? e & ((1 << lg_t) - 1) : e >> k;
    const int i = lg_s ? e >> lg_t : e & (m - 1);
    const long long pos = k2_pos(t, i, k, lg_s, r0, brev_bits);
    Fe v = load_row(in + (col + pos) * 16);
    if (pre) v = mont_mul(v, load_row(pre + pos * 16), fp);
    k2_smem[(t << k) | i] = v;
  }
  __syncthreads();

  int cur = 0;  // offset of the stage's input buffer: 0 or E
  for (int s = 0; s < k; ++s) {
    for (int b = th; b < E / 2; b += blockDim.x) {
      const int t = b >> (k - 1), j = b & (h - 1);
      const int from = cur + (t << k), to = (E - cur) + (t << k);
      const Fe u = k2_smem[from + j], w = k2_smem[from + j + h];
      const Fe tj = load_fe(tw + (long long)s * 16 * h + j, h);
      k2_smem[to + 2 * j] = add_mod(u, w, fp);
      k2_smem[to + 2 * j + 1] = mont_mul(sub_mod(u, w, fp), tj, fp);
    }
    cur = E - cur;
    __syncthreads();
  }

  const Fe scale = ninv ? load_row(ninv) : fe_zero();
  const bool rows_fast = lg_s || last;
  for (int e = th; e < E; e += blockDim.x) {
    const int tt = rows_fast ? e & ((1 << lg_t) - 1) : e >> k;
    const int i = rows_fast ? e >> lg_t : e & (m - 1);
    Fe v = k2_smem[cur + ((tt << k) | i)];
    if (twmid) {
      const long long i1 = (r0 + tt) & ((1LL << lg_s) - 1);
      v = mont_mul(v, load_row(twmid + ((i1 << k) + i) * 16), fp);
    }
    if (last) {
      const long long q = r0 + tt + (k2_brev(i, k) << (lg_n - k));
      if (ninv) v = mont_mul(v, scale, fp);
      if (post) v = mont_mul(v, load_row(post + q * 16), fp);
      store_row(out + (col + q) * 16, v);
    } else {
      store_row(out + (col + k2_pos(tt, i, k, lg_s, r0, 0)) * 16, v);
    }
  }
}

// E = 2^lg_e elements per tile for a pass at k over 2^lg_n (0: the default)
static int k2_lg_tile(int lg_e, int k, int lg_n) {
  if (lg_e <= 0) lg_e = k <= 4 ? 8 : 9;
  return lg_e < lg_n ? lg_e : lg_n;
}

static int k2_threads(int lg_e) { return lg_e - 1 < 8 ? 1 << (lg_e - 1) : K2_THREADS; }

// dynamic shared memory above the 48 KiB default needs the attribute
static cudaError_t k2_smem_bytes(int lg_e, size_t* bytes) {
  *bytes = (size_t)2 * sizeof(Fe) << lg_e;
  static size_t allowed = 48 << 10;
  if (*bytes > allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(k2_ntt_pass, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
    if (err != cudaSuccess) return err;
    allowed = *bytes;
  }
  return cudaSuccess;
}

extern "C" int spt_ntt_pass(int32_t* out, const int32_t* in, const int32_t* tw, const int32_t* twmid,
                            const int32_t* pre, const int32_t* post, const int32_t* ninv, int last,
                            int k, int lg_s, int lg_n, int lg_e, int cols, FieldParams fp, void* stream) {
  lg_e = k2_lg_tile(lg_e, k, lg_n);
  // a tile holds whole rows; a strided level's tile rows share one group
  // (S >= T); the permuting pass is a leaf
  if (k < 1 || k > 8 || lg_e < k || lg_e > K2_LG_TILE_MAX || lg_s < 0 || lg_n < k + lg_s || lg_n > 40 ||
      cols < 1 || (lg_s && lg_s < lg_e - k) || (last && lg_s))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (1LL << (lg_n - lg_e)) * cols;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  size_t bytes;
  const cudaError_t err = k2_smem_bytes(lg_e, &bytes);
  if (err != cudaSuccess) return (int)err;
  k2_ntt_pass<<<(unsigned)blocks, k2_threads(lg_e), bytes, (cudaStream_t)stream>>>(
      out, in, tw, twmid, pre, post, ninv, last, k, lg_s, lg_n, lg_e, cols, fp);
  return (int)cudaGetLastError();
}

// occupancy of k2_ntt_pass at E = 2^lg_e: out[0] resident blocks per SM (the
// runtime's figure for this build), out[1] registers per thread, out[2]
// threads per block, out[3] dynamic shared bytes per block
extern "C" int spt_ntt_pass_occupancy(int lg_e, int* out) {
  if (lg_e < 1 || lg_e > K2_LG_TILE_MAX) return (int)cudaErrorInvalidValue;
  size_t bytes;
  cudaError_t err = k2_smem_bytes(lg_e, &bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], k2_ntt_pass, k2_threads(lg_e), bytes);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, k2_ntt_pass);
  if (err != cudaSuccess) return (int)err;
  out[1] = a.numRegs;
  out[2] = k2_threads(lg_e);
  out[3] = (int)bytes;
  return (int)cudaSuccess;
}
