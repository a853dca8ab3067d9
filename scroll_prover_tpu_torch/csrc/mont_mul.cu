// K1: the port's elementwise field kernel over Fr or Fq (modulus passed in).
//
// Replaces the JAX package's ops/ntt_tile.py `_mul_kernel` (called through
// `lm_mul`, which mont_mul_big routes huge arrays to): every field_ops
// product on a CUDA tensor. The NTT's own twiddle products and n^-1 scale
// run inside K2 (ntt.cu). The same source, one kernel per mode
// (a template parameter), also takes the neighbours of the product that the
// JAX package left to plain array code (ops/field_ops.py add_mod, sub_mod,
// neg_mod), so a field op on the card is one launch:
//   k1_mul      a * b            k1as_add   a + b
//   k1_mul_add  a * b + c        k1as_sub   a - b
//   k1_mul_sub  a * b - c        k1as_neg   -a
// Every input is canonical and every output canonical (< p).
//
// One thread per element, grid-stride. Operand e of each input sits at
// base + e * es + l * ls (limb l). Three input layouts, told apart per
// launch:
//   row-major (..., 16), es = 16, ls = 1, 16-byte aligned: four 16-byte
//     loads per element;
//   transposed views of limb-major (16, N) planes, es = 1: scalar loads,
//     coalesced across the warp;
//   a broadcast scalar, es = 0: loaded once per thread, outside the loop.
// The output is a new row-major (N, 16) tensor: four 16-byte stores per
// element.
//
// Bound on the H100: bytes. A product moves 3 x 64 B of int32-held limbs
// (4 x 64 B with c) against 264 32-bit multiply-adds; add/sub/neg do no
// product. The vector loads keep each warp instruction on 512 useful bytes
// where scalar loads at a 64-byte stride used 128.
#include "bn254.cuh"

enum : int { K1_MUL = 0, K1_MUL_ADD, K1_MUL_SUB, K1_ADD, K1_SUB, K1_NEG };

struct Operand {
  const int32_t* p;
  long long es, ls;
};

__device__ __forceinline__ bool is_row(const int32_t* p, long long es, long long ls) {
  return es == 16 && ls == 1 && ((reinterpret_cast<uintptr_t>(p) & 15) == 0);
}

__device__ __forceinline__ Fe load_op(const Operand& o, bool row, const Fe& bcast, long long e) {
  if (o.es == 0) return bcast;
  return row ? load_row(o.p + e * 16) : load_fe(o.p + e * o.es, o.ls);
}

template <int MODE>
__device__ __forceinline__ void k1_body(int32_t* out, const Operand& a, const Operand& b, const Operand& c,
                                        long long n, const FieldParams& fp) {
  constexpr bool USES_B = MODE != K1_NEG;
  constexpr bool USES_C = MODE == K1_MUL_ADD || MODE == K1_MUL_SUB;
  const bool ra = is_row(a.p, a.es, a.ls), rb = is_row(b.p, b.es, b.ls);
  const bool rc = is_row(c.p, c.es, c.ls);
  const Fe ca = a.es == 0 ? load_fe(a.p, a.ls) : fe_zero();
  const Fe cb = USES_B && b.es == 0 ? load_fe(b.p, b.ls) : fe_zero();
  const Fe cc = USES_C && c.es == 0 ? load_fe(c.p, c.ls) : fe_zero();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n; e += stride) {
    const Fe x = load_op(a, ra, ca, e);
    Fe r;
    if constexpr (MODE == K1_NEG) {
      r = neg_mod(x, fp);
    } else {
      const Fe y = load_op(b, rb, cb, e);
      if constexpr (MODE == K1_ADD) {
        r = add_mod(x, y, fp);
      } else if constexpr (MODE == K1_SUB) {
        r = sub_mod(x, y, fp);
      } else {
        r = mont_mul(x, y, fp);
        if constexpr (MODE == K1_MUL_ADD) r = add_mod(r, load_op(c, rc, cc, e), fp);
        if constexpr (MODE == K1_MUL_SUB) r = sub_mod(r, load_op(c, rc, cc, e), fp);
      }
    }
    store_row(out + e * 16, r);
  }
}

#define K1_KERNEL(name, MODE)                                                                     \
  __global__ void __launch_bounds__(256) name(int32_t* out, Operand a, Operand b, Operand c,     \
                                              long long n, FieldParams fp) {                     \
    k1_body<MODE>(out, a, b, c, n, fp);                                                          \
  }

K1_KERNEL(k1_mul, K1_MUL)
K1_KERNEL(k1_mul_add, K1_MUL_ADD)
K1_KERNEL(k1_mul_sub, K1_MUL_SUB)
K1_KERNEL(k1as_add, K1_ADD)
K1_KERNEL(k1as_sub, K1_SUB)
K1_KERNEL(k1as_neg, K1_NEG)

extern "C" int spt_field(int mode, int32_t* out, const int32_t* a, long long a_es, long long a_ls,
                         const int32_t* b, long long b_es, long long b_ls, const int32_t* c,
                         long long c_es, long long c_ls, long long n, FieldParams fp, void* stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  const unsigned grid = grid_for(blocks * threads, threads);
  cudaStream_t st = (cudaStream_t)stream;
  const Operand A{a, a_es, a_ls}, B{b, b_es, b_ls}, C{c, c_es, c_ls};
  switch (mode) {
    case K1_MUL: k1_mul<<<grid, threads, 0, st>>>(out, A, B, C, n, fp); break;
    case K1_MUL_ADD: k1_mul_add<<<grid, threads, 0, st>>>(out, A, B, C, n, fp); break;
    case K1_MUL_SUB: k1_mul_sub<<<grid, threads, 0, st>>>(out, A, B, C, n, fp); break;
    case K1_ADD: k1as_add<<<grid, threads, 0, st>>>(out, A, B, C, n, fp); break;
    case K1_SUB: k1as_sub<<<grid, threads, 0, st>>>(out, A, B, C, n, fp); break;
    case K1_NEG: k1as_neg<<<grid, threads, 0, st>>>(out, A, B, C, n, fp); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
