// Shared BN254 arithmetic for the port's kernels (sm_90a).
//
// Field elements live in device memory as the package's limb planes: 16
// little-endian 16-bit limbs, each in an int32 (fields/limbs.py). Inside a
// kernel they are 8 x 32-bit words; R = 2^256 either way, so Montgomery values
// are identical. The product is CIOS on PTX carry chains (mad.lo/madc.hi
// with .cc, split by word parity), add/sub are add.cc/sub.cc chains; every
// result is canonical (< p), so a kernel agrees bit for bit with its plain
// PyTorch version.
//
// The curve formulas are Renes-Costello-Batina 2015 (a = 0, b3 = 9):
// alg. 8 mixed add (`madd`), alg. 7 complete add (`padd`) and alg. 9
// doubling (`pdbl`), transcribed step for step from ops/ec.py so projective
// coordinates match exactly. The products by b3 are four modular additions
// here (`mul_b3`): the same canonical value as ops/ec.py's product with 9R,
// so the mixed add makes 11 Montgomery products instead of 13, the complete
// add 12 instead of 14 and the doubling 8 instead of 9.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

struct FieldParams {
  uint32_t p[8];
  uint32_t n0;  // -p^-1 mod 2^32
};

struct CurveParams {
  FieldParams fq;
  uint32_t one[8];  // R mod p
};

struct Fe {
  uint32_t w[8];
};

// --- limb-plane loads/stores: limb l of an element at base + l * ls --------

__device__ __forceinline__ Fe load_fe(const int32_t* base, long long ls) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    r.w[j] = (uint32_t)base[(2 * j) * ls] | ((uint32_t)base[(2 * j + 1) * ls] << 16);
  return r;
}

__device__ __forceinline__ void store_fe(int32_t* base, long long ls, const Fe& a) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    base[(2 * j) * ls] = (int32_t)(a.w[j] & 0xFFFFu);
    base[(2 * j + 1) * ls] = (int32_t)(a.w[j] >> 16);
  }
}

// --- row-major elements: 16 limbs contiguous, 16-byte aligned ----------------

__device__ __forceinline__ Fe load_row(const int32_t* base) {
  const int4* s = reinterpret_cast<const int4*>(base);
  Fe r;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int4 v = s[q];
    r.w[2 * q] = (uint32_t)v.x | ((uint32_t)v.y << 16);
    r.w[2 * q + 1] = (uint32_t)v.z | ((uint32_t)v.w << 16);
  }
  return r;
}

__device__ __forceinline__ void store_row(int32_t* base, const Fe& a) {
  int4* d = reinterpret_cast<int4*>(base);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    d[q] = make_int4((int)(a.w[2 * q] & 0xFFFFu), (int)(a.w[2 * q] >> 16),
                     (int)(a.w[2 * q + 1] & 0xFFFFu), (int)(a.w[2 * q + 1] >> 16));
}

// --- 32-bit word form (bucket scratch: 8 words per coordinate) -------------

__device__ __forceinline__ Fe load_words(const int32_t* src) {
  Fe r;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4 a = s[0], b = s[1];
  r.w[0] = a.x; r.w[1] = a.y; r.w[2] = a.z; r.w[3] = a.w;
  r.w[4] = b.x; r.w[5] = b.y; r.w[6] = b.z; r.w[7] = b.w;
  return r;
}

__device__ __forceinline__ void store_words(int32_t* dst, const Fe& a) {
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(a.w[0], a.w[1], a.w[2], a.w[3]);
  d[1] = make_uint4(a.w[4], a.w[5], a.w[6], a.w[7]);
}

__device__ __forceinline__ Fe fe_from(const uint32_t w[8]) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = w[j];
  return r;
}

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = 0;
  return r;
}

// --- modular arithmetic: PTX carry chains -----------------------------------
//
// Each chain is one asm statement, so no compiler instruction can land
// between two links and clobber the carry flag. Both moduli are below 2^254,
// so a + b and every CIOS step stay below 2^256 / 2^288: no carry leaves a
// chain that the code does not take.

// r = t - p if t >= p, else t (t < 2p): one subtract chain, the borrow as a
// mask selects the result without a branch
__device__ __forceinline__ Fe reduce_once(const uint32_t* t, const uint32_t* p) {
  uint32_t d[8], br;
  const uint32_t zero = 0;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, %25, %25;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]), "=r"(d[5]), "=r"(d[6]),
        "=r"(d[7]), "=r"(br)
      : "r"(t[0]), "r"(t[1]), "r"(t[2]), "r"(t[3]), "r"(t[4]), "r"(t[5]), "r"(t[6]), "r"(t[7]),
        "r"(p[0]), "r"(p[1]), "r"(p[2]), "r"(p[3]), "r"(p[4]), "r"(p[5]), "r"(p[6]), "r"(p[7]),
        "r"(zero));
  Fe r;  // br = 0xFFFFFFFF when t < p: keep t
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = (t[j] & br) | (d[j] & ~br);
  return r;
}

// a + b (no carry out: a + b < 2p < 2^255)
__device__ __forceinline__ void add8(uint32_t* s, const uint32_t* a, const uint32_t* b) {
  asm("add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32 %7, %15, %23;"
      : "=r"(s[0]), "=r"(s[1]), "=r"(s[2]), "=r"(s[3]), "=r"(s[4]), "=r"(s[5]), "=r"(s[6]), "=r"(s[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
        "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
}

// d = a - b mod 2^256; returns the borrow as a mask (0 or 0xFFFFFFFF)
__device__ __forceinline__ uint32_t sub8(uint32_t* d, const uint32_t* a, const uint32_t* b) {
  uint32_t br;
  const uint32_t zero = 0;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, %25, %25;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]), "=r"(d[5]), "=r"(d[6]),
        "=r"(d[7]), "=r"(br)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
        "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]),
        "r"(zero));
  return br;
}

__device__ __forceinline__ Fe add_mod(const Fe& a, const Fe& b, const FieldParams& fp) {
  uint32_t s[8];
  add8(s, a.w, b.w);
  return reduce_once(s, fp.p);
}

// a - b, plus p where the subtraction borrowed
__device__ __forceinline__ Fe sub_mod(const Fe& a, const Fe& b, const FieldParams& fp) {
  Fe r;
  uint32_t d[8], q[8];
  const uint32_t br = sub8(d, a.w, b.w);
#pragma unroll
  for (int j = 0; j < 8; ++j) q[j] = fp.p[j] & br;
  add8(r.w, d, q);
  return r;
}

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) acc |= a.w[j];
  return acc == 0;
}

// (-a) mod p, 0 -> 0: (p masked to 0 where a = 0) - a
__device__ __forceinline__ Fe neg_mod(const Fe& a, const FieldParams& fp) {
  const uint32_t nz = fe_is_zero(a) ? 0u : 0xFFFFFFFFu;
  uint32_t q[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) q[j] = fp.p[j] & nz;
  Fe r;
  sub8(r.w, q, a.w);
  return r;
}

// Montgomery product, CIOS with the running sum split by word parity (the
// even/odd form of sppark's mont_t): e holds the products of the operand's
// even words, lo at 2k and hi at 2k + 1, o those of its odd words one word
// up. Each chain below pairs lo and hi of one product, which ptxas issues as
// one IMAD.WIDE.U32(.X) (cuobjdump -sass), where one chain of lo halves and
// one of hi halves per word compiled to an IMAD plus an IADD3.X per link;
// the two parities' chains are independent. The carries out that the code
// drops are zero for p < 2^254.

// acc[0..7] += x[0, 2, 4, 6] * y, lo and hi of each product in turn
__device__ __forceinline__ void cmad_n(uint32_t* acc, const uint32_t* x, uint32_t y) {
  asm("mad.lo.cc.u32 %0, %8, %12, %0;\n\t"
      "madc.hi.cc.u32 %1, %8, %12, %1;\n\t"
      "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
      "madc.hi.cc.u32 %3, %9, %12, %3;\n\t"
      "madc.lo.cc.u32 %4, %10, %12, %4;\n\t"
      "madc.hi.cc.u32 %5, %10, %12, %5;\n\t"
      "madc.lo.cc.u32 %6, %11, %12, %6;\n\t"
      "madc.hi.u32 %7, %11, %12, %7;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]), "+r"(acc[5]),
        "+r"(acc[6]), "+r"(acc[7])
      : "r"(x[0]), "r"(x[2]), "r"(x[4]), "r"(x[6]), "r"(y));
}

// acc[0..7] += x[0, 2, 4, 6] * y, then top += the chain's carry
__device__ __forceinline__ void cmad_n_carry(uint32_t* acc, const uint32_t* x, uint32_t y,
                                             uint32_t& top) {
  asm("mad.lo.cc.u32 %0, %9, %13, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %13, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
      "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
      "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]), "+r"(acc[5]),
        "+r"(acc[6]), "+r"(acc[7]), "+r"(top)
      : "r"(x[0]), "r"(x[2]), "r"(x[4]), "r"(x[6]), "r"(y));
}

// e[0] += o[1]; then o = (o >> 2 words) + x[1, 3, 5, 7] * y, the first
// add's carry entering the chain
__device__ __forceinline__ void add_madc_rshift(uint32_t& e0, uint32_t* o, const uint32_t* x,
                                                uint32_t y) {
  const uint32_t zero = 0;
  asm("add.cc.u32 %0, %0, %2;\n\t"
      "madc.lo.cc.u32 %1, %9, %13, %3;\n\t"
      "madc.hi.cc.u32 %2, %9, %13, %4;\n\t"
      "madc.lo.cc.u32 %3, %10, %13, %5;\n\t"
      "madc.hi.cc.u32 %4, %10, %13, %6;\n\t"
      "madc.lo.cc.u32 %5, %11, %13, %7;\n\t"
      "madc.hi.cc.u32 %6, %11, %13, %8;\n\t"
      "madc.lo.cc.u32 %7, %12, %13, %14;\n\t"
      "madc.hi.u32 %8, %12, %13, %14;"
      : "+r"(e0), "+r"(o[0]), "+r"(o[1]), "+r"(o[2]), "+r"(o[3]), "+r"(o[4]), "+r"(o[5]),
        "+r"(o[6]), "+r"(o[7])
      : "r"(x[1]), "r"(x[3]), "r"(x[5]), "r"(x[7]), "r"(y), "r"(zero));
}

// one word of CIOS: (e, o) += a * bi, then += m * p with m = e[0] * n0
__device__ __forceinline__ void mad_n_redc(uint32_t* e, uint32_t* o, const uint32_t* a, uint32_t bi,
                                           const FieldParams& fp, bool first) {
  if (first) {
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      o[j] = a[j + 1] * bi;
      o[j + 1] = __umulhi(a[j + 1], bi);
      e[j] = a[j] * bi;
      e[j + 1] = __umulhi(a[j], bi);
    }
  } else {
    add_madc_rshift(e[0], o, a, bi);
    cmad_n_carry(e, a, bi, o[7]);
  }
  const uint32_t m = e[0] * fp.n0;
  cmad_n(o, fp.p + 1, m);
  cmad_n_carry(e, fp.p, m, o[7]);
}

// CIOS Montgomery product a*b*R^-1 mod p: two words of b per step, the
// parity roles swapping between them; with a, b < p and p < R/4 the merged
// sum is below 2p, and one conditional subtract makes it canonical
__device__ __forceinline__ Fe mont_mul(const Fe& a, const Fe& b, const FieldParams& fp) {
  uint32_t e[8], o[8];
#pragma unroll
  for (int i = 0; i < 8; i += 2) {
    mad_n_redc(e, o, a.w, b.w[i], fp, i == 0);
    mad_n_redc(o, e, a.w, b.w[i + 1], fp, false);
  }
  asm("add.cc.u32 %0, %0, %8;\n\t"  // e += o >> 1 word
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32 %7, %7, 0;"
      : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]), "+r"(e[6]),
        "+r"(e[7])
      : "r"(o[1]), "r"(o[2]), "r"(o[3]), "r"(o[4]), "r"(o[5]), "r"(o[6]), "r"(o[7]));
  return reduce_once(e, fp.p);
}

// --- G1, homogeneous projective ------------------------------------------------

struct Pt {
  Fe x, y, z;
};

__device__ __forceinline__ Pt pt_identity(const CurveParams& cv) {
  Pt r;
  r.x = fe_zero();
  r.y = fe_from(cv.one);
  r.z = fe_zero();
  return r;
}

// 9 a, the product by b3 = 3 * 3 (y^2 = x^3 + 3) in four additions
__device__ __forceinline__ Fe mul_b3(const Fe& a, const FieldParams& f) {
  const Fe a2 = add_mod(a, a, f);
  const Fe a4 = add_mod(a2, a2, f);
  return add_mod(add_mod(a4, a4, f), a, f);
}

// RCB15 alg. 8: p + (qx, qy, 1); complete in p, q a real affine point
__device__ __forceinline__ Pt madd(const Pt& p, const Fe& qx, const Fe& qy, const CurveParams& cv) {
  const FieldParams& f = cv.fq;
  Fe t0 = mont_mul(p.x, qx, f);
  Fe t1 = mont_mul(p.y, qy, f);
  Fe t3 = add_mod(qx, qy, f);
  Fe t4 = add_mod(p.x, p.y, f);
  t3 = mont_mul(t3, t4, f);
  t4 = add_mod(t0, t1, f);
  t3 = sub_mod(t3, t4, f);
  t4 = mont_mul(qy, p.z, f);
  t4 = add_mod(t4, p.y, f);
  Fe y3 = mont_mul(qx, p.z, f);
  y3 = add_mod(y3, p.x, f);
  Fe x3 = add_mod(t0, t0, f);
  t0 = add_mod(x3, t0, f);
  Fe t2 = mul_b3(p.z, f);
  Fe z3 = add_mod(t1, t2, f);
  t1 = sub_mod(t1, t2, f);
  y3 = mul_b3(y3, f);
  x3 = mont_mul(t4, y3, f);
  t2 = mont_mul(t3, t1, f);
  x3 = sub_mod(t2, x3, f);
  y3 = mont_mul(y3, t0, f);
  t1 = mont_mul(t1, z3, f);
  y3 = add_mod(t1, y3, f);
  t0 = mont_mul(t0, t3, f);
  z3 = mont_mul(z3, t4, f);
  z3 = add_mod(z3, t0, f);
  Pt r;
  r.x = x3;
  r.y = y3;
  r.z = z3;
  return r;
}

// RCB15 alg. 7: complete projective p + q
__device__ __forceinline__ Pt padd(const Pt& p, const Pt& q, const CurveParams& cv) {
  const FieldParams& f = cv.fq;
  Fe t0 = mont_mul(p.x, q.x, f);
  Fe t1 = mont_mul(p.y, q.y, f);
  Fe t2 = mont_mul(p.z, q.z, f);
  Fe t3 = mont_mul(add_mod(p.x, p.y, f), add_mod(q.x, q.y, f), f);
  t3 = sub_mod(t3, add_mod(t0, t1, f), f);
  Fe t4 = mont_mul(add_mod(p.y, p.z, f), add_mod(q.y, q.z, f), f);
  t4 = sub_mod(t4, add_mod(t1, t2, f), f);
  Fe x3 = mont_mul(add_mod(p.x, p.z, f), add_mod(q.x, q.z, f), f);
  Fe y3 = sub_mod(x3, add_mod(t0, t2, f), f);
  x3 = add_mod(t0, t0, f);
  t0 = add_mod(x3, t0, f);
  t2 = mul_b3(t2, f);
  Fe z3 = add_mod(t1, t2, f);
  t1 = sub_mod(t1, t2, f);
  y3 = mul_b3(y3, f);
  x3 = mont_mul(t4, y3, f);
  t2 = mont_mul(t3, t1, f);
  x3 = sub_mod(t2, x3, f);
  y3 = mont_mul(y3, t0, f);
  t1 = mont_mul(t1, z3, f);
  y3 = add_mod(t1, y3, f);
  t0 = mont_mul(t0, t3, f);
  z3 = mont_mul(z3, t4, f);
  z3 = add_mod(z3, t0, f);
  Pt r;
  r.x = x3;
  r.y = y3;
  r.z = z3;
  return r;
}

// RCB15 alg. 9: complete projective 2p (ops/ec.py `double`, 8 products)
__device__ __forceinline__ Pt pdbl(const Pt& p, const CurveParams& cv) {
  const FieldParams& f = cv.fq;
  Fe t0 = mont_mul(p.y, p.y, f);
  Fe z3 = add_mod(t0, t0, f);
  z3 = add_mod(z3, z3, f);
  z3 = add_mod(z3, z3, f);
  Fe t1 = mont_mul(p.y, p.z, f);
  Fe t2 = mont_mul(p.z, p.z, f);
  t2 = mul_b3(t2, f);
  Fe x3 = mont_mul(t2, z3, f);
  Fe y3 = add_mod(t0, t2, f);
  z3 = mont_mul(t1, z3, f);
  t1 = add_mod(t2, t2, f);
  t2 = add_mod(t1, t2, f);
  t0 = sub_mod(t0, t2, f);
  y3 = mont_mul(t0, y3, f);
  y3 = add_mod(x3, y3, f);
  t1 = mont_mul(p.x, p.y, f);
  x3 = mont_mul(t0, t1, f);
  x3 = add_mod(x3, x3, f);
  Pt r;
  r.x = x3;
  r.y = y3;
  r.z = z3;
  return r;
}

// --- launch helpers ------------------------------------------------------------

static inline unsigned grid_for(long long work, int threads) {
  long long b = (work + threads - 1) / threads;
  if (b > 0x7FFFFFFFLL) b = 0x7FFFFFFFLL;
  return (unsigned)(b < 1 ? 1 : b);
}
