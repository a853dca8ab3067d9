// Shared BN254 arithmetic for the port's kernels (sm_90a).
//
// Field elements live in device memory as the package's limb planes: 16
// little-endian 16-bit limbs, each in an int32 (fields/limbs.py). Inside a
// kernel they are 8 x 32-bit words; R = 2^256 either way, so Montgomery values
// are identical. Products are 32 x 32 -> 64-bit CIOS (p < R/4, one
// conditional subtract); every result is canonical (< p), so a kernel agrees
// bit for bit with its plain PyTorch version.
//
// The curve formulas are Renes-Costello-Batina 2015 (a = 0, b3 = 9):
// alg. 8 mixed add (`madd`) and alg. 7 complete add (`padd`), transcribed
// step for step from ops/ec.py so projective coordinates match exactly.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

struct FieldParams {
  uint32_t p[8];
  uint32_t n0;  // -p^-1 mod 2^32
};

struct CurveParams {
  FieldParams fq;
  uint32_t b3[8];   // 9 in Montgomery form
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

// --- modular arithmetic ------------------------------------------------------

// a >= p ?
__device__ __forceinline__ bool geq_p(const uint32_t* a, const uint32_t* p) {
#pragma unroll
  for (int j = 7; j >= 0; --j) {
    if (a[j] != p[j]) return a[j] > p[j];
  }
  return true;
}

__device__ __forceinline__ void sub_p_inplace(uint32_t* a, const uint32_t* p) {
  uint32_t br = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t d = (uint64_t)a[j] - (uint64_t)p[j] - br;
    a[j] = (uint32_t)d;
    br = (uint32_t)(d >> 32) & 1u;
  }
}

__device__ __forceinline__ Fe add_mod(const Fe& a, const Fe& b, const FieldParams& fp) {
  Fe r;
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c += (uint64_t)a.w[j] + b.w[j];
    r.w[j] = (uint32_t)c;
    c >>= 32;
  }
  if (c || geq_p(r.w, fp.p)) sub_p_inplace(r.w, fp.p);
  return r;
}

__device__ __forceinline__ Fe sub_mod(const Fe& a, const Fe& b, const FieldParams& fp) {
  Fe r;
  uint32_t br = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t d = (uint64_t)a.w[j] - (uint64_t)b.w[j] - br;
    r.w[j] = (uint32_t)d;
    br = (uint32_t)(d >> 32) & 1u;
  }
  if (br) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c += (uint64_t)r.w[j] + fp.p[j];
      r.w[j] = (uint32_t)c;
      c >>= 32;
    }
  }
  return r;
}

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) acc |= a.w[j];
  return acc == 0;
}

// (-a) mod p, 0 -> 0
__device__ __forceinline__ Fe neg_mod(const Fe& a, const FieldParams& fp) {
  if (fe_is_zero(a)) return a;
  return sub_mod(fe_from(fp.p), a, fp);
}

// CIOS Montgomery product a*b*R^-1 mod p, canonical output
__device__ __forceinline__ Fe mont_mul(const Fe& a, const Fe& b, const FieldParams& fp) {
  uint32_t t[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t C = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      C = (uint64_t)a.w[j] * b.w[i] + t[j] + C;
      t[j] = (uint32_t)C;
      C >>= 32;
    }
    C = (uint64_t)t[8] + C;
    t[8] = (uint32_t)C;
    t[9] = (uint32_t)(C >> 32);
    uint32_t m = t[0] * fp.n0;
    C = ((uint64_t)m * fp.p[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      C = (uint64_t)m * fp.p[j] + t[j] + C;
      t[j - 1] = (uint32_t)C;
      C >>= 32;
    }
    C = (uint64_t)t[8] + C;
    t[7] = (uint32_t)C;
    t[8] = t[9] + (uint32_t)(C >> 32);
  }
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = t[j];
  if (t[8] || geq_p(r.w, fp.p)) sub_p_inplace(r.w, fp.p);
  return r;
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

// RCB15 alg. 8: p + (qx, qy, 1); complete in p, q a real affine point
__device__ __forceinline__ Pt madd(const Pt& p, const Fe& qx, const Fe& qy, const CurveParams& cv) {
  const FieldParams& f = cv.fq;
  const Fe b3 = fe_from(cv.b3);
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
  Fe t2 = mont_mul(b3, p.z, f);
  Fe z3 = add_mod(t1, t2, f);
  t1 = sub_mod(t1, t2, f);
  y3 = mont_mul(b3, y3, f);
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
  const Fe b3 = fe_from(cv.b3);
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
  t2 = mont_mul(b3, t2, f);
  Fe z3 = add_mod(t1, t2, f);
  t1 = sub_mod(t1, t2, f);
  y3 = mont_mul(b3, y3, f);
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

// --- launch helpers ------------------------------------------------------------

static inline unsigned grid_for(long long work, int threads) {
  long long b = (work + threads - 1) / threads;
  if (b > 0x7FFFFFFFLL) b = 0x7FFFFFFFLL;
  return (unsigned)(b < 1 ? 1 : b);
}
