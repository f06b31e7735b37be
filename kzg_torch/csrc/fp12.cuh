// Fp6 = Fp2[v] / (v^3 - XI) and Fp12 = Fp6[w] / (w^2 - v), XI = 1 + u, for
// sm_90a: the towers of the pairing kernels (pairing.cu, K10 and K11).
//
// The formulas are kzg_tpu/ops/fp6.py's and fp12.py's (Toom / Karatsuba
// Fp6 multiply of six Fp2 products, Karatsuba Fp12 multiply, complex
// squares, the norm inversions), over g2.cuh's Fp2Ops on the out-of-line Fp
// multiply (FieldCalled). Every operation is canonical, so any correct
// grouping gives the plain versions' words (kzg_torch/ops/fp6.py,
// fp12.py) bit for bit.
//
// One thread owns a whole element: 144 words for an Fp12, far more than
// registers hold. So the Fp6 and Fp12 operations are out-of-line functions
// on references (the caller's elements in local memory, cached in L1), and
// only an Fp2 multiply's operands and the few Fp2 values a formula keeps
// live sit in registers. An Fp6 multiply writes its result coefficient by
// coefficient and must not alias an operand; the Fp12 operations form
// their result in temporaries first, so r may alias a or b.
#pragma once

#include "g2.cuh"

namespace kzg {

struct fp6_t {
  fp2_t c[3];
};

struct fp12_t {
  fp6_t c[2];
};

using F2 = Fp2Ops<FieldCalled>;

static __device__ __noinline__ fp2_t f2_mul(fp2_t a, fp2_t b) { return F2::mul(a, b); }
static __device__ __noinline__ fp2_t f2_sqr(fp2_t a) { return F2::sqr(a); }
__device__ __forceinline__ fp2_t f2_add(const fp2_t& a, const fp2_t& b) { return F2::add(a, b); }
__device__ __forceinline__ fp2_t f2_sub(const fp2_t& a, const fp2_t& b) { return F2::sub(a, b); }
__device__ __forceinline__ fp2_t f2_dbl(const fp2_t& a) { return F2::dbl(a); }
__device__ __forceinline__ fp2_t f2_neg(const fp2_t& a) { return F2::sub(F2::zero(), a); }
__device__ __forceinline__ fp2_t f2_conj(const fp2_t& a) {
  return fp2_t{a.c0, fsub(kzg::zero<12>(), a.c1)};
}
// times XI = 1 + u: (c0 - c1, c0 + c1)
__device__ __forceinline__ fp2_t f2_xi(const fp2_t& a) {
  return fp2_t{fsub(a.c0, a.c1), fadd(a.c0, a.c1)};
}
// both components times an Fp element
__device__ __forceinline__ fp2_t f2_mul_fp(const fp2_t& a, const fp_t& k) {
  return fp2_t{FieldCalled::mul(a.c0, k), FieldCalled::mul(a.c1, k)};
}

// 1 / (a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2); zero maps to zero.
static __device__ __noinline__ fp2_t f2_inv(fp2_t a) {
  const fp_t norm = fadd(FieldCalled::mul(a.c0, a.c0), FieldCalled::mul(a.c1, a.c1));
  const fp_t ninv = fermat_inv<12>(norm);
  return fp2_t{FieldCalled::mul(a.c0, ninv),
               fsub(kzg::zero<12>(), FieldCalled::mul(a.c1, ninv))};
}

// -- Fp6 ----------------------------------------------------------------------

__device__ __forceinline__ void fp6_add(fp6_t& r, const fp6_t& a, const fp6_t& b) {
#pragma unroll 1
  for (int k = 0; k < 3; k++) r.c[k] = f2_add(a.c[k], b.c[k]);
}

__device__ __forceinline__ void fp6_sub(fp6_t& r, const fp6_t& a, const fp6_t& b) {
#pragma unroll 1
  for (int k = 0; k < 3; k++) r.c[k] = f2_sub(a.c[k], b.c[k]);
}

__device__ __forceinline__ void fp6_neg(fp6_t& r, const fp6_t& a) {
#pragma unroll 1
  for (int k = 0; k < 3; k++) r.c[k] = f2_neg(a.c[k]);
}

// (c0, c1, c2) -> (XI c2, c0, c1); r may alias a.
__device__ __forceinline__ void fp6_mul_by_v(fp6_t& r, const fp6_t& a) {
  const fp2_t t = f2_xi(a.c[2]);
  r.c[2] = a.c[1];
  r.c[1] = a.c[0];
  r.c[0] = t;
}

// Toom / Karatsuba, six Fp2 products: t_k = a_k b_k;
// c0 = t0 + XI ((a1 + a2)(b1 + b2) - t1 - t2),
// c1 = (a0 + a1)(b0 + b1) - t0 - t1 + XI t2,
// c2 = (a0 + a2)(b0 + b2) - t0 - t2 + t1. r must not alias a or b.
static __device__ __noinline__ void fp6_mul(fp6_t& r, const fp6_t& a, const fp6_t& b) {
  const fp2_t t0 = f2_mul(a.c[0], b.c[0]);
  const fp2_t t1 = f2_mul(a.c[1], b.c[1]);
  const fp2_t t2 = f2_mul(a.c[2], b.c[2]);
  const fp2_t m12 = f2_mul(f2_add(a.c[1], a.c[2]), f2_add(b.c[1], b.c[2]));
  r.c[0] = f2_add(t0, f2_xi(f2_sub(m12, f2_add(t1, t2))));
  const fp2_t m01 = f2_mul(f2_add(a.c[0], a.c[1]), f2_add(b.c[0], b.c[1]));
  r.c[1] = f2_add(f2_sub(m01, f2_add(t0, t1)), f2_xi(t2));
  const fp2_t m02 = f2_mul(f2_add(a.c[0], a.c[2]), f2_add(b.c[0], b.c[2]));
  r.c[2] = f2_add(f2_sub(m02, f2_add(t0, t2)), t1);
}

// kzg_tpu/ops/fp6.py inv: the norm to Fp2, one Fp2 inversion, three
// products. r must not alias a. Zero maps to zero.
static __device__ __noinline__ void fp6_inv(fp6_t& r, const fp6_t& a) {
  const fp2_t t0 = f2_sub(f2_sqr(a.c[0]), f2_xi(f2_mul(a.c[1], a.c[2])));
  const fp2_t t1 = f2_sub(f2_xi(f2_sqr(a.c[2])), f2_mul(a.c[0], a.c[1]));
  const fp2_t t2 = f2_sub(f2_sqr(a.c[1]), f2_mul(a.c[0], a.c[2]));
  const fp2_t denom =
      f2_add(f2_mul(a.c[0], t0), f2_xi(f2_add(f2_mul(a.c[2], t1), f2_mul(a.c[1], t2))));
  const fp2_t f = f2_inv(denom);
  r.c[0] = f2_mul(t0, f);
  r.c[1] = f2_mul(t1, f);
  r.c[2] = f2_mul(t2, f);
}

// -- Fp12 ---------------------------------------------------------------------

// Karatsuba over Fp6: t0 = a0 b0, t1 = a1 b1, tm = (a0 + a1)(b0 + b1);
// c0 = t0 + v t1, c1 = tm - t0 - t1.
static __device__ __noinline__ void fp12_mul(fp12_t& r, const fp12_t& a, const fp12_t& b) {
  fp6_t t0, t1, sa, sb, tm;
  fp6_mul(t0, a.c[0], b.c[0]);
  fp6_mul(t1, a.c[1], b.c[1]);
  fp6_add(sa, a.c[0], a.c[1]);
  fp6_add(sb, b.c[0], b.c[1]);
  fp6_mul(tm, sa, sb);
  fp6_sub(tm, tm, t0);
  fp6_sub(r.c[1], tm, t1);
  fp6_mul_by_v(t1, t1);
  fp6_add(r.c[0], t0, t1);
}

// Complex square: t = a0 a1, s = (a0 + a1)(a0 + v a1);
// c0 = s - t - v t, c1 = 2 t.
static __device__ __noinline__ void fp12_sqr(fp12_t& r, const fp12_t& a) {
  fp6_t t, sa, sb, s;
  fp6_mul(t, a.c[0], a.c[1]);
  fp6_add(sa, a.c[0], a.c[1]);
  fp6_mul_by_v(sb, a.c[1]);
  fp6_add(sb, a.c[0], sb);
  fp6_mul(s, sa, sb);
  fp6_sub(s, s, t);
  fp6_mul_by_v(sa, t);
  fp6_sub(r.c[0], s, sa);
  fp6_add(r.c[1], t, t);
}

// Conjugation (Frobenius^6): (c0, c1) -> (c0, -c1).
__device__ __forceinline__ void fp12_conj(fp12_t& r, const fp12_t& a) {
  r.c[0] = a.c[0];
  fp6_neg(r.c[1], a.c[1]);
}

// (a0 - a1 w) / (a0^2 - v a1^2): one Fp6 inversion. Zero maps to zero.
static __device__ __noinline__ void fp12_inv(fp12_t& r, const fp12_t& a) {
  fp6_t s0, s1, f;
  fp6_mul(s0, a.c[0], a.c[0]);
  fp6_mul(s1, a.c[1], a.c[1]);
  fp6_mul_by_v(s1, s1);
  fp6_sub(s0, s0, s1);
  fp6_inv(f, s0);
  fp6_mul(s0, a.c[0], f);
  fp6_mul(s1, a.c[1], f);
  r.c[0] = s0;
  fp6_neg(r.c[1], s1);
}

// Word j of component c of Fp2 coefficient (k, h) of lane i of an Fp12
// tensor (12, 2, 3, 2, n) at base[(((j * 2 + c) * 3 + k) * 2 + h) * n + i]:
// the layout of kzg_torch/ops/fp12.py, also that of its Frobenius table.
__device__ __forceinline__ fp2_t load12c(const u32* base, long long n, long long i, int k,
                                         int h) {
  fp2_t r;
#pragma unroll
  for (int j = 0; j < 12; j++) {
    r.c0.w[j] = base[(((j * 2) * 3 + k) * 2 + h) * n + i];
    r.c1.w[j] = base[(((j * 2 + 1) * 3 + k) * 2 + h) * n + i];
  }
  return r;
}

__device__ __forceinline__ void store12c(u32* base, long long n, long long i, int k, int h,
                                         const fp2_t& v) {
#pragma unroll
  for (int j = 0; j < 12; j++) {
    base[(((j * 2) * 3 + k) * 2 + h) * n + i] = v.c0.w[j];
    base[(((j * 2 + 1) * 3 + k) * 2 + h) * n + i] = v.c1.w[j];
  }
}

static __device__ __noinline__ void load_fp12(fp12_t& r, const u32* base, long long n,
                                              long long i) {
#pragma unroll 1
  for (int h = 0; h < 2; h++)
#pragma unroll 1
    for (int k = 0; k < 3; k++) r.c[h].c[k] = load12c(base, n, i, k, h);
}

static __device__ __noinline__ void store_fp12(u32* base, long long n, long long i,
                                               const fp12_t& v) {
#pragma unroll 1
  for (int h = 0; h < 2; h++)
#pragma unroll 1
    for (int k = 0; k < 3; k++) store12c(base, n, i, k, h, v.c[h].c[k]);
}

// a^(p^e), e in 1..3: each Fp2 coefficient conjugated if e is odd, then
// times its constant, coefficient (k, h) of lane e - 1 of the table
// (12, 2, 3, 2, 3) that kzg_torch/ops/fp12.py's _frob_table builds (the
// Fp6 and Fp12 constants of the JAX package's Frobenius in one product;
// 1 at (0, 0), which is skipped). r may alias a.
static __device__ __noinline__ void fp12_frob(fp12_t& r, const fp12_t& a, const u32* frob,
                                              int e) {
#pragma unroll 1
  for (int h = 0; h < 2; h++) {
#pragma unroll 1
    for (int k = 0; k < 3; k++) {
      fp2_t x = (e & 1) ? f2_conj(a.c[h].c[k]) : a.c[h].c[k];
      if (h || k) x = f2_mul(x, load12c(frob, 3, e - 1, k, h));
      r.c[h].c[k] = x;
    }
  }
}

}  // namespace kzg
