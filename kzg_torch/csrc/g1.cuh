// G1 Jacobian group law over Fp for sm_90a: device functions shared by the
// point kernels (g1_point.cu), the bucket scan (scan_madd.cu), the point
// prefix scan (hs_scan.cu), the bucket reduction (bucket_reduce.cu) and the
// batched-affine MSM (ladder_msm.cu).
//
// The formulas are term for term those of kzg_tpu/ops/curve.py
// (JacobianCurve.double / add / madd) and kzg_tpu/ops/pallas_curve.py
// (_double_pt, _add_pt, _madd_pt, _madd_pt_fast): dbl-2009-l, add-2007-bl,
// madd-2007-bl, with the same exceptional lanes applied in the same order.
// Every field operation is canonical, so the outputs equal the JAX package's
// bit for bit, including the coordinates of points at infinity.
//
// On the TPU the exceptional lanes are selects over whole vectors, and every
// lane pays for the inline doubling. Here the doubling is a branch taken only
// by a lane with P == Q (rare; the warp diverges only then), and the cheap
// cases stay selects. The results are the same.
#pragma once

#include "field.cuh"

namespace kzg {

struct jac_t {
  fp_t x, y, z;
};

__device__ __forceinline__ fp_t fmul(const fp_t& a, const fp_t& b) { return mont_mul<12>(a, b); }
__device__ __forceinline__ fp_t fsqr(const fp_t& a) { return mont_sqr<12>(a); }

// How the point formulas multiply (the Ops of g1_double, g1_add and g1_madd).
// FieldInline, the default: every multiply and square is its own copy of
// the carry chains (16 copies of about 640 instructions an add), more than
// an SM's instruction caches hold, so a warp that runs adds one after
// another waits on instruction fetch. FieldCalled: one out-of-line copy of each, shared by
// every call site, arguments in registers; a chain of dependent adds runs
// in well under half the time (PERF.md, K4). Same words either way.
struct FieldInline {
  static __device__ __forceinline__ fp_t mul(const fp_t& a, const fp_t& b) { return fmul(a, b); }
  static __device__ __forceinline__ fp_t sqr(const fp_t& a) { return fsqr(a); }
};
static __device__ __noinline__ fp_t fmul_called(fp_t a, fp_t b) { return mont_mul<12>(a, b); }
static __device__ __noinline__ fp_t fsqr_called(fp_t a) { return mont_sqr<12>(a); }
struct FieldCalled {
  static __device__ __forceinline__ fp_t mul(const fp_t& a, const fp_t& b) {
    return fmul_called(a, b);
  }
  static __device__ __forceinline__ fp_t sqr(const fp_t& a) { return fsqr_called(a); }
};
__device__ __forceinline__ fp_t fadd(const fp_t& a, const fp_t& b) { return add<12>(a, b); }
__device__ __forceinline__ fp_t fsub(const fp_t& a, const fp_t& b) { return sub<12>(a, b); }
__device__ __forceinline__ fp_t fdbl(const fp_t& a) { return dbl<12>(a); }
__device__ __forceinline__ bool fzero(const fp_t& a) { return is_zero<12>(a); }

__device__ __forceinline__ jac_t jac_inf() {
  jac_t r;
  r.x = zero<12>();
  r.y = zero<12>();
  r.z = zero<12>();
  return r;
}

__device__ __forceinline__ bool jac_is_inf(const jac_t& p) { return fzero(p.z); }

__device__ __forceinline__ fp_t fsel(bool c, const fp_t& a, const fp_t& b) {
  fp_t r;
#pragma unroll
  for (int j = 0; j < 12; j++) r.w[j] = c ? a.w[j] : b.w[j];
  return r;
}

__device__ __forceinline__ jac_t jsel(bool c, const jac_t& a, const jac_t& b) {
  jac_t r;
  r.x = fsel(c, a.x, b.x);
  r.y = fsel(c, a.y, b.y);
  r.z = fsel(c, a.z, b.z);
  return r;
}

// dbl-2009-l (a = 0): 2M + 5S. Maps infinity to infinity.
template <class Ops = FieldInline>
__device__ __forceinline__ jac_t g1_double(const jac_t& p) {
  const fp_t A = Ops::sqr(p.x);
  const fp_t B = Ops::sqr(p.y);
  const fp_t C = Ops::sqr(B);
  const fp_t xb = fadd(p.x, B);
  const fp_t t = Ops::sqr(xb);
  const fp_t D = fdbl(fsub(fsub(t, A), C));
  const fp_t E = fadd(fdbl(A), A);
  const fp_t F = Ops::sqr(E);
  jac_t r;
  r.x = fsub(F, fdbl(D));
  const fp_t eightC = fdbl(fdbl(fdbl(C)));
  r.y = fsub(Ops::mul(E, fsub(D, r.x)), eightC);
  r.z = fdbl(Ops::mul(p.y, p.z));
  return r;
}

// add-2007-bl with the exceptional lanes: 12M + 4S (Z3 as Z1 Z2 2H, as the JAX
// package computes it; the published form's square trick makes it 11M + 5S).
template <class Ops = FieldInline>
__device__ __forceinline__ jac_t g1_add(const jac_t& p, const jac_t& q) {
  const fp_t Z1Z1 = Ops::sqr(p.z);
  const fp_t Z2Z2 = Ops::sqr(q.z);
  const fp_t U1 = Ops::mul(p.x, Z2Z2);
  const fp_t U2 = Ops::mul(q.x, Z1Z1);
  const fp_t S1 = Ops::mul(p.y, Ops::mul(q.z, Z2Z2));
  const fp_t S2 = Ops::mul(q.y, Ops::mul(p.z, Z1Z1));
  const fp_t H = fsub(U2, U1);
  const fp_t H2 = fdbl(H);
  const fp_t I = Ops::sqr(H2);
  const fp_t J = Ops::mul(H, I);
  const fp_t dS = fsub(S2, S1);
  const fp_t r = fdbl(dS);
  const fp_t V = Ops::mul(U1, I);
  jac_t out;
  out.x = fsub(fsub(Ops::sqr(r), J), fdbl(V));
  out.y = fsub(Ops::mul(r, fsub(V, out.x)), fdbl(Ops::mul(S1, J)));
  out.z = Ops::mul(Ops::mul(p.z, q.z), H2);

  const bool same_x = fzero(H);
  const bool same_y = fzero(dS);
  if (same_x && same_y) out = g1_double<Ops>(p);
  out = jsel(same_x && !same_y, jac_inf(), out);
  out = jsel(jac_is_inf(p), q, out);
  out = jsel(jac_is_inf(q), p, out);
  return out;
}

// madd-2007-bl core (Z2 = 1): 8M + 3S (I as (2H)^2 and Z3 as 2H Z1; the
// published form is 7M + 4S). Returns the formula's output and the
// two equality tests the exceptional lanes need.
template <class Ops = FieldInline>
__device__ __forceinline__ jac_t g1_madd_core(const jac_t& p, const fp_t& x2, const fp_t& y2,
                                              bool& same_x, bool& same_y) {
  const fp_t Z1Z1 = Ops::sqr(p.z);
  const fp_t U2 = Ops::mul(x2, Z1Z1);
  const fp_t S2 = Ops::mul(y2, Ops::mul(p.z, Z1Z1));
  const fp_t H = fsub(U2, p.x);
  const fp_t H2 = fdbl(H);
  const fp_t I = Ops::sqr(H2);
  const fp_t J = Ops::mul(H, I);
  const fp_t dS = fsub(S2, p.y);
  const fp_t r = fdbl(dS);
  const fp_t V = Ops::mul(p.x, I);
  jac_t out;
  out.x = fsub(fsub(Ops::sqr(r), J), fdbl(V));
  out.y = fsub(Ops::mul(r, fsub(V, out.x)), fdbl(Ops::mul(p.y, J)));
  out.z = Ops::mul(H2, p.z);
  same_x = fzero(H);
  same_y = fzero(dS);
  return out;
}

// Exact mixed add: P == Q doubles, P == -Q gives infinity, P = infinity
// gives (x2, y2, ONE_MONT) (curve.py:163-169). (x2, y2) must not be infinity.
template <class Ops = FieldInline>
__device__ __forceinline__ jac_t g1_madd(const jac_t& p, const fp_t& x2, const fp_t& y2) {
  bool same_x, same_y;
  jac_t out = g1_madd_core<Ops>(p, x2, y2, same_x, same_y);
  if (same_x && same_y) out = g1_double<Ops>(p);
  out = jsel(same_x && !same_y, jac_inf(), out);
  jac_t q;
  q.x = x2;
  q.y = y2;
  q.z = fp_one();
  return jsel(jac_is_inf(p), q, out);
}

// The 11-mul mixed add without the inline doubling (_madd_pt_fast): a lane
// with P == Q (and P finite) sets needs_double and its output is not the sum;
// every other lane equals g1_madd's output bit for bit.
template <class Ops = FieldInline>
__device__ __forceinline__ jac_t g1_madd_fast(const jac_t& p, const fp_t& x2, const fp_t& y2,
                                              bool& needs_double) {
  bool same_x, same_y;
  jac_t out = g1_madd_core<Ops>(p, x2, y2, same_x, same_y);
  out = jsel(same_x && !same_y, jac_inf(), out);
  const bool z1_inf = jac_is_inf(p);
  jac_t q;
  q.x = x2;
  q.y = y2;
  q.z = fp_one();
  out = jsel(z1_inf, q, out);
  needs_double = same_x && same_y && !z1_inf;
  return out;
}

__device__ __forceinline__ jac_t load_jac(const u32* x, const u32* y, const u32* z,
                                          long long stride, long long i) {
  jac_t r;
  r.x = load<12>(x, stride, i);
  r.y = load<12>(y, stride, i);
  r.z = load<12>(z, stride, i);
  return r;
}

__device__ __forceinline__ void store_jac(u32* x, u32* y, u32* z, long long stride, long long i,
                                          const jac_t& p) {
  store<12>(x, stride, i, p.x);
  store<12>(y, stride, i, p.y);
  store<12>(z, stride, i, p.z);
}

// A point another block wrote before a fence: read from L2 (ld.global.cg),
// past this SM's L1.
__device__ __forceinline__ jac_t load_jac_cg(const jac_t* p) {
  const u32* w = reinterpret_cast<const u32*>(p);
  jac_t r;
  u32* o = reinterpret_cast<u32*>(&r);
#pragma unroll
  for (int j = 0; j < 36; j++) o[j] = __ldcg(w + j);
  return r;
}

}  // namespace kzg
