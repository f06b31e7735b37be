// Jacobian group law for sm_90a, over Fp (G1) and, with g2.cuh's Fp2Ops,
// over Fp2 (G2): device functions shared by the point kernels (g1_point.cu,
// g2_point.cu), the bucket scan (scan_madd.cu), the point prefix scan
// (hs_scan.cu), the bucket reduction (bucket_reduce.cu), the batched-affine
// MSM (ladder_msm.cu), the scalar multiplications (mul_ladder.cu), the window
// fold (gen_fold.cu) and the doubling chain (dbl_chain.cu).
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

// A Jacobian point over the element type E: fp_t for G1, fp2_t for G2
// (g2.cuh).
template <class E>
struct jac_of {
  E x, y, z;
};
using jac_t = jac_of<fp_t>;

__device__ __forceinline__ fp_t fmul(const fp_t& a, const fp_t& b) { return mont_mul<12>(a, b); }
__device__ __forceinline__ fp_t fsqr(const fp_t& a) { return mont_sqr<12>(a); }
__device__ __forceinline__ fp_t fadd(const fp_t& a, const fp_t& b) { return add<12>(a, b); }
__device__ __forceinline__ fp_t fsub(const fp_t& a, const fp_t& b) { return sub<12>(a, b); }
__device__ __forceinline__ fp_t fdbl(const fp_t& a) { return dbl<12>(a); }
__device__ __forceinline__ bool fzero(const fp_t& a) { return is_zero<12>(a); }

__device__ __forceinline__ fp_t fsel(bool c, const fp_t& a, const fp_t& b) {
  fp_t r;
#pragma unroll
  for (int j = 0; j < 12; j++) r.w[j] = c ? a.w[j] : b.w[j];
  return r;
}

// The point formulas below take their arithmetic from Ops: the element type
// (Ops::elem), its multiply and square, and its linear operations, selects,
// zero test and constants. For G1, FpLinear's and one of:
// FieldInline, the default: every multiply and square is its own copy of
// the carry chains (16 copies of about 640 instructions an add), more than
// an SM's instruction caches hold, so a warp that runs adds one after
// another waits on instruction fetch. FieldCalled: one out-of-line copy of each, shared by
// every call site, arguments in registers; a chain of dependent adds runs
// in well under half the time (PERF.md, K4). Same words either way. For
// G2, g2.cuh's Fp2Ops over one of them.
struct FpLinear {
  using elem = fp_t;
  static __device__ __forceinline__ fp_t add(const fp_t& a, const fp_t& b) { return fadd(a, b); }
  static __device__ __forceinline__ fp_t sub(const fp_t& a, const fp_t& b) { return fsub(a, b); }
  static __device__ __forceinline__ fp_t dbl(const fp_t& a) { return fdbl(a); }
  static __device__ __forceinline__ bool is_zero(const fp_t& a) { return fzero(a); }
  static __device__ __forceinline__ fp_t sel(bool c, const fp_t& a, const fp_t& b) {
    return fsel(c, a, b);
  }
  static __device__ __forceinline__ fp_t zero() { return kzg::zero<12>(); }
  static __device__ __forceinline__ fp_t one() { return fp_one(); }
};
struct FieldInline : FpLinear {
  static __device__ __forceinline__ fp_t mul(const fp_t& a, const fp_t& b) { return fmul(a, b); }
  static __device__ __forceinline__ fp_t sqr(const fp_t& a) { return fsqr(a); }
};
static __device__ __noinline__ fp_t fmul_called(fp_t a, fp_t b) { return mont_mul<12>(a, b); }
static __device__ __noinline__ fp_t fsqr_called(fp_t a) { return mont_sqr<12>(a); }
struct FieldCalled : FpLinear {
  static __device__ __forceinline__ fp_t mul(const fp_t& a, const fp_t& b) {
    return fmul_called(a, b);
  }
  static __device__ __forceinline__ fp_t sqr(const fp_t& a) { return fsqr_called(a); }
};

// Infinity (the zero words), its test and a select, over Ops's element.
template <class Ops, class P>
__device__ __forceinline__ P pt_inf() {
  return P{Ops::zero(), Ops::zero(), Ops::zero()};
}

template <class Ops, class P>
__device__ __forceinline__ bool pt_is_inf(const P& p) {
  return Ops::is_zero(p.z);
}

template <class Ops, class P>
__device__ __forceinline__ P pt_sel(bool c, const P& a, const P& b) {
  return P{Ops::sel(c, a.x, b.x), Ops::sel(c, a.y, b.y), Ops::sel(c, a.z, b.z)};
}

__device__ __forceinline__ jac_t jac_inf() { return pt_inf<FpLinear, jac_t>(); }
__device__ __forceinline__ bool jac_is_inf(const jac_t& p) { return pt_is_inf<FpLinear>(p); }
__device__ __forceinline__ jac_t jsel(bool c, const jac_t& a, const jac_t& b) {
  return pt_sel<FpLinear>(c, a, b);
}

// dbl-2009-l (a = 0): 2M + 5S. Maps infinity to infinity.
template <class Ops = FieldInline, class P = jac_of<typename Ops::elem>>
__device__ __forceinline__ P jac_double(const P& p) {
  using El = typename Ops::elem;
  const El A = Ops::sqr(p.x);
  const El B = Ops::sqr(p.y);
  const El C = Ops::sqr(B);
  const El xb = Ops::add(p.x, B);
  const El t = Ops::sqr(xb);
  const El D = Ops::dbl(Ops::sub(Ops::sub(t, A), C));
  const El E = Ops::add(Ops::dbl(A), A);
  const El F = Ops::sqr(E);
  P r;
  r.x = Ops::sub(F, Ops::dbl(D));
  const El eightC = Ops::dbl(Ops::dbl(Ops::dbl(C)));
  r.y = Ops::sub(Ops::mul(E, Ops::sub(D, r.x)), eightC);
  r.z = Ops::dbl(Ops::mul(p.y, p.z));
  return r;
}

// The equal-x lanes' doubling (P == Q): out becomes 2 p where need. With
// kWarp false, a branch of the lanes that need it (rare; the warp diverges
// only then). With kWarp true, computed by a whole warp that has such a lane
// (__any_sync): every thread of the warp must reach it.
template <class Ops, bool kWarp, class P>
__device__ __forceinline__ void double_where(bool need, const P& p, P& out) {
  if (kWarp) {
    if (__any_sync(0xffffffffu, need)) {
      const P d = jac_double<Ops>(p);
      if (need) out = d;
    }
  } else if (need) {
    out = jac_double<Ops>(p);
  }
}

// add-2007-bl with the exceptional lanes: 12M + 4S (Z3 as Z1 Z2 2H, as the JAX
// package computes it; the published form's square trick makes it 11M + 5S).
// The equal-x tests are taken as soon as H and dS exist, so that U2, S2 and
// dS do not stay live across the later multiplies: over Fp2, taken after
// the formula, they made K9's add spill (scripts/g2_point_probe.py).
template <class Ops = FieldInline, bool kWarp = false, class P = jac_of<typename Ops::elem>>
__device__ __forceinline__ P jac_add(const P& p, const P& q) {
  using El = typename Ops::elem;
  const El Z1Z1 = Ops::sqr(p.z);
  const El Z2Z2 = Ops::sqr(q.z);
  const El U1 = Ops::mul(p.x, Z2Z2);
  const El H = Ops::sub(Ops::mul(q.x, Z1Z1), U1);
  const bool same_x = Ops::is_zero(H);
  const El S1 = Ops::mul(p.y, Ops::mul(q.z, Z2Z2));
  const El dS = Ops::sub(Ops::mul(q.y, Ops::mul(p.z, Z1Z1)), S1);
  const bool same_y = Ops::is_zero(dS);
  const El H2 = Ops::dbl(H);
  const El I = Ops::sqr(H2);
  const El J = Ops::mul(H, I);
  const El r = Ops::dbl(dS);
  const El V = Ops::mul(U1, I);
  P out;
  out.x = Ops::sub(Ops::sub(Ops::sqr(r), J), Ops::dbl(V));
  out.y = Ops::sub(Ops::mul(r, Ops::sub(V, out.x)), Ops::dbl(Ops::mul(S1, J)));
  out.z = Ops::mul(Ops::mul(p.z, q.z), H2);
  double_where<Ops, kWarp>(same_x && same_y, p, out);
  out = pt_sel<Ops>(same_x && !same_y, pt_inf<Ops, P>(), out);
  out = pt_sel<Ops>(pt_is_inf<Ops>(p), q, out);
  out = pt_sel<Ops>(pt_is_inf<Ops>(q), p, out);
  return out;
}

// madd-2007-bl core (Z2 = 1): 8M + 3S (I as (2H)^2 and Z3 as 2H Z1; the
// published form is 7M + 4S). Returns the formula's output and the
// two equality tests the exceptional lanes need.
template <class Ops = FieldInline, class P = jac_of<typename Ops::elem>,
          class El = typename Ops::elem>
__device__ __forceinline__ P jac_madd_core(const P& p, const El& x2, const El& y2, bool& same_x,
                                           bool& same_y) {
  const El Z1Z1 = Ops::sqr(p.z);
  const El U2 = Ops::mul(x2, Z1Z1);
  const El S2 = Ops::mul(y2, Ops::mul(p.z, Z1Z1));
  const El H = Ops::sub(U2, p.x);
  const El H2 = Ops::dbl(H);
  const El I = Ops::sqr(H2);
  const El J = Ops::mul(H, I);
  const El dS = Ops::sub(S2, p.y);
  const El r = Ops::dbl(dS);
  const El V = Ops::mul(p.x, I);
  P out;
  out.x = Ops::sub(Ops::sub(Ops::sqr(r), J), Ops::dbl(V));
  out.y = Ops::sub(Ops::mul(r, Ops::sub(V, out.x)), Ops::dbl(Ops::mul(p.y, J)));
  out.z = Ops::mul(H2, p.z);
  same_x = Ops::is_zero(H);
  same_y = Ops::is_zero(dS);
  return out;
}

// Exact mixed add: P == Q doubles, P == -Q gives infinity, P = infinity
// gives (x2, y2, ONE_MONT) (curve.py:163-169). (x2, y2) must not be infinity.
template <class Ops = FieldInline, bool kWarp = false, class P = jac_of<typename Ops::elem>,
          class El = typename Ops::elem>
__device__ __forceinline__ P jac_madd(const P& p, const El& x2, const El& y2) {
  bool same_x, same_y;
  P out = jac_madd_core<Ops>(p, x2, y2, same_x, same_y);
  double_where<Ops, kWarp>(same_x && same_y, p, out);
  out = pt_sel<Ops>(same_x && !same_y, pt_inf<Ops, P>(), out);
  P q;
  q.x = x2;
  q.y = y2;
  q.z = Ops::one();
  return pt_sel<Ops>(pt_is_inf<Ops>(p), q, out);
}

// The 11-mul mixed add without the inline doubling (_madd_pt_fast): a lane
// with P == Q (and P finite) sets needs_double and its output is not the sum;
// every other lane equals jac_madd's output bit for bit.
template <class Ops = FieldInline, class P = jac_of<typename Ops::elem>,
          class El = typename Ops::elem>
__device__ __forceinline__ P jac_madd_fast(const P& p, const El& x2, const El& y2,
                                           bool& needs_double) {
  bool same_x, same_y;
  P out = jac_madd_core<Ops>(p, x2, y2, same_x, same_y);
  out = pt_sel<Ops>(same_x && !same_y, pt_inf<Ops, P>(), out);
  const bool z1_inf = pt_is_inf<Ops>(p);
  P q;
  q.x = x2;
  q.y = y2;
  q.z = Ops::one();
  out = pt_sel<Ops>(z1_inf, q, out);
  needs_double = same_x && same_y && !z1_inf;
  return out;
}

// One step of the MSB-first double-and-add ladder with mixed adds, on one
// lane's values in shared memory (the batched MSM, ladder_msm.cu, and the
// scalar multiplications, mul_ladder.cu): acc = 2 acc, then acc + (px, py)
// kept where bit b of the lane's scalar word is set. The madd is the
// 11-multiply one; a lane at acc == P needs the doubling instead, and its
// warp computes that only when one of its lanes needs it, so the step's
// output is the exact madd's. With kSkipClear a warp none of whose lanes
// has the bit set skips the madd, which every lane of it would drop. Every
// thread of the warp must reach the step. The empty asm statements keep the
// values in shared memory across the out-of-line multiplies, not in
// registers.
template <class Ops, bool kSkipClear, class P, class El>
__device__ __forceinline__ void ladder_step(P& acc, P& sum, const El& px, const El& py,
                                            const u32& word, int b) {
  acc = jac_double<Ops>(acc);
  asm volatile("" ::: "memory");
  if (kSkipClear && !__any_sync(0xffffffffu, (word >> (b & 31)) & 1u)) return;
  bool need;
  sum = jac_madd_fast<Ops>(acc, px, py, need);
  asm volatile("" ::: "memory");
  if (__any_sync(0xffffffffu, need)) {
    const P d = jac_double<Ops>(acc);
    if (need) sum = d;
    asm volatile("" ::: "memory");
  }
  if ((word >> (b & 31)) & 1u) acc = sum;
  asm volatile("" ::: "memory");
}

// One step of the signed-digit (NAF) ladder (mul_ladder.cu's Mode A), on one
// lane's values in shared memory: acc = 2 acc, then acc + (px, py) where
// digit b of the lane's scalar is +1 (bit b of plus) and acc + (px, ny),
// ny = -py, where it is -1 (bit b of minus); a negative digit costs no more
// than a positive one on an affine base. The madd and its warp-uniform
// doubling are ladder_step's, so acc == P and acc == -P lanes (a point
// outside the subgroup reaches them) give the exact madd's words. A warp
// none of whose lanes has a non-zero digit b skips the madd: with one scalar
// for every lane that is every step with a zero digit, and no warp diverges.
// Every thread of the warp must reach the step.
template <class Ops, class P, class El>
__device__ __forceinline__ void naf_step(P& acc, P& sum, const El& px, const El& py,
                                         const El& ny, u32 plus, u32 minus, int b) {
  acc = jac_double<Ops>(acc);
  asm volatile("" ::: "memory");
  const u32 bit = 1u << (b & 31);
  const bool take = ((plus | minus) & bit) != 0;
  if (!__any_sync(0xffffffffu, take)) return;
  bool need;
  sum = jac_madd_fast<Ops>(acc, px, (minus & bit) ? ny : py, need);
  asm volatile("" ::: "memory");
  if (__any_sync(0xffffffffu, need)) {
    const P d = jac_double<Ops>(acc);
    if (need) sum = d;
    asm volatile("" ::: "memory");
  }
  if (take) acc = sum;
  asm volatile("" ::: "memory");
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
