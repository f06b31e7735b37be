// Fp2 = Fp[u] / (u^2 + 1) for sm_90a: the element of G2's coordinates and
// Fp2Ops, the arithmetic g1.cuh's point formulas take for G2 (K9,
// g2_point.cu).
//
// An Fp2 multiply is three Fp products (Karatsuba), a square two (the
// complex square), as kzg_tpu/ops/fp2.py computes them, each through the
// Fp multiply of Base (g1.cuh's FieldCalled or FieldInline). Every
// operation is canonical, so G2's outputs equal the JAX package's and the
// plain versions' (kzg_torch/ops/curve.py g2_*_plain) bit for bit,
// including the coordinates of points at infinity.
#pragma once

#include "g1.cuh"

namespace kzg {

struct fp2_t {
  fp_t c0, c1;
};

using jac2_t = jac_of<fp2_t>;

template <class Base>
struct Fp2Ops {
  using elem = fp2_t;
  // Karatsuba: v0 = a0 b0, v1 = a1 b1, v2 = (a0 + a1)(b0 + b1);
  // c0 = v0 - v1, c1 = v2 - (v0 + v1) (u^2 = -1).
  static __device__ __forceinline__ fp2_t mul(const fp2_t& a, const fp2_t& b) {
    const fp_t v0 = Base::mul(a.c0, b.c0);
    const fp_t v1 = Base::mul(a.c1, b.c1);
    const fp_t v2 = Base::mul(fadd(a.c0, a.c1), fadd(b.c0, b.c1));
    return fp2_t{fsub(v0, v1), fsub(v2, fadd(v0, v1))};
  }
  // c0 = (a0 + a1)(a0 - a1), c1 = 2 a0 a1.
  static __device__ __forceinline__ fp2_t sqr(const fp2_t& a) {
    return fp2_t{Base::mul(fadd(a.c0, a.c1), fsub(a.c0, a.c1)), Base::mul(fdbl(a.c0), a.c1)};
  }
  static __device__ __forceinline__ fp2_t add(const fp2_t& a, const fp2_t& b) {
    return fp2_t{fadd(a.c0, b.c0), fadd(a.c1, b.c1)};
  }
  static __device__ __forceinline__ fp2_t sub(const fp2_t& a, const fp2_t& b) {
    return fp2_t{fsub(a.c0, b.c0), fsub(a.c1, b.c1)};
  }
  static __device__ __forceinline__ fp2_t dbl(const fp2_t& a) {
    return fp2_t{fdbl(a.c0), fdbl(a.c1)};
  }
  static __device__ __forceinline__ bool is_zero(const fp2_t& a) {
    return fzero(a.c0) && fzero(a.c1);
  }
  static __device__ __forceinline__ fp2_t sel(bool c, const fp2_t& a, const fp2_t& b) {
    return fp2_t{fsel(c, a.c0, b.c0), fsel(c, a.c1, b.c1)};
  }
  static __device__ __forceinline__ fp2_t zero() {
    return fp2_t{kzg::zero<12>(), kzg::zero<12>()};
  }
  static __device__ __forceinline__ fp2_t one() { return fp2_t{fp_one(), kzg::zero<12>()}; }
};

// Layout of an Fp2 coordinate: (12, 2, n) int32, word j of component c of
// lane i at base[(2 j + c) n + i].
__device__ __forceinline__ fp2_t load2(const u32* base, long long n, long long i) {
  return fp2_t{load<12>(base, 2 * n, i), load<12>(base + n, 2 * n, i)};
}

__device__ __forceinline__ void store2(u32* base, long long n, long long i, const fp2_t& v) {
  store<12>(base, 2 * n, i, v.c0);
  store<12>(base + n, 2 * n, i, v.c1);
}

}  // namespace kzg
