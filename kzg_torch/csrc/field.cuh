// Montgomery arithmetic over Fp (12 words) and Fr (8 words) for sm_90a.
//
// Values are canonical (< N) u32 words, least significant first, in
// Montgomery form with R = 2^(32 L): R = 2^384 for Fp and 2^256 for Fr, the
// same R as the JAX package, so a value here is the JAX package's 16-bit
// limbs regrouped two at a time. Every operation returns canonical words, so
// any two correct evaluations of one formula agree bit for bit.
//
// The multiply is CIOS (coarsely integrated operand scanning) with 32-bit
// words: L rows of a 32x32->64 multiply-add carry chain for a*b_i, each
// followed by one Montgomery reduction row, then one conditional subtract.
// The 64-bit accumulators compile to IMAD.WIDE.U32 + carry adds. The
// constants below are derived from kzg_torch/utils/hostmath.py, and
// tests/test_torch_field.py checks them against it.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace kzg {

typedef uint32_t u32;
typedef uint64_t u64;

static __constant__ u32 FP_N[12] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
// Montgomery one: 2^384 mod P
static __constant__ u32 FP_ONE[12] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
    0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};
static __constant__ u32 FR_N[8] = {
    0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};

// -N^{-1} mod 2^32
constexpr u32 FP_N0 = 0xfffcfffdu;
constexpr u32 FR_N0 = 0xffffffffu;

template <int L> struct Modulus;
template <> struct Modulus<12> {
  static __device__ __forceinline__ u32 n(int i) { return FP_N[i]; }
  static constexpr u32 n0 = FP_N0;
};
template <> struct Modulus<8> {
  static __device__ __forceinline__ u32 n(int i) { return FR_N[i]; }
  static constexpr u32 n0 = FR_N0;
};

template <int L> struct Elem {
  u32 w[L];
};

typedef Elem<12> fp_t;

// r = t - N if (t + hi * 2^(32L)) >= N, else t; t + hi*2^(32L) < 2N.
template <int L>
__device__ __forceinline__ Elem<L> cond_sub_n(const u32 (&t)[L], u32 hi) {
  Elem<L> d;
  u64 borrow = 0;
#pragma unroll
  for (int j = 0; j < L; j++) {
    u64 diff = (u64)t[j] - Modulus<L>::n(j) - borrow;
    d.w[j] = (u32)diff;
    borrow = diff >> 63;
  }
  const bool take = hi != 0 || borrow == 0;
  Elem<L> r;
#pragma unroll
  for (int j = 0; j < L; j++) r.w[j] = take ? d.w[j] : t[j];
  return r;
}

// a * b * 2^(-32L) mod N, canonical in and out.
template <int L>
__device__ __forceinline__ Elem<L> mont_mul(const Elem<L>& a, const Elem<L>& b) {
  u32 t[L + 2];
#pragma unroll
  for (int j = 0; j < L + 2; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < L; i++) {
    u64 c = 0;
    const u32 bi = b.w[i];
#pragma unroll
    for (int j = 0; j < L; j++) {
      c += (u64)a.w[j] * bi + t[j];
      t[j] = (u32)c;
      c >>= 32;
    }
    c += t[L];
    t[L] = (u32)c;
    t[L + 1] = (u32)(c >> 32);
    const u32 m = t[0] * Modulus<L>::n0;
    c = ((u64)m * Modulus<L>::n(0) + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < L; j++) {
      c += (u64)m * Modulus<L>::n(j) + t[j];
      t[j - 1] = (u32)c;
      c >>= 32;
    }
    c += t[L];
    t[L - 1] = (u32)c;
    t[L] = t[L + 1] + (u32)(c >> 32);
  }
  u32 lo[L];
#pragma unroll
  for (int j = 0; j < L; j++) lo[j] = t[j];
  return cond_sub_n<L>(lo, t[L]);
}

template <int L>
__device__ __forceinline__ Elem<L> add(const Elem<L>& a, const Elem<L>& b) {
  u32 s[L];
  u64 c = 0;
#pragma unroll
  for (int j = 0; j < L; j++) {
    c += (u64)a.w[j] + b.w[j];
    s[j] = (u32)c;
    c >>= 32;
  }
  return cond_sub_n<L>(s, (u32)c);
}

template <int L>
__device__ __forceinline__ Elem<L> sub(const Elem<L>& a, const Elem<L>& b) {
  Elem<L> d;
  u64 borrow = 0;
#pragma unroll
  for (int j = 0; j < L; j++) {
    u64 diff = (u64)a.w[j] - b.w[j] - borrow;
    d.w[j] = (u32)diff;
    borrow = diff >> 63;
  }
  // on a borrow add N back (the carry out of the top word is dropped)
  const u32 mask = 0u - (u32)borrow;
  u64 c = 0;
#pragma unroll
  for (int j = 0; j < L; j++) {
    c += (u64)d.w[j] + (Modulus<L>::n(j) & mask);
    d.w[j] = (u32)c;
    c >>= 32;
  }
  return d;
}

template <int L>
__device__ __forceinline__ Elem<L> dbl(const Elem<L>& a) {
  return add<L>(a, a);
}

template <int L>
__device__ __forceinline__ bool is_zero(const Elem<L>& a) {
  u32 acc = 0;
#pragma unroll
  for (int j = 0; j < L; j++) acc |= a.w[j];
  return acc == 0;
}

template <int L>
__device__ __forceinline__ Elem<L> zero() {
  Elem<L> r;
#pragma unroll
  for (int j = 0; j < L; j++) r.w[j] = 0;
  return r;
}

__device__ __forceinline__ fp_t fp_one() {
  fp_t r;
#pragma unroll
  for (int j = 0; j < 12; j++) r.w[j] = FP_ONE[j];
  return r;
}

// Limb-major global layout: word j of lane i at base[j * stride + i].
template <int L>
__device__ __forceinline__ Elem<L> load(const u32* base, long long stride, long long i) {
  Elem<L> r;
#pragma unroll
  for (int j = 0; j < L; j++) r.w[j] = base[j * stride + i];
  return r;
}

template <int L>
__device__ __forceinline__ void store(u32* base, long long stride, long long i, const Elem<L>& v) {
#pragma unroll
  for (int j = 0; j < L; j++) base[j * stride + i] = v.w[j];
}

}  // namespace kzg
