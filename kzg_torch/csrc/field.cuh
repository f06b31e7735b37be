// Montgomery arithmetic over Fp (12 words) and Fr (8 words) for sm_90a.
//
// Values are canonical (< N) u32 words, least significant first, in
// Montgomery form with R = 2^(32 L): R = 2^384 for Fp and 2^256 for Fr, the
// same R as the JAX package, so a value here is the JAX package's 16-bit
// limbs regrouped two at a time. Every operation returns canonical words, so
// any two correct evaluations of one formula agree bit for bit.
//
// The multiply is CIOS (coarsely integrated operand scanning) with 32-bit
// words: L rows, each t += a * b_i and then one Montgomery reduction row
// t += m N (m = t_0 * -N^-1 mod 2^32) and a one-word shift, then one
// conditional subtract. Every row is four PTX carry chains (Ptx<L> below):
// mad.lo.cc / madc.lo.cc for the low halves of the word products, then
// mad.hi.cc / madc.hi.cc for the high halves one word up, and the same two
// for m N with N as immediates: about 4 L^2 32-bit multiply-adds and no
// 64-bit accumulator, so no IMAD.WIDE and no separate carry adds or shifts.
// The add, the subtract and the conditional subtract are carry chains too.
// An Fp square (mont_sqr<12>, five of the seven products of a doubling)
// forms the 24-word a^2 from the 78 distinct word products (a multiply
// takes 144) and then reduces it: about 468 multiply-adds against 600.
// Each chain is one asm block: the carry flag does not survive C code between
// asm statements. The constants are derived from kzg_torch/utils/hostmath.py,
// and tests/test_torch_field.py checks them (and interprets the chains)
// against it.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace kzg {

typedef uint32_t u32;

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
// Montgomery one: 2^256 mod R
static __constant__ u32 FR_ONE[8] = {
    0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau,
    0xecbc4ff5u, 0x998c4fefu, 0xacc5056fu, 0x1824b159u};
// Fermat exponents N - 2 (fermat_inv below)
static __constant__ u32 FP_PM2[12] = {
    0xffffaaa9u, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
static __constant__ u32 FR_PM2[8] = {
    0xffffffffu, 0xfffffffeu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};

// -N^{-1} mod 2^32
constexpr u32 FP_N0 = 0xfffcfffdu;
constexpr u32 FR_N0 = 0xffffffffu;

template <int L> struct Modulus;
template <> struct Modulus<12> {
  static __device__ __forceinline__ u32 n(int i) { return FP_N[i]; }
  static __device__ __forceinline__ u32 one(int i) { return FP_ONE[i]; }
  static __device__ __forceinline__ u32 pm2(int i) { return FP_PM2[i]; }
  static constexpr u32 n0 = FP_N0;
};
template <> struct Modulus<8> {
  static __device__ __forceinline__ u32 n(int i) { return FR_N[i]; }
  static __device__ __forceinline__ u32 one(int i) { return FR_ONE[i]; }
  static __device__ __forceinline__ u32 pm2(int i) { return FR_PM2[i]; }
  static constexpr u32 n0 = FR_N0;
};

template <int L> struct Elem {
  u32 w[L];
};

typedef Elem<12> fp_t;

// Carry-chain primitives for L = 12 and L = 8, one asm block per chain.
template <int L> struct Ptx;

template <> struct Ptx<12> {
  // t[0..12] += a * b; t[12] is written, not read (t < 2N before)
  static __device__ __forceinline__ void mul_row(u32 (&t)[13], const u32 (&a)[12], u32 b) {
    asm volatile(
        "mad.lo.cc.u32 %0, %13, %25, %0;\n\t"
        "madc.lo.cc.u32 %1, %14, %25, %1;\n\t"
        "madc.lo.cc.u32 %2, %15, %25, %2;\n\t"
        "madc.lo.cc.u32 %3, %16, %25, %3;\n\t"
        "madc.lo.cc.u32 %4, %17, %25, %4;\n\t"
        "madc.lo.cc.u32 %5, %18, %25, %5;\n\t"
        "madc.lo.cc.u32 %6, %19, %25, %6;\n\t"
        "madc.lo.cc.u32 %7, %20, %25, %7;\n\t"
        "madc.lo.cc.u32 %8, %21, %25, %8;\n\t"
        "madc.lo.cc.u32 %9, %22, %25, %9;\n\t"
        "madc.lo.cc.u32 %10, %23, %25, %10;\n\t"
        "madc.lo.cc.u32 %11, %24, %25, %11;\n\t"
        "addc.u32 %12, 0, 0;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
          "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "=r"(t[12])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
          "r"(a[8]), "r"(a[9]), "r"(a[10]), "r"(a[11]), "r"(b));
    asm volatile(
        "mad.hi.cc.u32 %0, %12, %24, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %24, %1;\n\t"
        "madc.hi.cc.u32 %2, %14, %24, %2;\n\t"
        "madc.hi.cc.u32 %3, %15, %24, %3;\n\t"
        "madc.hi.cc.u32 %4, %16, %24, %4;\n\t"
        "madc.hi.cc.u32 %5, %17, %24, %5;\n\t"
        "madc.hi.cc.u32 %6, %18, %24, %6;\n\t"
        "madc.hi.cc.u32 %7, %19, %24, %7;\n\t"
        "madc.hi.cc.u32 %8, %20, %24, %8;\n\t"
        "madc.hi.cc.u32 %9, %21, %24, %9;\n\t"
        "madc.hi.cc.u32 %10, %22, %24, %10;\n\t"
        "madc.hi.u32 %11, %23, %24, %11;"
        : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]),
          "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
          "r"(a[8]), "r"(a[9]), "r"(a[10]), "r"(a[11]), "r"(b));
  }
  // t[0..12] += m * N (t[0] becomes 0)
  static __device__ __forceinline__ void red_row(u32 (&t)[13], u32 m) {
    asm volatile(
        "mad.lo.cc.u32 %0, %13, 0xffffaaab, %0;\n\t"
        "madc.lo.cc.u32 %1, %13, 0xb9feffff, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, 0xb153ffff, %2;\n\t"
        "madc.lo.cc.u32 %3, %13, 0x1eabfffe, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, 0xf6b0f624, %4;\n\t"
        "madc.lo.cc.u32 %5, %13, 0x6730d2a0, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, 0xf38512bf, %6;\n\t"
        "madc.lo.cc.u32 %7, %13, 0x64774b84, %7;\n\t"
        "madc.lo.cc.u32 %8, %13, 0x434bacd7, %8;\n\t"
        "madc.lo.cc.u32 %9, %13, 0x4b1ba7b6, %9;\n\t"
        "madc.lo.cc.u32 %10, %13, 0x397fe69a, %10;\n\t"
        "madc.lo.cc.u32 %11, %13, 0x1a0111ea, %11;\n\t"
        "addc.u32 %12, %12, 0;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
          "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12])
        : "r"(m));
    asm volatile(
        "mad.hi.cc.u32 %0, %12, 0xffffaaab, %0;\n\t"
        "madc.hi.cc.u32 %1, %12, 0xb9feffff, %1;\n\t"
        "madc.hi.cc.u32 %2, %12, 0xb153ffff, %2;\n\t"
        "madc.hi.cc.u32 %3, %12, 0x1eabfffe, %3;\n\t"
        "madc.hi.cc.u32 %4, %12, 0xf6b0f624, %4;\n\t"
        "madc.hi.cc.u32 %5, %12, 0x6730d2a0, %5;\n\t"
        "madc.hi.cc.u32 %6, %12, 0xf38512bf, %6;\n\t"
        "madc.hi.cc.u32 %7, %12, 0x64774b84, %7;\n\t"
        "madc.hi.cc.u32 %8, %12, 0x434bacd7, %8;\n\t"
        "madc.hi.cc.u32 %9, %12, 0x4b1ba7b6, %9;\n\t"
        "madc.hi.cc.u32 %10, %12, 0x397fe69a, %10;\n\t"
        "madc.hi.u32 %11, %12, 0x1a0111ea, %11;"
        : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]),
          "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12])
        : "r"(m));
  }
  // d (with the word hi above it) -= N; returns hi minus the borrow, which
  // is negative as an int exactly when d + hi 2^(32L) < N
  static __device__ __forceinline__ u32 sub_n(u32 (&d)[12], u32 hi) {
    u32 r;
    asm volatile(
        "sub.cc.u32 %0, %0, 0xffffaaab;\n\t"
        "subc.cc.u32 %1, %1, 0xb9feffff;\n\t"
        "subc.cc.u32 %2, %2, 0xb153ffff;\n\t"
        "subc.cc.u32 %3, %3, 0x1eabfffe;\n\t"
        "subc.cc.u32 %4, %4, 0xf6b0f624;\n\t"
        "subc.cc.u32 %5, %5, 0x6730d2a0;\n\t"
        "subc.cc.u32 %6, %6, 0xf38512bf;\n\t"
        "subc.cc.u32 %7, %7, 0x64774b84;\n\t"
        "subc.cc.u32 %8, %8, 0x434bacd7;\n\t"
        "subc.cc.u32 %9, %9, 0x4b1ba7b6;\n\t"
        "subc.cc.u32 %10, %10, 0x397fe69a;\n\t"
        "subc.cc.u32 %11, %11, 0x1a0111ea;\n\t"
        "subc.u32 %12, %13, 0;"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "=r"(r)
        : "r"(hi));
    return r;
  }
  // s += b; returns the carry out
  static __device__ __forceinline__ u32 add(u32 (&s)[12], const u32 (&b)[12]) {
    u32 c;
    asm volatile(
        "add.cc.u32 %0, %0, %13;\n\t"
        "addc.cc.u32 %1, %1, %14;\n\t"
        "addc.cc.u32 %2, %2, %15;\n\t"
        "addc.cc.u32 %3, %3, %16;\n\t"
        "addc.cc.u32 %4, %4, %17;\n\t"
        "addc.cc.u32 %5, %5, %18;\n\t"
        "addc.cc.u32 %6, %6, %19;\n\t"
        "addc.cc.u32 %7, %7, %20;\n\t"
        "addc.cc.u32 %8, %8, %21;\n\t"
        "addc.cc.u32 %9, %9, %22;\n\t"
        "addc.cc.u32 %10, %10, %23;\n\t"
        "addc.cc.u32 %11, %11, %24;\n\t"
        "addc.u32 %12, 0, 0;"
        : "+r"(s[0]), "+r"(s[1]), "+r"(s[2]), "+r"(s[3]), "+r"(s[4]), "+r"(s[5]), "+r"(s[6]),
          "+r"(s[7]), "+r"(s[8]), "+r"(s[9]), "+r"(s[10]), "+r"(s[11]), "=r"(c)
        : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]),
          "r"(b[8]), "r"(b[9]), "r"(b[10]), "r"(b[11]));
    return c;
  }
  // d -= b; returns 0, or all ones on a borrow
  static __device__ __forceinline__ u32 sub(u32 (&d)[12], const u32 (&b)[12]) {
    u32 r;
    asm volatile(
        "sub.cc.u32 %0, %0, %13;\n\t"
        "subc.cc.u32 %1, %1, %14;\n\t"
        "subc.cc.u32 %2, %2, %15;\n\t"
        "subc.cc.u32 %3, %3, %16;\n\t"
        "subc.cc.u32 %4, %4, %17;\n\t"
        "subc.cc.u32 %5, %5, %18;\n\t"
        "subc.cc.u32 %6, %6, %19;\n\t"
        "subc.cc.u32 %7, %7, %20;\n\t"
        "subc.cc.u32 %8, %8, %21;\n\t"
        "subc.cc.u32 %9, %9, %22;\n\t"
        "subc.cc.u32 %10, %10, %23;\n\t"
        "subc.cc.u32 %11, %11, %24;\n\t"
        "subc.u32 %12, 0, 0;"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "=r"(r)
        : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]),
          "r"(b[8]), "r"(b[9]), "r"(b[10]), "r"(b[11]));
    return r;
  }
  // t[0..23] = a^2: the products a_i a_k (i < k) row by row, doubled,
  // then the squares a_i^2 on the diagonal. Row i's chains end in a word no
  // earlier row wrote, and every word of t is written before it is read.
  static __device__ __forceinline__ void sqr_wide(u32 (&t)[24], const u32 (&a)[12]) {
    u32 c, junk;
#pragma unroll
    for (int k = 1; k < 12; k++) t[k] = a[0] * a[k];
    asm volatile(
        "mad.hi.cc.u32 %0, %11, %12, %0;\n\t"
        "madc.hi.cc.u32 %1, %11, %13, %1;\n\t"
        "madc.hi.cc.u32 %2, %11, %14, %2;\n\t"
        "madc.hi.cc.u32 %3, %11, %15, %3;\n\t"
        "madc.hi.cc.u32 %4, %11, %16, %4;\n\t"
        "madc.hi.cc.u32 %5, %11, %17, %5;\n\t"
        "madc.hi.cc.u32 %6, %11, %18, %6;\n\t"
        "madc.hi.cc.u32 %7, %11, %19, %7;\n\t"
        "madc.hi.cc.u32 %8, %11, %20, %8;\n\t"
        "madc.hi.cc.u32 %9, %11, %21, %9;\n\t"
        "madc.hi.u32 %10, %11, %22, 0;"
        : "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]),
          "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "=r"(t[12])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
          "r"(a[8]), "r"(a[9]), "r"(a[10]), "r"(a[11]));
    asm volatile(
        "mad.lo.cc.u32 %0, %11, %12, %0;\n\t"
        "madc.lo.cc.u32 %1, %11, %13, %1;\n\t"
        "madc.lo.cc.u32 %2, %11, %14, %2;\n\t"
        "madc.lo.cc.u32 %3, %11, %15, %3;\n\t"
        "madc.lo.cc.u32 %4, %11, %16, %4;\n\t"
        "madc.lo.cc.u32 %5, %11, %17, %5;\n\t"
        "madc.lo.cc.u32 %6, %11, %18, %6;\n\t"
        "madc.lo.cc.u32 %7, %11, %19, %7;\n\t"
        "madc.lo.cc.u32 %8, %11, %20, %8;\n\t"
        "madc.lo.cc.u32 %9, %11, %21, %9;\n\t"
        "addc.u32 %10, 0, 0;"
        : "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]),
          "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "=r"(t[13])
        : "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]), "r"(a[8]),
          "r"(a[9]), "r"(a[10]), "r"(a[11]));
    asm volatile(
        "mad.hi.cc.u32 %0, %10, %11, %0;\n\t"
        "madc.hi.cc.u32 %1, %10, %12, %1;\n\t"
        "madc.hi.cc.u32 %2, %10, %13, %2;\n\t"
        "madc.hi.cc.u32 %3, %10, %14, %3;\n\t"
        "madc.hi.cc.u32 %4, %10, %15, %4;\n\t"
        "madc.hi.cc.u32 %5, %10, %16, %5;\n\t"
        "madc.hi.cc.u32 %6, %10, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %10, %18, %7;\n\t"
        "madc.hi.cc.u32 %8, %10, %19, %8;\n\t"
        "madc.hi.u32 %9, %10, %20, %9;"
        : "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]),
          "+r"(t[11]), "+r"(t[12]), "+r"(t[13])
        : "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]), "r"(a[8]),
          "r"(a[9]), "r"(a[10]), "r"(a[11]));
    asm volatile(
        "mad.lo.cc.u32 %0, %10, %11, %0;\n\t"
        "madc.lo.cc.u32 %1, %10, %12, %1;\n\t"
        "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
        "madc.lo.cc.u32 %3, %10, %14, %3;\n\t"
        "madc.lo.cc.u32 %4, %10, %15, %4;\n\t"
        "madc.lo.cc.u32 %5, %10, %16, %5;\n\t"
        "madc.lo.cc.u32 %6, %10, %17, %6;\n\t"
        "madc.lo.cc.u32 %7, %10, %18, %7;\n\t"
        "madc.lo.cc.u32 %8, %10, %19, %8;\n\t"
        "addc.u32 %9, 0, 0;"
        : "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]),
          "+r"(t[12]), "+r"(t[13]), "=r"(t[14])
        : "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]), "r"(a[8]), "r"(a[9]),
          "r"(a[10]), "r"(a[11]));
    asm volatile(
        "mad.hi.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %11, %1;\n\t"
        "madc.hi.cc.u32 %2, %9, %12, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %13, %3;\n\t"
        "madc.hi.cc.u32 %4, %9, %14, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %15, %5;\n\t"
        "madc.hi.cc.u32 %6, %9, %16, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %17, %7;\n\t"
        "madc.hi.u32 %8, %9, %18, %8;"
        : "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12]),
          "+r"(t[13]), "+r"(t[14])
        : "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]), "r"(a[8]), "r"(a[9]),
          "r"(a[10]), "r"(a[11]));
    asm volatile(
        "mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.lo.cc.u32 %1, %9, %11, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
        "madc.lo.cc.u32 %3, %9, %13, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %14, %4;\n\t"
        "madc.lo.cc.u32 %5, %9, %15, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %16, %6;\n\t"
        "madc.lo.cc.u32 %7, %9, %17, %7;\n\t"
        "addc.u32 %8, 0, 0;"
        : "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "+r"(t[13]),
          "+r"(t[14]), "=r"(t[15])
        : "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]), "r"(a[8]), "r"(a[9]), "r"(a[10]),
          "r"(a[11]));
    asm volatile(
        "mad.hi.cc.u32 %0, %8, %9, %0;\n\t"
        "madc.hi.cc.u32 %1, %8, %10, %1;\n\t"
        "madc.hi.cc.u32 %2, %8, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %8, %12, %3;\n\t"
        "madc.hi.cc.u32 %4, %8, %13, %4;\n\t"
        "madc.hi.cc.u32 %5, %8, %14, %5;\n\t"
        "madc.hi.cc.u32 %6, %8, %15, %6;\n\t"
        "madc.hi.u32 %7, %8, %16, %7;"
        : "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "+r"(t[13]), "+r"(t[14]),
          "+r"(t[15])
        : "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]), "r"(a[8]), "r"(a[9]), "r"(a[10]),
          "r"(a[11]));
    asm volatile(
        "mad.lo.cc.u32 %0, %8, %9, %0;\n\t"
        "madc.lo.cc.u32 %1, %8, %10, %1;\n\t"
        "madc.lo.cc.u32 %2, %8, %11, %2;\n\t"
        "madc.lo.cc.u32 %3, %8, %12, %3;\n\t"
        "madc.lo.cc.u32 %4, %8, %13, %4;\n\t"
        "madc.lo.cc.u32 %5, %8, %14, %5;\n\t"
        "madc.lo.cc.u32 %6, %8, %15, %6;\n\t"
        "addc.u32 %7, 0, 0;"
        : "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "+r"(t[13]), "+r"(t[14]), "+r"(t[15]),
          "=r"(t[16])
        : "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]), "r"(a[8]), "r"(a[9]), "r"(a[10]), "r"(a[11]));
    asm volatile(
        "mad.hi.cc.u32 %0, %7, %8, %0;\n\t"
        "madc.hi.cc.u32 %1, %7, %9, %1;\n\t"
        "madc.hi.cc.u32 %2, %7, %10, %2;\n\t"
        "madc.hi.cc.u32 %3, %7, %11, %3;\n\t"
        "madc.hi.cc.u32 %4, %7, %12, %4;\n\t"
        "madc.hi.cc.u32 %5, %7, %13, %5;\n\t"
        "madc.hi.u32 %6, %7, %14, %6;"
        : "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "+r"(t[13]), "+r"(t[14]), "+r"(t[15]), "+r"(t[16])
        : "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]), "r"(a[8]), "r"(a[9]), "r"(a[10]), "r"(a[11]));
    asm volatile(
        "mad.lo.cc.u32 %0, %7, %8, %0;\n\t"
        "madc.lo.cc.u32 %1, %7, %9, %1;\n\t"
        "madc.lo.cc.u32 %2, %7, %10, %2;\n\t"
        "madc.lo.cc.u32 %3, %7, %11, %3;\n\t"
        "madc.lo.cc.u32 %4, %7, %12, %4;\n\t"
        "madc.lo.cc.u32 %5, %7, %13, %5;\n\t"
        "addc.u32 %6, 0, 0;"
        : "+r"(t[11]), "+r"(t[12]), "+r"(t[13]), "+r"(t[14]), "+r"(t[15]), "+r"(t[16]), "=r"(t[17])
        : "r"(a[5]), "r"(a[6]), "r"(a[7]), "r"(a[8]), "r"(a[9]), "r"(a[10]), "r"(a[11]));
    asm volatile(
        "mad.hi.cc.u32 %0, %6, %7, %0;\n\t"
        "madc.hi.cc.u32 %1, %6, %8, %1;\n\t"
        "madc.hi.cc.u32 %2, %6, %9, %2;\n\t"
        "madc.hi.cc.u32 %3, %6, %10, %3;\n\t"
        "madc.hi.cc.u32 %4, %6, %11, %4;\n\t"
        "madc.hi.u32 %5, %6, %12, %5;"
        : "+r"(t[12]), "+r"(t[13]), "+r"(t[14]), "+r"(t[15]), "+r"(t[16]), "+r"(t[17])
        : "r"(a[5]), "r"(a[6]), "r"(a[7]), "r"(a[8]), "r"(a[9]), "r"(a[10]), "r"(a[11]));
    asm volatile(
        "mad.lo.cc.u32 %0, %6, %7, %0;\n\t"
        "madc.lo.cc.u32 %1, %6, %8, %1;\n\t"
        "madc.lo.cc.u32 %2, %6, %9, %2;\n\t"
        "madc.lo.cc.u32 %3, %6, %10, %3;\n\t"
        "madc.lo.cc.u32 %4, %6, %11, %4;\n\t"
        "addc.u32 %5, 0, 0;"
        : "+r"(t[13]), "+r"(t[14]), "+r"(t[15]), "+r"(t[16]), "+r"(t[17]), "=r"(t[18])
        : "r"(a[6]), "r"(a[7]), "r"(a[8]), "r"(a[9]), "r"(a[10]), "r"(a[11]));
    asm volatile(
        "mad.hi.cc.u32 %0, %5, %6, %0;\n\t"
        "madc.hi.cc.u32 %1, %5, %7, %1;\n\t"
        "madc.hi.cc.u32 %2, %5, %8, %2;\n\t"
        "madc.hi.cc.u32 %3, %5, %9, %3;\n\t"
        "madc.hi.u32 %4, %5, %10, %4;"
        : "+r"(t[14]), "+r"(t[15]), "+r"(t[16]), "+r"(t[17]), "+r"(t[18])
        : "r"(a[6]), "r"(a[7]), "r"(a[8]), "r"(a[9]), "r"(a[10]), "r"(a[11]));
    asm volatile(
        "mad.lo.cc.u32 %0, %5, %6, %0;\n\t"
        "madc.lo.cc.u32 %1, %5, %7, %1;\n\t"
        "madc.lo.cc.u32 %2, %5, %8, %2;\n\t"
        "madc.lo.cc.u32 %3, %5, %9, %3;\n\t"
        "addc.u32 %4, 0, 0;"
        : "+r"(t[15]), "+r"(t[16]), "+r"(t[17]), "+r"(t[18]), "=r"(t[19])
        : "r"(a[7]), "r"(a[8]), "r"(a[9]), "r"(a[10]), "r"(a[11]));
    asm volatile(
        "mad.hi.cc.u32 %0, %4, %5, %0;\n\t"
        "madc.hi.cc.u32 %1, %4, %6, %1;\n\t"
        "madc.hi.cc.u32 %2, %4, %7, %2;\n\t"
        "madc.hi.u32 %3, %4, %8, %3;"
        : "+r"(t[16]), "+r"(t[17]), "+r"(t[18]), "+r"(t[19])
        : "r"(a[7]), "r"(a[8]), "r"(a[9]), "r"(a[10]), "r"(a[11]));
    asm volatile(
        "mad.lo.cc.u32 %0, %4, %5, %0;\n\t"
        "madc.lo.cc.u32 %1, %4, %6, %1;\n\t"
        "madc.lo.cc.u32 %2, %4, %7, %2;\n\t"
        "addc.u32 %3, 0, 0;"
        : "+r"(t[17]), "+r"(t[18]), "+r"(t[19]), "=r"(t[20])
        : "r"(a[8]), "r"(a[9]), "r"(a[10]), "r"(a[11]));
    asm volatile(
        "mad.hi.cc.u32 %0, %3, %4, %0;\n\t"
        "madc.hi.cc.u32 %1, %3, %5, %1;\n\t"
        "madc.hi.u32 %2, %3, %6, %2;"
        : "+r"(t[18]), "+r"(t[19]), "+r"(t[20])
        : "r"(a[8]), "r"(a[9]), "r"(a[10]), "r"(a[11]));
    asm volatile(
        "mad.lo.cc.u32 %0, %3, %4, %0;\n\t"
        "madc.lo.cc.u32 %1, %3, %5, %1;\n\t"
        "addc.u32 %2, 0, 0;"
        : "+r"(t[19]), "+r"(t[20]), "=r"(t[21])
        : "r"(a[9]), "r"(a[10]), "r"(a[11]));
    asm volatile(
        "mad.hi.cc.u32 %0, %2, %3, %0;\n\t"
        "madc.hi.u32 %1, %2, %4, %1;"
        : "+r"(t[20]), "+r"(t[21])
        : "r"(a[9]), "r"(a[10]), "r"(a[11]));
    asm volatile(
        "mad.lo.cc.u32 %0, %2, %3, %0;\n\t"
        "addc.u32 %1, 0, 0;"
        : "+r"(t[21]), "=r"(t[22])
        : "r"(a[10]), "r"(a[11]));
    asm volatile(
        "mad.hi.u32 %0, %1, %2, %0;"
        : "+r"(t[22])
        : "r"(a[10]), "r"(a[11]));
    asm volatile(
        "add.cc.u32 %0, %0, %0;\n\t"
        "addc.cc.u32 %1, %1, %1;\n\t"
        "addc.cc.u32 %2, %2, %2;\n\t"
        "addc.cc.u32 %3, %3, %3;\n\t"
        "addc.cc.u32 %4, %4, %4;\n\t"
        "addc.cc.u32 %5, %5, %5;\n\t"
        "addc.cc.u32 %6, %6, %6;\n\t"
        "addc.cc.u32 %7, %7, %7;\n\t"
        "addc.cc.u32 %8, %8, %8;\n\t"
        "addc.cc.u32 %9, %9, %9;\n\t"
        "addc.cc.u32 %10, %10, %10;\n\t"
        "addc.cc.u32 %11, %11, %11;\n\t"
        "addc.cc.u32 %12, %12, %12;\n\t"
        "addc.cc.u32 %13, %13, %13;\n\t"
        "addc.cc.u32 %14, %14, %14;\n\t"
        "addc.cc.u32 %15, %15, %15;\n\t"
        "addc.cc.u32 %16, %16, %16;\n\t"
        "addc.cc.u32 %17, %17, %17;\n\t"
        "addc.cc.u32 %18, %18, %18;\n\t"
        "addc.cc.u32 %19, %19, %19;\n\t"
        "addc.cc.u32 %20, %20, %20;\n\t"
        "addc.cc.u32 %21, %21, %21;\n\t"
        "addc.u32 %22, 0, 0;"
        : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]),
          "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "+r"(t[13]), "+r"(t[14]),
          "+r"(t[15]), "+r"(t[16]), "+r"(t[17]), "+r"(t[18]), "+r"(t[19]), "+r"(t[20]), "+r"(t[21]),
          "+r"(t[22]), "=r"(t[23])
        :);
    asm volatile(
        "mul.lo.u32 %0, %13, %13;\n\t"
        "mad.hi.cc.u32 %1, %13, %13, %1;\n\t"
        "madc.lo.cc.u32 %2, %14, %14, %2;\n\t"
        "madc.hi.cc.u32 %3, %14, %14, %3;\n\t"
        "madc.lo.cc.u32 %4, %15, %15, %4;\n\t"
        "madc.hi.cc.u32 %5, %15, %15, %5;\n\t"
        "madc.lo.cc.u32 %6, %16, %16, %6;\n\t"
        "madc.hi.cc.u32 %7, %16, %16, %7;\n\t"
        "madc.lo.cc.u32 %8, %17, %17, %8;\n\t"
        "madc.hi.cc.u32 %9, %17, %17, %9;\n\t"
        "madc.lo.cc.u32 %10, %18, %18, %10;\n\t"
        "madc.hi.cc.u32 %11, %18, %18, %11;\n\t"
        "addc.u32 %12, 0, 0;"
        : "=r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
          "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "=r"(c)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]));
    asm volatile(
        "add.cc.u32 %12, %19, 0xffffffff;\n\t"
        "madc.lo.cc.u32 %0, %13, %13, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %13, %1;\n\t"
        "madc.lo.cc.u32 %2, %14, %14, %2;\n\t"
        "madc.hi.cc.u32 %3, %14, %14, %3;\n\t"
        "madc.lo.cc.u32 %4, %15, %15, %4;\n\t"
        "madc.hi.cc.u32 %5, %15, %15, %5;\n\t"
        "madc.lo.cc.u32 %6, %16, %16, %6;\n\t"
        "madc.hi.cc.u32 %7, %16, %16, %7;\n\t"
        "madc.lo.cc.u32 %8, %17, %17, %8;\n\t"
        "madc.hi.cc.u32 %9, %17, %17, %9;\n\t"
        "madc.lo.cc.u32 %10, %18, %18, %10;\n\t"
        "madc.hi.u32 %11, %18, %18, %11;"
        : "+r"(t[12]), "+r"(t[13]), "+r"(t[14]), "+r"(t[15]), "+r"(t[16]), "+r"(t[17]), "+r"(t[18]),
          "+r"(t[19]), "+r"(t[20]), "+r"(t[21]), "+r"(t[22]), "+r"(t[23]), "=r"(junk)
        : "r"(a[6]), "r"(a[7]), "r"(a[8]), "r"(a[9]), "r"(a[10]), "r"(a[11]), "r"(c));
  }

};

template <> struct Ptx<8> {
  // t[0..8] += a * b; t[8] is written, not read (t < 2N before)
  static __device__ __forceinline__ void mul_row(u32 (&t)[9], const u32 (&a)[8], u32 b) {
    asm volatile(
        "mad.lo.cc.u32 %0, %9, %17, %0;\n\t"
        "madc.lo.cc.u32 %1, %10, %17, %1;\n\t"
        "madc.lo.cc.u32 %2, %11, %17, %2;\n\t"
        "madc.lo.cc.u32 %3, %12, %17, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %17, %4;\n\t"
        "madc.lo.cc.u32 %5, %14, %17, %5;\n\t"
        "madc.lo.cc.u32 %6, %15, %17, %6;\n\t"
        "madc.lo.cc.u32 %7, %16, %17, %7;\n\t"
        "addc.u32 %8, 0, 0;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
          "+r"(t[7]), "=r"(t[8])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
          "r"(b));
    asm volatile(
        "mad.hi.cc.u32 %0, %8, %16, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %16, %1;\n\t"
        "madc.hi.cc.u32 %2, %10, %16, %2;\n\t"
        "madc.hi.cc.u32 %3, %11, %16, %3;\n\t"
        "madc.hi.cc.u32 %4, %12, %16, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
        "madc.hi.cc.u32 %6, %14, %16, %6;\n\t"
        "madc.hi.u32 %7, %15, %16, %7;"
        : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]),
          "+r"(t[8])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
          "r"(b));
  }
  // t[0..8] += m * N (t[0] becomes 0)
  static __device__ __forceinline__ void red_row(u32 (&t)[9], u32 m) {
    asm volatile(
        "mad.lo.cc.u32 %0, %9, 0x00000001, %0;\n\t"
        "madc.lo.cc.u32 %1, %9, 0xffffffff, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, 0xfffe5bfe, %2;\n\t"
        "madc.lo.cc.u32 %3, %9, 0x53bda402, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, 0x09a1d805, %4;\n\t"
        "madc.lo.cc.u32 %5, %9, 0x3339d808, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, 0x299d7d48, %6;\n\t"
        "madc.lo.cc.u32 %7, %9, 0x73eda753, %7;\n\t"
        "addc.u32 %8, %8, 0;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
          "+r"(t[7]), "+r"(t[8])
        : "r"(m));
    asm volatile(
        "mad.hi.cc.u32 %0, %8, 0x00000001, %0;\n\t"
        "madc.hi.cc.u32 %1, %8, 0xffffffff, %1;\n\t"
        "madc.hi.cc.u32 %2, %8, 0xfffe5bfe, %2;\n\t"
        "madc.hi.cc.u32 %3, %8, 0x53bda402, %3;\n\t"
        "madc.hi.cc.u32 %4, %8, 0x09a1d805, %4;\n\t"
        "madc.hi.cc.u32 %5, %8, 0x3339d808, %5;\n\t"
        "madc.hi.cc.u32 %6, %8, 0x299d7d48, %6;\n\t"
        "madc.hi.u32 %7, %8, 0x73eda753, %7;"
        : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]),
          "+r"(t[8])
        : "r"(m));
  }
  // d (with the word hi above it) -= N; returns hi minus the borrow, which
  // is negative as an int exactly when d + hi 2^(32L) < N
  static __device__ __forceinline__ u32 sub_n(u32 (&d)[8], u32 hi) {
    u32 r;
    asm volatile(
        "sub.cc.u32 %0, %0, 0x00000001;\n\t"
        "subc.cc.u32 %1, %1, 0xffffffff;\n\t"
        "subc.cc.u32 %2, %2, 0xfffe5bfe;\n\t"
        "subc.cc.u32 %3, %3, 0x53bda402;\n\t"
        "subc.cc.u32 %4, %4, 0x09a1d805;\n\t"
        "subc.cc.u32 %5, %5, 0x3339d808;\n\t"
        "subc.cc.u32 %6, %6, 0x299d7d48;\n\t"
        "subc.cc.u32 %7, %7, 0x73eda753;\n\t"
        "subc.u32 %8, %9, 0;"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "=r"(r)
        : "r"(hi));
    return r;
  }
  // s += b; returns the carry out
  static __device__ __forceinline__ u32 add(u32 (&s)[8], const u32 (&b)[8]) {
    u32 c;
    asm volatile(
        "add.cc.u32 %0, %0, %9;\n\t"
        "addc.cc.u32 %1, %1, %10;\n\t"
        "addc.cc.u32 %2, %2, %11;\n\t"
        "addc.cc.u32 %3, %3, %12;\n\t"
        "addc.cc.u32 %4, %4, %13;\n\t"
        "addc.cc.u32 %5, %5, %14;\n\t"
        "addc.cc.u32 %6, %6, %15;\n\t"
        "addc.cc.u32 %7, %7, %16;\n\t"
        "addc.u32 %8, 0, 0;"
        : "+r"(s[0]), "+r"(s[1]), "+r"(s[2]), "+r"(s[3]), "+r"(s[4]), "+r"(s[5]), "+r"(s[6]),
          "+r"(s[7]), "=r"(c)
        : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
    return c;
  }
  // d -= b; returns 0, or all ones on a borrow
  static __device__ __forceinline__ u32 sub(u32 (&d)[8], const u32 (&b)[8]) {
    u32 r;
    asm volatile(
        "sub.cc.u32 %0, %0, %9;\n\t"
        "subc.cc.u32 %1, %1, %10;\n\t"
        "subc.cc.u32 %2, %2, %11;\n\t"
        "subc.cc.u32 %3, %3, %12;\n\t"
        "subc.cc.u32 %4, %4, %13;\n\t"
        "subc.cc.u32 %5, %5, %14;\n\t"
        "subc.cc.u32 %6, %6, %15;\n\t"
        "subc.cc.u32 %7, %7, %16;\n\t"
        "subc.u32 %8, 0, 0;"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "=r"(r)
        : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
    return r;
  }
};


// r = t - N if t + hi 2^(32L) >= N, else t; t + hi 2^(32L) < 2N.
template <int L>
__device__ __forceinline__ Elem<L> cond_sub_n(const u32 (&t)[L], u32 hi) {
  u32 d[L];
#pragma unroll
  for (int j = 0; j < L; j++) d[j] = t[j];
  const bool take = (int)Ptx<L>::sub_n(d, hi) >= 0;
  Elem<L> r;
#pragma unroll
  for (int j = 0; j < L; j++) r.w[j] = take ? d[j] : t[j];
  return r;
}

// a * b * 2^(-32L) mod N, canonical in and out. t < 2N holds after every
// row and t + a b_i + m N < 2N 2^32 fits in L + 1 words, since both moduli
// leave the top bit of their top word clear.
template <int L>
__device__ __forceinline__ Elem<L> mont_mul(const Elem<L>& a, const Elem<L>& b) {
  u32 t[L + 1];
#pragma unroll
  for (int j = 0; j < L; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < L; i++) {
    Ptx<L>::mul_row(t, a.w, b.w[i]);
    Ptx<L>::red_row(t, t[0] * Modulus<L>::n0);
#pragma unroll
    for (int j = 0; j < L; j++) t[j] = t[j + 1];
  }
  u32 lo[L];
#pragma unroll
  for (int j = 0; j < L; j++) lo[j] = t[j];
  return cond_sub_n<L>(lo, 0);
}

// a^2 * 2^(-32L) mod N, the same canonical words as mont_mul(a, a).
template <int L>
__device__ __forceinline__ Elem<L> mont_sqr(const Elem<L>& a) {
  return mont_mul<L>(a, a);
}

// Fp: the 24-word square a^2 = T_lo + T_hi 2^384 (about half of a
// multiply's word products), then L reduction rows on T_lo alone, which give
// (T_lo + m N) / 2^384 <= N, and T_hi < N added: below 2N, one conditional
// subtract. REDC(T) = (T_lo + m N) / R + T_hi, since m depends on T_lo only.
template <>
__device__ __forceinline__ Elem<12> mont_sqr<12>(const Elem<12>& a) {
  u32 t[24];
  Ptx<12>::sqr_wide(t, a.w);
  u32 u[13];
#pragma unroll
  for (int j = 0; j < 12; j++) u[j] = t[j];
  u[12] = 0;
#pragma unroll
  for (int i = 0; i < 12; i++) {
    Ptx<12>::red_row(u, u[0] * Modulus<12>::n0);
#pragma unroll
    for (int j = 0; j < 12; j++) u[j] = u[j + 1];
    u[12] = 0;
  }
  u32 lo[12], hi[12];
#pragma unroll
  for (int j = 0; j < 12; j++) {
    lo[j] = u[j];
    hi[j] = t[12 + j];
  }
  const u32 carry = Ptx<12>::add(lo, hi);
  return cond_sub_n<12>(lo, carry);
}

template <int L>
__device__ __forceinline__ Elem<L> add(const Elem<L>& a, const Elem<L>& b) {
  u32 s[L];
#pragma unroll
  for (int j = 0; j < L; j++) s[j] = a.w[j];
  const u32 carry = Ptx<L>::add(s, b.w);
  return cond_sub_n<L>(s, carry);
}

template <int L>
__device__ __forceinline__ Elem<L> sub(const Elem<L>& a, const Elem<L>& b) {
  Elem<L> d = a;
  const u32 borrow = Ptx<L>::sub(d.w, b.w);
  // on a borrow add N back (the carry out of the top word is dropped)
  u32 nb[L];
#pragma unroll
  for (int j = 0; j < L; j++) nb[j] = Modulus<L>::n(j) & borrow;
  Ptx<L>::add(d.w, nb);
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

// Montgomery one (R mod N)
template <int L>
__device__ __forceinline__ Elem<L> one() {
  Elem<L> r;
#pragma unroll
  for (int j = 0; j < L; j++) r.w[j] = Modulus<L>::one(j);
  return r;
}

__device__ __forceinline__ fp_t fp_one() { return one<12>(); }

// x^(N-2) = x^-1 for x != 0, and 0 for x = 0, by fixed 4-bit windows of
// N - 2 from the top: 14 multiplies for the table, then 4 squares and at
// most one multiply a window. One thread; the table lives in local memory.
// Used by the batched inversion (inv_batch.cu) and the final
// exponentiation's one Fp inverse a lane (pairing.cu).
template <int L>
__device__ __noinline__ Elem<L> fermat_inv(Elem<L> x) {
  Elem<L> tbl[16];
  tbl[0] = one<L>();
  tbl[1] = x;
#pragma unroll 1
  for (int k = 2; k < 16; k++) tbl[k] = mont_mul<L>(tbl[k - 1], x);
  Elem<L> acc = tbl[0];
  bool started = false;
#pragma unroll 1
  for (int k = 8 * L - 1; k >= 0; k--) {
    const u32 nib = (Modulus<L>::pm2(k / 8) >> (4 * (k % 8))) & 15u;
    if (started) {
#pragma unroll 1
      for (int s = 0; s < 4; s++) acc = mont_sqr<L>(acc);
      if (nib) acc = mont_mul<L>(acc, tbl[nib]);
    } else if (nib) {
      acc = tbl[nib];
      started = true;
    }
  }
  return acc;
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
