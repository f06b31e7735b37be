// K10 and K11: the optimal ate pairing's Miller loop and final
// exponentiation, one thread a pairing lane.
//
// Replace no Pallas kernel: kzg_tpu's pairing (kzg_tpu/ops/pairing.py:117
// miller_loop, :210 final_exponentiation) is XLA around K1, every Fp
// product one mont_mul_pallas launch (kzg_tpu/ops/pallas_field.py:355)
// through FP.mul in its Fp2 / Fp6 / Fp12 towers, the adds and selects XLA
// between them: about 24,000 Fp products a lane in some 1,700 stacked
// multiplies. Here each stage is one launch (kzg_torch/ops/pairing.py's
// miller_loop and final_exponentiation; its plain versions beside them).
//
// Bound on an H100: operations. A lane reads 72 words (P and Q) and writes
// 144 (K10), or reads and writes 144 (K11), against about 8,300 (K10) and
// 15,500 (K11) Fp products of 600 IMADs: thousands of IMADs a byte. But the
// products of one lane form a chain (63 Miller steps; 314 squares and about
// 70 multiplies of Fp12 in the final exponentiation), so a call of few
// lanes runs at one thread's latency, far from that bound.
//
// Design: one thread owns a lane, kPairThreads (one warp) a block, so a
// call of 2V lanes spreads over 2V / 32 SMs. Its Fp12 values live in local
// memory; the tower operations are fp12.cuh's out-of-line functions, their
// Fp products the out-of-line multiply (FieldCalled). The bit loops stay
// rolled over the exponents as constants (kBlsX, kEHard*), so the code and
// the compile stay small. K10 uses the JAX package's doubling (dbl-2009-l,
// reusing XX and YY), mixed add (madd-2007-bl with H = -h, r = -2 n) and
// line scaling (kzg_tpu/ops/pairing.py:56-114) term for term, because a
// Miller value is defined only up to those choices; each line multiplies f
// as the full Fp12 ((a, 0, 0), (0, b, c)). K11 takes its Frobenius
// constants as a tensor (kzg_torch/ops/fp12.py _frob_table) and its one Fp
// inverse a lane by fermat_inv (field.cuh), which maps 0 to 0: a lane of
// zero words (an infinity lane) gives zero words, as the plain version
// does, and the caller masks it to one.
#include "fp12.cuh"

namespace kzg {

constexpr int kPairThreads = 32;
// |x|, the BLS parameter's magnitude (x = -kBlsX): 64 bits, 6 set
constexpr unsigned long long kBlsX = 0xd201000000010000ull;
constexpr int kBlsXBits = 64;
// (|x| + 1)^2 / 3 = (z - 1)^2 / 3, z = x: 126 bits, 48 set
constexpr unsigned long long kEHardHi = 0x396c8c005555e156ull;
constexpr unsigned long long kEHardLo = 0x8c00aaab0000aaabull;
constexpr int kEHardBits = 126;

__device__ __forceinline__ bool bit_of(unsigned long long hi, unsigned long long lo, int b) {
  return ((b >= 64 ? hi >> (b - 64) : lo >> b) & 1ull) != 0;
}

// T doubled (Jacobian, on the twist) and the tangent line at P, scaled by
// 2 y' XI Z^6: a = 2 XI Y Z^3 yP, b = 3 X^3 - 2 Y^2, c = -3 X^2 Z^2 xP
// (kzg_tpu/ops/pairing.py:56). line's other coefficients are left zero.
static __device__ __noinline__ void dbl_step(jac2_t& T, fp12_t& line, const fp_t& xP,
                                             const fp_t& yP) {
  const fp2_t XX = f2_sqr(T.x);
  const fp2_t ZZ = f2_sqr(T.z);
  const fp2_t t = f2_mul_fp(f2_mul(XX, ZZ), xP);
  line.c[1].c[2] = f2_neg(f2_add(f2_dbl(t), t));
  const fp2_t YZ = f2_mul(T.y, T.z);
  line.c[0].c[0] = f2_mul_fp(f2_xi(f2_dbl(f2_mul(YZ, ZZ))), yP);
  const fp2_t YY = f2_sqr(T.y);
  const fp2_t XXX = f2_mul(T.x, XX);
  line.c[1].c[1] = f2_sub(f2_add(f2_dbl(XXX), XXX), f2_dbl(YY));
  // dbl-2009-l reusing A = XX, B = YY
  const fp2_t C = f2_sqr(YY);
  const fp2_t D = f2_dbl(f2_sub(f2_sub(f2_sqr(f2_add(T.x, YY)), XX), C));
  const fp2_t E = f2_add(f2_dbl(XX), XX);
  const fp2_t X3 = f2_sub(f2_sqr(E), f2_dbl(D));
  T.y = f2_sub(f2_mul(E, f2_sub(D, X3)), f2_dbl(f2_dbl(f2_dbl(C))));
  T.x = X3;
  T.z = f2_dbl(YZ);
}

// Q (affine, on the twist) mixed-added into T and the chord line at P,
// scaled by -Z^3, with n = Y - y2 Z^3, h = X - x2 Z^2: a = XI h Z yP,
// b = n x2 - h Z y2, c = -n xP (kzg_tpu/ops/pairing.py:85).
static __device__ __noinline__ void add_step(jac2_t& T, fp12_t& line, const fp2_t& x2,
                                             const fp2_t& y2, const fp_t& xP, const fp_t& yP) {
  const fp2_t ZZ = f2_sqr(T.z);
  const fp2_t h = f2_sub(T.x, f2_mul(x2, ZZ));
  const fp2_t n = f2_sub(T.y, f2_mul(y2, f2_mul(T.z, ZZ)));
  const fp2_t hZ = f2_mul(h, T.z);
  line.c[0].c[0] = f2_mul_fp(f2_xi(hZ), yP);
  line.c[1].c[1] = f2_sub(f2_mul(n, x2), f2_mul(hZ, y2));
  line.c[1].c[2] = f2_neg(f2_mul_fp(n, xP));
  // madd-2007-bl with H = U2 - X = -h, r = 2 (S2 - Y) = -2 n
  const fp2_t H = f2_neg(h);
  const fp2_t rr = f2_neg(f2_dbl(n));
  const fp2_t I = f2_sqr(f2_dbl(H));
  const fp2_t J = f2_mul(H, I);
  const fp2_t V = f2_mul(T.x, I);
  const fp2_t X3 = f2_sub(f2_sub(f2_sqr(rr), J), f2_dbl(V));
  T.y = f2_sub(f2_mul(rr, f2_sub(V, X3)), f2_dbl(f2_mul(T.y, J)));
  T.x = X3;
  T.z = f2_mul(f2_dbl(H), T.z);
}

// conj(f_{|x|,Q}(P)): for each bit of |x| below the top one, f = f^2 l_dbl,
// then f l_add on a set bit.
__global__ void __launch_bounds__(kPairThreads) miller_loop_kernel(
    const u32* xp, const u32* yp, const u32* xq, const u32* yq, u32* out, int n) {
  const long long i = (long long)blockIdx.x * kPairThreads + threadIdx.x;
  if (i >= n) return;
  const fp_t xP = load<12>(xp, n, i);
  const fp_t yP = load<12>(yp, n, i);
  const fp2_t x2 = load2(xq, n, i);
  const fp2_t y2 = load2(yq, n, i);
  jac2_t T{x2, y2, F2::one()};
  fp12_t f, line;
#pragma unroll 1
  for (int h = 0; h < 2; h++)
#pragma unroll 1
    for (int k = 0; k < 3; k++) {
      f.c[h].c[k] = F2::zero();
      line.c[h].c[k] = F2::zero();
    }
  f.c[0].c[0] = F2::one();
#pragma unroll 1
  for (int b = kBlsXBits - 2; b >= 0; b--) {
    fp12_sqr(f, f);
    dbl_step(T, line, xP, yP);
    fp12_mul(f, f, line);
    if ((kBlsX >> b) & 1ull) {
      add_step(T, line, x2, y2, xP, yP);
      fp12_mul(f, f, line);
    }
  }
  fp12_conj(f, f);  // the BLS parameter is negative
  store_fp12(out, n, i, f);
}

// r = a^e for the exponent's bits (hi, lo) below its top one (nbits long),
// square-and-multiply from the top. r must not alias a.
static __device__ __noinline__ void fp12_pow_bits(fp12_t& r, const fp12_t& a,
                                                  unsigned long long hi, unsigned long long lo,
                                                  int nbits) {
  r = a;
#pragma unroll 1
  for (int b = nbits - 2; b >= 0; b--) {
    fp12_sqr(r, r);
    if (bit_of(hi, lo, b)) fp12_mul(r, r, a);
  }
}

// f^((p^12 - 1) / r), canonical: the easy part conj(f) / f times its p^2
// power, then (kzg_tpu/ops/pairing.py:210) g2 = f^((z - 1)^2 / 3),
// g3 = g2^z g2^p, out = g3^(z^2) g3^(p^2) conj(g3) f, each ^z a power by
// |x| and a conjugation.
__global__ void __launch_bounds__(kPairThreads) final_exp_kernel(const u32* in,
                                                                 const u32* frob, u32* out,
                                                                 int n) {
  const long long i = (long long)blockIdx.x * kPairThreads + threadIdx.x;
  if (i >= n) return;
  fp12_t f, a, b, c;
  load_fp12(f, in, n, i);
  fp12_conj(a, f);
  fp12_inv(b, f);
  fp12_mul(f, a, b);  // f^(p^6 - 1)
  fp12_frob(a, f, frob, 2);
  fp12_mul(f, a, f);  // ^(p^2 + 1)
  fp12_pow_bits(a, f, kEHardHi, kEHardLo, kEHardBits);  // g2
  fp12_pow_bits(b, a, 0, kBlsX, kBlsXBits);
  fp12_conj(b, b);  // g2^z
  fp12_frob(c, a, frob, 1);
  fp12_mul(a, b, c);  // g3 = g2^z g2^p
  fp12_pow_bits(b, a, 0, kBlsX, kBlsXBits);
  fp12_conj(b, b);  // g3^z
  fp12_pow_bits(c, b, 0, kBlsX, kBlsXBits);
  fp12_conj(c, c);  // g3^(z^2)
  fp12_frob(b, a, frob, 2);
  fp12_mul(c, c, b);
  fp12_conj(b, a);
  fp12_mul(c, c, b);
  fp12_mul(c, c, f);
  store_fp12(out, n, i, c);
}

}  // namespace kzg

namespace {
inline int pair_blocks(int n) { return (n + kzg::kPairThreads - 1) / kzg::kPairThreads; }
}  // namespace

// xp, yp: (12, n) affine P; xq, yq: (12, 2, n) affine Q; out: (12, 2, 3, 2, n).
extern "C" int kzg_miller_loop(const void* xp, const void* yp, const void* xq, const void* yq,
                               void* out, int n, void* stream) {
  using namespace kzg;
  if (n <= 0) return 0;
  miller_loop_kernel<<<pair_blocks(n), kPairThreads, 0, (cudaStream_t)stream>>>(
      (const u32*)xp, (const u32*)yp, (const u32*)xq, (const u32*)yq, (u32*)out, n);
  return (int)cudaGetLastError();
}

// in, out: (12, 2, 3, 2, n); frob: (12, 2, 3, 2, 3), the Frobenius constants.
extern "C" int kzg_final_exp(const void* in, const void* frob, void* out, int n, void* stream) {
  using namespace kzg;
  if (n <= 0) return 0;
  final_exp_kernel<<<pair_blocks(n), kPairThreads, 0, (cudaStream_t)stream>>>(
      (const u32*)in, (const u32*)frob, (u32*)out, n);
  return (int)cudaGetLastError();
}
