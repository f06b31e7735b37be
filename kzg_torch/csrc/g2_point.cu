// K9: batched G2 point formulas (double, add, madd over Fp2), one thread a
// lane.
//
// Replaces no Pallas kernel: kzg_tpu's G2 (JacobianCurve over ops/fp2.py,
// kzg_tpu/ops/curve.py:82-170, G2 at :276) never takes its fused point
// kernel (_pallas_ok is false for Fp2, :69-80), so every Fp product of a G2
// operation is one mont_mul_pallas launch (K1, kzg_tpu/ops/pallas_field.py
// :355) through FP.mul, with the adds, subtractions and selects as XLA
// between them. Here each formula is one launch. Its callers: the G2
// generator tables and mul_g2_gen (ops/genmul.py), the G2 ladder below
// GENMUL_TABLE_THRESHOLD, and the subgroup check of a setup's G2 points
// (ops/codec.py).
//
// Bound on an H100: operations. A madd moves 8 x 96 bytes and needs 7 Fp2
// multiplies and 4 squares (15,216 IMADs, an Fp2 multiply counted with lazy
// reduction: three word products, two reductions), an add 9 x 96 bytes and
// 11 + 5 (22,368), a double 6 x 96 bytes and 2 + 5 (8,976): 15 to 26 IMADs
// a byte, above the card's ~5.
//
// Design: g1.cuh's formulas over g2.cuh's Fp2Ops on the out-of-line Fp
// multiply (FieldCalled), three products an Fp2 multiply; each thread keeps its
// operands (72 words a Jacobian point) in shared memory and only the
// formula's temporaries in registers; the P == Q doubling of add and madd
// runs only in a warp with such a lane. kG2Threads lanes a block keep the
// operands of an add (576 bytes a lane) inside 48 KB of static shared
// memory. Every thread runs the formula (lanes past n on zero words) so
// that each warp is whole at __any_sync; only lanes below n store.
#include "g2.cuh"

namespace kzg {

constexpr int kG2Threads = 64;

using G2Ops = Fp2Ops<FieldCalled>;

__device__ __forceinline__ jac2_t load_jac2(const u32* x, const u32* y, const u32* z, int n,
                                            long long i) {
  if (i >= n) return pt_inf<G2Ops, jac2_t>();
  return jac2_t{load2(x, n, i), load2(y, n, i), load2(z, n, i)};
}

__device__ __forceinline__ void store_jac2(u32* x, u32* y, u32* z, int n, long long i,
                                           const jac2_t& p) {
  if (i >= n) return;
  store2(x, n, i, p.x);
  store2(y, n, i, p.y);
  store2(z, n, i, p.z);
}

__global__ void __launch_bounds__(kG2Threads) g2_double_kernel(const u32* x, const u32* y,
                                                               const u32* z, u32* ox, u32* oy,
                                                               u32* oz, int n) {
  __shared__ jac2_t sp[kG2Threads];
  const int t = threadIdx.x;
  const long long i = (long long)blockIdx.x * kG2Threads + t;
  sp[t] = load_jac2(x, y, z, n, i);
  store_jac2(ox, oy, oz, n, i, jac_double<G2Ops>(sp[t]));
}

__global__ void __launch_bounds__(kG2Threads) g2_add_kernel(const u32* x1, const u32* y1,
                                                            const u32* z1, const u32* x2,
                                                            const u32* y2, const u32* z2,
                                                            u32* ox, u32* oy, u32* oz, int n) {
  __shared__ jac2_t sp[kG2Threads], sq[kG2Threads];
  const int t = threadIdx.x;
  const long long i = (long long)blockIdx.x * kG2Threads + t;
  sp[t] = load_jac2(x1, y1, z1, n, i);
  sq[t] = load_jac2(x2, y2, z2, n, i);
  store_jac2(ox, oy, oz, n, i, jac_add<G2Ops, true>(sp[t], sq[t]));
}

__global__ void __launch_bounds__(kG2Threads) g2_madd_kernel(const u32* x1, const u32* y1,
                                                             const u32* z1, const u32* x2,
                                                             const u32* y2, u32* ox, u32* oy,
                                                             u32* oz, int n) {
  __shared__ jac2_t sp[kG2Threads];
  __shared__ fp2_t sx[kG2Threads], sy[kG2Threads];
  const int t = threadIdx.x;
  const long long i = (long long)blockIdx.x * kG2Threads + t;
  sp[t] = load_jac2(x1, y1, z1, n, i);
  sx[t] = i < n ? load2(x2, n, i) : G2Ops::zero();
  sy[t] = i < n ? load2(y2, n, i) : G2Ops::zero();
  store_jac2(ox, oy, oz, n, i, jac_madd<G2Ops, true>(sp[t], sx[t], sy[t]));
}

}  // namespace kzg

namespace {
inline int g2_blocks(int n) { return (n + kzg::kG2Threads - 1) / kzg::kG2Threads; }
}  // namespace

extern "C" int kzg_g2_double(const void* x, const void* y, const void* z, void* ox, void* oy,
                             void* oz, int n, void* stream) {
  using namespace kzg;
  if (n <= 0) return 0;
  g2_double_kernel<<<g2_blocks(n), kG2Threads, 0, (cudaStream_t)stream>>>(
      (const u32*)x, (const u32*)y, (const u32*)z, (u32*)ox, (u32*)oy, (u32*)oz, n);
  return (int)cudaGetLastError();
}

extern "C" int kzg_g2_add(const void* x1, const void* y1, const void* z1, const void* x2,
                          const void* y2, const void* z2, void* ox, void* oy, void* oz, int n,
                          void* stream) {
  using namespace kzg;
  if (n <= 0) return 0;
  g2_add_kernel<<<g2_blocks(n), kG2Threads, 0, (cudaStream_t)stream>>>(
      (const u32*)x1, (const u32*)y1, (const u32*)z1, (const u32*)x2, (const u32*)y2,
      (const u32*)z2, (u32*)ox, (u32*)oy, (u32*)oz, n);
  return (int)cudaGetLastError();
}

extern "C" int kzg_g2_madd(const void* x1, const void* y1, const void* z1, const void* x2,
                           const void* y2, void* ox, void* oy, void* oz, int n, void* stream) {
  using namespace kzg;
  if (n <= 0) return 0;
  g2_madd_kernel<<<g2_blocks(n), kG2Threads, 0, (cudaStream_t)stream>>>(
      (const u32*)x1, (const u32*)y1, (const u32*)z1, (const u32*)x2, (const u32*)y2, (u32*)ox,
      (u32*)oy, (u32*)oz, n);
  return (int)cudaGetLastError();
}
