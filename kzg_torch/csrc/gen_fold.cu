// K5 and K8: the generator window fold, one thread per lane.
//
// Replaces kzg_tpu/ops/pallas_msm25.py fold25_packed (K5, the ceremony's
// [k] G for G1 batches of 64 or more lanes) and kzg_tpu/ops/pallas_msm.py
// fold_madd_packed (K8, the same fold in the canonical domain). Per lane the
// accumulator starts at infinity and takes W affine entries in order with the
// exact mixed add of g1.cuh (a partial sum can equal the next entry, so the
// P == Q doubling must be there); an entry whose x and y words are all zero
// is the d = 0 sentinel and keeps the accumulator. No affine point of
// y^2 = x^3 + 4 has x = y = 0, so the skip is exact. The result is written
// once; the accumulator never leaves registers.
//
// Two entry points share the loop:
//   kzg_gen_fold      reads entry (w, digits[w][i]) straight from the
//                     (12, 32, 256) generator tables (786 KB, held in L2), so
//                     no 32 x n gathered stream is written to device memory;
//   kzg_fold_entries  reads pre-gathered (W, 12, C) x and y word streams
//                     (K8's interface).
// The TPU kernels' x | y << 16 packing and lazy 2^400 domain answered the
// TPU's gather and VPU costs; here entries are canonical Montgomery words.
//
// Bound on an H100: operations. A lane does up to W mixed adds of 7 Fp
// multiplies and 4 squares (~6,070 32-bit multiply-adds each) and moves 128 bytes of
// digits and 144 bytes of output, far above the card's ~5 multiply-adds per
// byte.
#include "g1.cuh"

namespace kzg {

constexpr int kWindows = 32;
constexpr int kEntries = 256;
constexpr long long kTableStride = (long long)kWindows * kEntries;  // words between limbs

__device__ __forceinline__ jac_t fold_step(const jac_t& acc, const fp_t& qx, const fp_t& qy) {
  if (fzero(qx) && fzero(qy)) return acc;
  return g1_madd(acc, qx, qy);
}

__global__ void __launch_bounds__(128) gen_fold_kernel(const u32* tx, const u32* ty,
                                                       const int* digits, u32* ox, u32* oy,
                                                       u32* oz, int n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  jac_t acc = jac_inf();
  for (int w = 0; w < kWindows; w++) {
    // the wrapper checks 0 <= digit < 256
    const long long e = (long long)w * kEntries + (u32)digits[(long long)w * n + i];
    acc = fold_step(acc, load<12>(tx, kTableStride, e), load<12>(ty, kTableStride, e));
  }
  store_jac(ox, oy, oz, n, i, acc);
}

__global__ void __launch_bounds__(128) fold_entries_kernel(const u32* xs, const u32* ys, u32* ox,
                                                           u32* oy, u32* oz, int W, int n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  jac_t acc = jac_inf();
  for (int w = 0; w < W; w++) {
    const long long off = (long long)w * 12 * n;
    acc = fold_step(acc, load<12>(xs + off, n, i), load<12>(ys + off, n, i));
  }
  store_jac(ox, oy, oz, n, i, acc);
}

}  // namespace kzg

namespace {
constexpr int kThreads = 128;
inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }
}  // namespace

extern "C" int kzg_gen_fold(const void* tx, const void* ty, const void* digits, void* ox,
                            void* oy, void* oz, int n, void* stream) {
  using namespace kzg;
  if (n <= 0) return 0;
  gen_fold_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const u32*)tx, (const u32*)ty, (const int*)digits, (u32*)ox, (u32*)oy, (u32*)oz, n);
  return (int)cudaGetLastError();
}

extern "C" int kzg_fold_entries(const void* xs, const void* ys, void* ox, void* oy, void* oz,
                                int W, int n, void* stream) {
  using namespace kzg;
  if (n <= 0) return 0;
  fold_entries_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const u32*)xs, (const u32*)ys, (u32*)ox, (u32*)oy, (u32*)oz, W, n);
  return (int)cudaGetLastError();
}
