// K5 and K8: the generator window fold.
//
// Replaces kzg_tpu/ops/pallas_msm25.py fold25_packed (K5, the ceremony's
// [k] G for G1 batches of 64 or more lanes) and kzg_tpu/ops/pallas_msm.py
// fold_madd_packed (K8, the same fold in the canonical domain). Per lane the
// accumulator starts at infinity and takes 32 affine entries in order with
// the exact mixed add of g1.cuh (a partial sum can equal the next entry, so
// the P == Q doubling must be there); an entry whose x and y words are all
// zero is the d = 0 sentinel and keeps the accumulator. No affine point of
// y^2 = x^3 + 4 has x = y = 0, so the skip is exact. The TPU kernels' x | y
// << 16 packing and lazy 2^400 domain answered the TPU's gather and VPU
// costs; here entries are canonical Montgomery words.
//
// Bound on an H100: operations. A lane does up to 31 mixed adds of 7 Fp
// multiplies and 4 squares (~6,070 32-bit multiply-adds each) and moves 128
// bytes of digits and 144 bytes of output, far above the card's ~5
// multiply-adds per byte.
//
// kzg_gen_fold (K5), one thread a lane, kFoldThreads lanes a block:
//
//   With the exact madd inlined, the loop body is about 11,000
//   instructions (11 multiplies of ~640, the doubling's 7 more inside a
//   data-dependent branch), more than an SM's instruction caches hold. On
//   an H100 this kernel takes 1.8 times as long with the multiplies
//   inlined, and 3-5 % longer with the exact madd's per-lane doubling
//   branch (scripts/gen_fold_probe.py).
//
//   - The point operations call the out-of-line multiply and square
//     (g1.cuh FieldCalled): one copy of each in the instruction cache.
//   - The madd is the 11-multiply jac_madd_fast. A lane whose partial sum
//     equals its entry (acc == Q, acc finite) needs the doubling instead;
//     its warp computes jac_double(acc) only when one of its lanes needs it
//     (__any_sync, a warp-uniform branch), and that lane keeps the doubling.
//     So each step's output is jac_madd's word for word.
//   - The accumulator lives in shared memory, not in registers across
//     those calls (36,864 B a block).
//   - Each lane gathers its entry T[w][digit] from the (12, 32, 256) tables
//     (786 KB, held in L2): 24 loads against some 7,000 instructions of a
//     madd. Staging each window's 256 entries in shared memory (cp.async,
//     double-buffered) ran within 1.5 % of this loop on an H100, so the
//     loop stays.
//   - Every thread runs all 32 windows (lanes past n take digit 0, the
//     skip entry), so every warp is whole at __any_sync; only lanes below
//     n store. Window 0 is a copy: from infinity the madd gives the entry
//     (x, y, ONE).
//
//   256 threads a block, one block an SM by registers (8 warps): 2^16
//   lanes are 256 blocks over 132 SMs, 1.94 waves, the second 94 % full.
//   Every lane is a chain of 31 dependent madds, so a wave's warps all end
//   together and a wave part full costs nearly a whole one: blocks of 128
//   fit three an SM (12 warps), and 2^16 lanes then make 1.29 waves, the
//   second 29 % full: 8 % slower. 16 warps an SM (one wave) need 128
//   registers a thread, spill, and run 5 % slower. What bounds it is the
//   integer pipe's instruction stream, not memory: 8 warps an SM already
//   keep it near its rate.
//
// kzg_fold_entries (K8) reads pre-gathered (W, 12, C) x and y word streams
// and runs the first port's loop (the exact madd, inlined, in registers);
// no library code calls it.
#include "g1.cuh"

namespace kzg {

constexpr int kWindows = 32;
constexpr int kEntries = 256;
constexpr long long kTableStride = (long long)kWindows * kEntries;  // words between limbs
constexpr int kFoldThreads = 256;

using FoldOps = FieldCalled;

// acc <- acc + (qx, qy) by the exact mixed add; the (0, 0) entry keeps acc.
// In window 0 every acc is infinity, where the madd gives (qx, qy, ONE):
// that is copied, not computed.
__device__ __forceinline__ void fold_madd(jac_t& acc, const fp_t& qx, const fp_t& qy, int w) {
  const bool skip = fzero(qx) && fzero(qy);
  if (w == 0) {
    if (!skip) acc = jac_t{qx, qy, fp_one()};
    asm volatile("" ::: "memory");
    return;
  }
  bool need;
  jac_t sum = jac_madd_fast<FoldOps>(acc, qx, qy, need);
  asm volatile("" ::: "memory");
  need = need && !skip;
  if (__any_sync(0xffffffffu, need)) {
    const jac_t d = jac_double<FoldOps>(acc);
    if (need) sum = d;
    asm volatile("" ::: "memory");
  }
  if (!skip) acc = sum;
  asm volatile("" ::: "memory");
}

__global__ void __launch_bounds__(kFoldThreads)
    gen_fold_kernel(const u32* tx, const u32* ty, const int* digits, u32* ox, u32* oy, u32* oz,
                    int n) {
  __shared__ jac_t acc[kFoldThreads];
  const int t = threadIdx.x;
  const long long i = (long long)blockIdx.x * kFoldThreads + t;
  acc[t] = jac_inf();
#pragma unroll 1
  for (int w = 0; w < kWindows; w++) {
    // the wrapper checks 0 <= digit < 256
    const long long e =
        (long long)w * kEntries + (i < n ? (u32)digits[(long long)w * n + i] : 0u);
    fold_madd(acc[t], load<12>(tx, kTableStride, e), load<12>(ty, kTableStride, e), w);
  }
  if (i < n) store_jac(ox, oy, oz, n, i, acc[t]);
}

__device__ __forceinline__ jac_t fold_step(const jac_t& acc, const fp_t& qx, const fp_t& qy) {
  if (fzero(qx) && fzero(qy)) return acc;
  return jac_madd(acc, qx, qy);
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
constexpr int kEntriesThreads = 128;
}  // namespace

extern "C" int kzg_gen_fold(const void* tx, const void* ty, const void* digits, void* ox,
                            void* oy, void* oz, int n, void* stream) {
  using namespace kzg;
  if (n <= 0) return 0;
  gen_fold_kernel<<<(n + kFoldThreads - 1) / kFoldThreads, kFoldThreads, 0,
                    (cudaStream_t)stream>>>((const u32*)tx, (const u32*)ty, (const int*)digits,
                                            (u32*)ox, (u32*)oy, (u32*)oz, n);
  return (int)cudaGetLastError();
}

extern "C" int kzg_fold_entries(const void* xs, const void* ys, void* ox, void* oy, void* oz,
                                int W, int n, void* stream) {
  using namespace kzg;
  if (n <= 0) return 0;
  fold_entries_kernel<<<(n + kEntriesThreads - 1) / kEntriesThreads, kEntriesThreads, 0,
                        (cudaStream_t)stream>>>((const u32*)xs, (const u32*)ys, (u32*)ox,
                                                (u32*)oy, (u32*)oz, W, n);
  return (int)cudaGetLastError();
}
