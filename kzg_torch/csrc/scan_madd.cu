// K3: the fixed-base MSM's bucket scan. For each of C chunks, m sequential
// mixed adds over the digit-sorted affine stream, every Jacobian prefix
// written: out[j, :, c] = sum of the first j + 1 points of chunk c.
//
// Replaces kzg_tpu/ops/pallas_msm25.py scan25_fast / scan25_exact and
// kzg_tpu/ops/pallas_msm.py scan_prefix_madd_fast_packed /
// scan_prefix_madd_packed (and computes scan_prefix_madd_fast /
// scan_prefix_madd, which take the same separate x and y streams). The TPU's
// sequential grid axis over the m steps becomes a loop inside one thread per
// chunk, with the running point in registers; chunks are independent, so
// any C works, including C < 64 and C not a power of two.
//
// fast = 1 runs the 11-mul madd and ORs a global flag when a lane needs a
// doubling (P == Q inside a prefix); the caller then reruns with fast = 0,
// the exact madd, as the JAX package's lax.cond does (msm.py:584-592).
//
// Bound on an H100: operations. A step reads 2 * 48 bytes and writes
// 3 * 48 bytes for 11 field multiplies (~6,600 IMADs), ~27 IMADs per byte.
// The input streams are addressed by strides (step, limb; lane stride 1), so
// a permuted view of the gathered (12, m, C) stream is read in place without
// a transposing copy; a warp reads 32 neighbouring chunks, which coalesces.
#include "g1.cuh"

namespace kzg {

template <bool FAST>
__global__ void __launch_bounds__(128) scan_madd_kernel(const u32* __restrict__ xs,
                                                        const u32* __restrict__ ys,
                                                        long long step_stride,
                                                        long long limb_stride,
                                                        u32* __restrict__ ox, u32* __restrict__ oy,
                                                        u32* __restrict__ oz, int* flag, int m,
                                                        int C) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  jac_t run = jac_inf();
  bool any_double = false;
  for (int j = 0; j < m; j++) {
    const u32* xj = xs + j * step_stride;
    const u32* yj = ys + j * step_stride;
    const fp_t qx = load<12>(xj, limb_stride, c);
    const fp_t qy = load<12>(yj, limb_stride, c);
    if (FAST) {
      bool nd;
      run = g1_madd_fast(run, qx, qy, nd);
      any_double |= nd;
    } else {
      run = g1_madd(run, qx, qy);
    }
    const long long base = (long long)j * 12 * C;
    store_jac(ox + base, oy + base, oz + base, C, c, run);
  }
  if (FAST && any_double) atomicOr(flag, 1);
}

}  // namespace kzg

extern "C" int kzg_scan_madd(const void* xs, const void* ys, int step_stride, int limb_stride,
                             void* ox, void* oy, void* oz, void* flag, int m, int C, int fast,
                             void* stream) {
  using namespace kzg;
  if (m <= 0 || C <= 0) return 0;
  const int threads = 128;
  const int blocks = (C + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (fast) {
    scan_madd_kernel<true><<<blocks, threads, 0, s>>>((const u32*)xs, (const u32*)ys, step_stride,
                                                      limb_stride, (u32*)ox, (u32*)oy, (u32*)oz,
                                                      (int*)flag, m, C);
  } else {
    scan_madd_kernel<false><<<blocks, threads, 0, s>>>((const u32*)xs, (const u32*)ys,
                                                       step_stride, limb_stride, (u32*)ox,
                                                       (u32*)oy, (u32*)oz, (int*)flag, m, C);
  }
  return (int)cudaGetLastError();
}
