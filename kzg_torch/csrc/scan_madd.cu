// K3: the fixed-base MSM's bucket scan, in two entry points.
//
// kzg_scan_buckets, the commit's scan (fused): per chunk of m digit-sorted
// pairs, the running sum of their table points, reading each point itself
// and writing only what the bucket extraction reads. See its kernel below.
//
// kzg_scan_madd, the streaming scan: for each of C chunks, m sequential
// mixed adds over a pre-gathered affine stream, every Jacobian prefix
// written: out[j, :, c] = sum of the first j + 1 points of chunk c.
//
// Both replace kzg_tpu/ops/pallas_msm25.py scan25_fast / scan25_exact and
// kzg_tpu/ops/pallas_msm.py scan_prefix_madd_fast_packed /
// scan_prefix_madd_packed (the streaming scan also computes
// scan_prefix_madd_fast / scan_prefix_madd, which take the same separate x
// and y streams). The TPU's sequential grid axis over the m steps becomes a
// loop inside one thread per chunk, with the running point in registers;
// chunks are independent, so any C works, including C < 64 and C not a power
// of two.
//
// The streaming scan's fast = 1 runs the 11-mul madd and ORs a global flag
// when a lane needs a doubling (P == Q inside a prefix); a caller that sees
// it reruns with fast = 0, the exact madd, as the JAX package's lax.cond does
// (msm.py:584-592). The fused scan runs the exact madd only: on this card
// the exact scan costs what the fast one does, so the commit path has no
// flag to read back.
//
// Bound of the streaming scan on an H100: operations. A step reads 2 * 48
// bytes and writes 3 * 48 bytes for a mixed add (~6,070 IMADs), ~25
// IMADs per byte. The input streams are addressed by strides (step, limb;
// lane stride 1), so a permuted view of the gathered (12, m, C) stream is read
// in place without a transposing copy; a warp reads 32 neighbouring chunks,
// which coalesces.
#include <cuda_pipeline.h>

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
      run = jac_madd_fast(run, qx, qy, nd);
      any_double |= nd;
    } else {
      run = jac_madd(run, qx, qy);
    }
    const long long base = (long long)j * 12 * C;
    store_jac(ox + base, oy + base, oz + base, C, c, run);
  }
  if (FAST && any_double) atomicOr(flag, 1);
}


// The fused scan. Thread c owns sorted pairs [c m, c m + m). Pair p's key is
// its row in the point-major table (16 n2 rows of 24 words: x, then y), with
// the digit's sign in bit 31; a negative digit negates y here. ds[p] is the
// pair's |digit|. The running sum takes every point with the exact mixed add
// (only a P == Q lane branches into the doubling), and is written
//   - at p = the last position of its digit (ds[p] != ds[p + 1], or the last
//     pair): to slot ds[p] of the (12, nb) arrays u*, one writer per slot;
//   - at the chunk's end: to column c of the (12, C) chunk totals t*.
// Nothing else is written: the streaming scan's every-prefix output was
// 2.4 GB at the commit's shape, and the gathered streams it read 1.6 GB.
//
// Each step's table row (96 bytes) is random in a 1.6 GB table, so it is
// copied into shared memory one step ahead with cp.async (six 16-byte
// pieces, no registers held across the step) while the current step's
// madd runs; keys are read two steps ahead.
//
// Bound on an H100: operations (a mixed add a pair, ~6,070 32-bit
// multiply-adds, ~60 a byte moved). The madd needs about 200 registers a thread
// unbounded; 3 blocks of 128 an SM (168 registers, a few spilled words)
// ran faster than 2 (no spills) or 4 (128 registers, ~0.5 KB of spills a
// thread), so the chunk length m is chosen for that occupancy.
constexpr int kBucketThreads = 128;
constexpr int kBucketMinBlocks = 3;

__device__ __forceinline__ void fetch_row(uint4 (*stage)[kBucketThreads], const uint4* table,
                                          int key) {
  const uint4* row = table + (long long)(key & 0x7fffffff) * 6;
#pragma unroll
  for (int v = 0; v < 6; v++) __pipeline_memcpy_async(&stage[v][threadIdx.x], row + v, 16);
}

__global__ void __launch_bounds__(kBucketThreads, kBucketMinBlocks)
    scan_buckets_kernel(const uint4* __restrict__ table, const int* __restrict__ keys,
                        const int* __restrict__ ds, u32* __restrict__ tx, u32* __restrict__ ty,
                        u32* __restrict__ tz, u32* __restrict__ ux, u32* __restrict__ uy,
                        u32* __restrict__ uz, int m, int C, int nb) {
  __shared__ uint4 stage[2][6][kBucketThreads];
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const long long P = (long long)C * m;
  const long long base = (long long)c * m;
  int key = keys[base];
  int key_next = m > 1 ? keys[base + 1] : 0;
  int d = ds[base];
  fetch_row(stage[0], table, key);
  __pipeline_commit();
  jac_t run = jac_inf();
  for (int j = 0; j < m; j++) {
    const long long p = base + j;
    const int key_after = j + 2 < m ? keys[p + 2] : 0;
    const int d_next = p + 1 < P ? ds[p + 1] : -1;
    if (j + 1 < m) fetch_row(stage[(j + 1) & 1], table, key_next);
    __pipeline_commit();
    __pipeline_wait_prior(1);  // this step's row has landed
    const uint4* row = &stage[j & 1][0][threadIdx.x];
    fp_t qx, qy;
#pragma unroll
    for (int v = 0; v < 3; v++) {
      const uint4 a = row[v * kBucketThreads];
      const uint4 b = row[(v + 3) * kBucketThreads];
      qx.w[4 * v] = a.x; qx.w[4 * v + 1] = a.y; qx.w[4 * v + 2] = a.z; qx.w[4 * v + 3] = a.w;
      qy.w[4 * v] = b.x; qy.w[4 * v + 1] = b.y; qy.w[4 * v + 2] = b.z; qy.w[4 * v + 3] = b.w;
    }
    if (key < 0) qy = fsub(zero<12>(), qy);
    run = jac_madd(run, qx, qy);
    if (d != d_next && (unsigned)d < (unsigned)nb) store_jac(ux, uy, uz, nb, d, run);
    key = key_next;
    key_next = key_after;
    d = d_next;
  }
  store_jac(tx, ty, tz, C, c, run);
}

}  // namespace kzg

extern "C" int kzg_scan_buckets(const void* table, const void* keys, const void* ds, void* tx,
                                void* ty, void* tz, void* ux, void* uy, void* uz, int m, int C,
                                int nb, void* stream) {
  using namespace kzg;
  if (m <= 0 || C <= 0) return 0;
  const int blocks = (C + kBucketThreads - 1) / kBucketThreads;
  scan_buckets_kernel<<<blocks, kBucketThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)table, (const int*)keys, (const int*)ds, (u32*)tx, (u32*)ty, (u32*)tz,
      (u32*)ux, (u32*)uy, (u32*)uz, m, C, nb);
  return (int)cudaGetLastError();
}

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
