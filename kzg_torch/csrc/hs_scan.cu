// K4: inclusive prefix (or suffix) sums of Jacobian points along the last
// axis of (12, R, W) coordinate arrays, for any W, with K2's exact add.
//
// Replaces kzg_tpu/ops/pallas_msm.py hs_scan_points, which keeps the whole
// row in VMEM and is capped at W <= 4096 on the TPU (msm.py:325). A suffix
// scan (reverse = 1) is the prefix scan in reversed lane order; the
// exclusive shift is data movement and stays in the wrapper.
//
// W <= 256 (hs_block, one block a row, one warp per 32 lanes): Hillis-Steele
// in shared memory, lane t adding lane t - 2^k at level k, exactly the JAX
// package's order (state = add(state, partner)), so the output equals
// kzg_tpu's _hs_scan_points bit for bit. These are the weighted reduction's
// 3 x 32 suffix sums.
//
// W > 256: reduce, then scan, in four launches. A segment is B threads of
// `run` consecutive lanes each.
//   hs_runs:    each thread walks its run, writing the run's own inclusive
//               prefixes to scratch (run - 1 adds, the sum so far first);
//               the block scans its B run totals by Hillis-Steele in shared
//               memory (empty runs past W are infinity) and writes them and
//               the segment's total.
//   the caller scans the segment totals with this same function (one
//               hs_block launch up to 256 segments).
//   hs_offsets: one thread a run: the run's offset (the segments before,
//               then the runs before within its segment: at most one add).
//   hs_apply:   one thread a lane: offset + the run's own prefix.
// About 2 W + (W / run) (log2 B - 1) adds, against about 8 W for one
// Hillis-Steele pass per 256 lanes and an offset pass; the plain version
// (scans._hs_prefix16) groups the adds the same way, so the two agree bit
// for bit.
//
// Bound on an H100: operations (a point add, ~8,940 IMADs, against 6 * 48
// bytes moved per lane). What holds it back is the add's latency: a
// thread's adds are serial, so the time is about the number of dependent
// adds on the longest path (run - 1, log2 B, the segment scan's log2, then
// two) times one add's latency, not the card's add rate. So every add here
// calls one out-of-line copy of the field multiply and square (g1.cuh's
// FieldCalled): inlined, an add's 16 copies overflow the instruction caches
// and a chain of dependent adds waits on fetch. No point is held in
// registers across an add: a shared-memory scan reads both operands from a
// ping-pong buffer (one barrier a level), the run walk keeps its sum in
// shared memory, and the last two passes are one add a thread, out of place.
// A point kept in registers beside the add, or an add that overwrites its
// own operand in device memory, spills.
#include "g1.cuh"

namespace kzg {

constexpr int kHsBlock = 256;

// physical lane of logical lane g in row r
__device__ __forceinline__ long long hs_lane(int r, int W, long long g, int reverse) {
  return (long long)r * W + (reverse ? (W - 1 - g) : g);
}

// Inclusive Hillis-Steele over the block's n values in buf[0..n), with
// buf[n..2n) as the second buffer; returns this thread's result.
__device__ __forceinline__ jac_t hs_shared(jac_t* buf, int n, int t) {
  int cur = 0;
  for (int shift = 1; shift < n; shift <<= 1) {
    __syncthreads();
    const jac_t* src = buf + cur * n;
    jac_t* dst = buf + (cur ^ 1) * n;
    if (t < n) dst[t] = t >= shift ? jac_add<FieldCalled>(src[t], src[t - shift]) : src[t];
    cur ^= 1;
  }
  return buf[cur * n + t];
}

__global__ void __launch_bounds__(kHsBlock) hs_block_kernel(const u32* x, const u32* y,
                                                            const u32* z, u32* ox, u32* oy,
                                                            u32* oz, int R, int W, int reverse) {
  extern __shared__ jac_t hs_buf[];
  const int r = blockIdx.x;
  const int t = threadIdx.x;
  const long long stride = (long long)R * W;
  if (t < W) hs_buf[t] = load_jac(x, y, z, stride, hs_lane(r, W, t, reverse));
  const jac_t v = hs_shared(hs_buf, W, t);
  if (t < W) store_jac(ox, oy, oz, stride, hs_lane(r, W, t, reverse), v);
}

// grid (segments, R), block B. out: the runs' own prefixes; (rx, ry, rz)
// (12, R, segments * B): each run's inclusive scan within its segment;
// (sx, sy, sz) (12, R, segments): each segment's total.
__global__ void __launch_bounds__(kHsBlock) hs_runs_kernel(const u32* x, const u32* y,
                                                           const u32* z, u32* ox, u32* oy,
                                                           u32* oz, u32* rx, u32* ry, u32* rz,
                                                           u32* sx, u32* sy, u32* sz, int R,
                                                           int W, int run, int reverse) {
  extern __shared__ jac_t hs_buf[];
  const int B = blockDim.x;
  const int seg = blockIdx.x;
  const int r = blockIdx.y;
  const int t = threadIdx.x;
  const int nseg = gridDim.x;
  const long long stride = (long long)R * W;
  const long long run_idx = (long long)seg * B + t;
  const long long lo = run_idx * run;
  const long long hi = min(lo + run, (long long)W);
  // the walk's sum and next point wait in shared memory past the scan's two
  // buffers, read afresh by each add
  jac_t* op = hs_buf + 2 * B + 2 * t;
  op[0] = jac_inf();
  if (lo < W) {
    op[0] = load_jac(x, y, z, stride, hs_lane(r, W, lo, reverse));
    store_jac(ox, oy, oz, stride, hs_lane(r, W, lo, reverse), op[0]);
    for (long long g = lo + 1; g < hi; g++) {
      const long long p = hs_lane(r, W, g, reverse);
      op[1] = load_jac(x, y, z, stride, p);
      asm volatile("" ::: "memory");
      op[0] = jac_add<FieldCalled>(op[0], op[1]);
      asm volatile("" ::: "memory");
      store_jac(ox, oy, oz, stride, p, op[0]);
    }
  }
  hs_buf[t] = op[0];
  const jac_t v = hs_shared(hs_buf, B, t);
  const long long nruns = (long long)nseg * B;
  store_jac(rx, ry, rz, (long long)R * nruns, (long long)r * nruns + run_idx, v);
  if (t == B - 1) store_jac(sx, sy, sz, (long long)R * nseg, (long long)r * nseg + seg, v);
}

// grid (ceil(runs / 128), R). Run i's offset, everything before it, into
// (fx, fy, fz) (12, R, runs): the runs before alone in the first segment,
// the segments before alone for a segment's first run, else the segments
// before plus the runs before. (cx, cy, cz) (12, R, segments): the inclusive
// scan of the segment totals. Run 0 has no offset.
__global__ void __launch_bounds__(128) hs_offsets_kernel(const u32* rx, const u32* ry,
                                                         const u32* rz, const u32* cx,
                                                         const u32* cy, const u32* cz, u32* fx,
                                                         u32* fy, u32* fz, int R, int W, int run,
                                                         int B, int nseg) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  const int nruns = nseg * B;
  if (i == 0 || i >= nruns || (long long)i * run >= W) return;
  const int seg = i / B;
  const int t = i % B;
  const long long rstride = (long long)R * nruns;
  const long long cstride = (long long)R * nseg;
  const long long ri = (long long)r * nruns + i;
  const long long ci = (long long)r * nseg + seg - 1;
  jac_t off;
  if (seg == 0) {
    off = load_jac(rx, ry, rz, rstride, ri - 1);
  } else if (t == 0) {
    off = load_jac(cx, cy, cz, cstride, ci);
  } else {
    off = jac_add<FieldCalled>(load_jac(cx, cy, cz, cstride, ci),
                              load_jac(rx, ry, rz, rstride, ri - 1));
  }
  store_jac(fx, fy, fz, rstride, ri, off);
}

// grid (ceil(W / 128), R), one thread a lane: out = offset of the lane's run
// + the run's own prefix (loc), the first run's prefixes as they are. Out of
// place: an add whose result overwrites its operand spills here.
__global__ void __launch_bounds__(128) hs_apply_kernel(const u32* lx, const u32* ly,
                                                       const u32* lz, u32* ox, u32* oy, u32* oz,
                                                       const u32* fx, const u32* fy,
                                                       const u32* fz, int R, int W, int run,
                                                       int nruns, int reverse) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (g >= W) return;
  const long long stride = (long long)R * W;
  const long long p = hs_lane(r, W, g, reverse);
  const jac_t loc = load_jac(lx, ly, lz, stride, p);
  if (g < run) {
    store_jac(ox, oy, oz, stride, p, loc);
    return;
  }
  const jac_t off = load_jac(fx, fy, fz, (long long)R * nruns, (long long)r * nruns + g / run);
  store_jac(ox, oy, oz, stride, p, jac_add<FieldCalled>(off, loc));
}

// Dynamic shared memory of a Hillis-Steele over n points, two buffers (and,
// for hs_runs, two operand slots a thread after them).
inline int hs_smem(int n) { return 2 * n * (int)sizeof(jac_t); }

template <typename K>
inline cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              2 * hs_smem(kHsBlock));
}

}  // namespace kzg

// W <= 256: one block a row, the JAX package's Hillis-Steele order.
extern "C" int kzg_hs_scan_block(const void* x, const void* y, const void* z, void* ox, void* oy,
                                 void* oz, int R, int W, int reverse, void* stream) {
  using namespace kzg;
  if (R <= 0 || W <= 0) return 0;
  if (W > kHsBlock) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = allow_smem(hs_block_kernel);
  if (attr != cudaSuccess) return (int)attr;
  const int threads = (W + 31) / 32 * 32;
  hs_block_kernel<<<R, threads, hs_smem(threads), (cudaStream_t)stream>>>(
      (const u32*)x, (const u32*)y, (const u32*)z, (u32*)ox, (u32*)oy, (u32*)oz, R, W, reverse);
  return (int)cudaGetLastError();
}

// W > 256, first pass: segments of `block` threads x `run` lanes.
extern "C" int kzg_hs_scan_runs(const void* x, const void* y, const void* z, void* ox, void* oy,
                                void* oz, void* rx, void* ry, void* rz, void* sx, void* sy,
                                void* sz, int R, int W, int run, int block, int reverse,
                                void* stream) {
  using namespace kzg;
  if (R <= 0 || W <= 0) return 0;
  if (run <= 0 || block <= 0 || block > kHsBlock) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = allow_smem(hs_runs_kernel);
  if (attr != cudaSuccess) return (int)attr;
  const long long lanes = (long long)run * block;
  const dim3 grid((unsigned)((W + lanes - 1) / lanes), R);
  hs_runs_kernel<<<grid, block, 2 * hs_smem(block), (cudaStream_t)stream>>>(
      (const u32*)x, (const u32*)y, (const u32*)z, (u32*)ox, (u32*)oy, (u32*)oz, (u32*)rx,
      (u32*)ry, (u32*)rz, (u32*)sx, (u32*)sy, (u32*)sz, R, W, run, reverse);
  return (int)cudaGetLastError();
}

// W > 256, third pass: each run's offset, into (fx, fy, fz) (12, R, runs).
extern "C" int kzg_hs_scan_offsets(const void* rx, const void* ry, const void* rz,
                                   const void* cx, const void* cy, const void* cz, void* fx,
                                   void* fy, void* fz, int R, int W, int run, int block,
                                   void* stream) {
  using namespace kzg;
  if (R <= 0 || W <= 0) return 0;
  if (run <= 0 || block <= 0 || block > kHsBlock) return (int)cudaErrorInvalidValue;
  const long long lanes = (long long)run * block;
  const int nseg = (int)((W + lanes - 1) / lanes);
  const int nruns = nseg * block;
  const dim3 grid((nruns + 127) / 128, R);
  hs_offsets_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const u32*)rx, (const u32*)ry, (const u32*)rz, (const u32*)cx, (const u32*)cy,
      (const u32*)cz, (u32*)fx, (u32*)fy, (u32*)fz, R, W, run, block, nseg);
  return (int)cudaGetLastError();
}

// W > 256, last pass: out = each lane's run offset + its run prefix (loc).
extern "C" int kzg_hs_scan_apply(const void* lx, const void* ly, const void* lz, void* ox,
                                 void* oy, void* oz, const void* fx, const void* fy,
                                 const void* fz, int R, int W, int run, int block, int reverse,
                                 void* stream) {
  using namespace kzg;
  if (R <= 0 || W <= 0) return 0;
  if (run <= 0 || block <= 0 || block > kHsBlock) return (int)cudaErrorInvalidValue;
  const long long lanes = (long long)run * block;
  const int nruns = (int)((W + lanes - 1) / lanes) * block;
  const dim3 grid((W + 127) / 128, R);
  hs_apply_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const u32*)lx, (const u32*)ly, (const u32*)lz, (u32*)ox, (u32*)oy, (u32*)oz,
      (const u32*)fx, (const u32*)fy, (const u32*)fz, R, W, run, nruns, reverse);
  return (int)cudaGetLastError();
}
