// The fixed-base MSM's bucket reduction (stages 6-7): from the fused scan's
// per-digit chunk prefixes U and K4's exclusive chunk offsets O to the one
// Jacobian point sum_b b S_b, in one launch.
//
// Replaces kzg_tpu/ops/pallas_curve.py _run_point_kernel (:260) as
// kzg_tpu/ops/msm.py:608-686 uses it (_fbs_extract_jit, then _fbs_reduce at
// :817: the grid trees, the suffix-weighted sums and the Horner combine),
// where it ran as 36 point-kernel launches with plain tensor glue between
// them. Not that route: the sum telescopes. With
//
//   V_b = valid_b ? U[slot_b] + O[c_b] : infinity   (b <= 2^15, top = 2^15)
//   S_b = V_b - V_(b-1),  V_(-1) = infinity
//
// sum_b b S_b = 2^15 V_top - sum_(b < top) V_b = sum_(b < top) (V_top - V_b),
// one halving tree over the 2^15 leaves L_b = V_top + (-V_b).
//
//   128 blocks of 256 threads, one leaf a thread. Each thread forms its
//   V_b, and thread 0 then forms V_top too; then each thread its leaf; then
//   the block's halving tree in shared memory, element i adding element
//   i + s for s = 128, 64, .., 1 (msm.tree_reduce's pairing); the block's
//   sum goes to scratch. The last block to finish (an atomic counter the
//   entry point zeroes on the stream first) reduces the 128 block sums the
//   same way, s = 64, .., 1, and writes the point. V_top on a warp of its
//   own would keep it off the chain, but a block of 9 warps is allotted
//   registers as 12 (in fours), which caps it at 168 registers a thread,
//   and the adds then spill; at 256 threads the kernel holds 179 and
//   spills nothing.
//
// Every add takes the operands the plain version (ops/msm.py
// bucket_reduce_plain) gives it, in the same order: jac_add(p, q) and
// jac_add(q, p) give different words for the same point, so this order is
// what makes the output equal the plain version's word for word. Empty
// buckets make V_b equal to its neighbours, so leaves that are equal (the
// add doubles) or infinity are common inputs here, not corner cases; the
// add (g1.cuh) handles both.
//
// Bound on an H100: operations. The function needs at most 2^16 + 1 point
// adds (8,940 IMADs each) and 15 doublings, 0.0350 ms of the card's integer
// rate at the commit's shapes, against 24 MB read at its 2^17 chunks; this
// route makes about 3 * 2^15 adds, on one wave of 128 blocks. What holds it
// back is latency, and its floor is now its chain: from input to output 18
// dependent adds (V_b and V_top on thread 0, the leaf, 8 levels, 7 levels)
// and no doublings, each a chain of field multiplies on one thread. So
// every add calls the out-of-line multiply and square (g1.cuh FieldCalled),
// which a dependent chain runs in under half the time of the inlined
// formulas (instruction fetch); and every point lives in shared memory, not
// in registers across an add, as K4's do.
#include "g1.cuh"

namespace kzg {

constexpr int kTop = 1 << 15;                // V_top's bucket; the leaves are b < kTop
constexpr int kLeaves = 256;                 // leaves a block
constexpr int kBrBlocks = kTop / kLeaves;    // 128 block sums
// dynamic shared memory, in points: the leaves, a second operand each, V_top
// and its second operand
constexpr int kBrSmemPoints = 2 * kLeaves + 2;

using BrOps = FieldCalled;

struct BucketIn {
  const u32 *ux, *uy, *uz;  // (12, nb) chunk prefixes, slot-indexed
  const u32 *ox, *oy, *oz;  // (12, C) exclusive chunk offsets
  const int* slot;          // (nb,) U's slot of bucket b
  const int* chunk;         // (nb,) its chunk
  const unsigned char* valid;
  int nb, C;
};

// V_b into *v, with *o a second operand slot; infinity where not valid
__device__ __forceinline__ void bucket_v(const BucketIn& in, int b, jac_t* v, jac_t* o) {
  if (!in.valid[b]) {
    *v = jac_inf();
    return;
  }
  *v = load_jac(in.ux, in.uy, in.uz, in.nb, in.slot[b]);
  *o = load_jac(in.ox, in.oy, in.oz, in.C, in.chunk[b]);
  asm volatile("" ::: "memory");
  *v = jac_add<BrOps>(*v, *o);
}

// A halving tree over pts[0, 2 half), in place: at distance s = half, ..,
// 1, thread t < s adds pts[t + s] into pts[t] (the points it reads are not
// written at that level); pts[0] ends with the sum. Every thread of the
// block must call it.
__device__ __forceinline__ void block_tree(jac_t* pts, int half, int t) {
#pragma unroll 1
  for (int s = half; s >= 1; s >>= 1) {
    __syncthreads();
    if (t < s) pts[t] = jac_add<BrOps>(pts[t], pts[t + s]);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kLeaves) bucket_reduce_kernel(BucketIn in, jac_t* scratch,
                                                                int* counter, jac_t* out) {
  extern __shared__ jac_t br_smem[];
  jac_t* pts = br_smem;             // the leaves, then the block sums
  jac_t* opnd = br_smem + kLeaves;  // each V_b's second operand
  jac_t* top = br_smem + 2 * kLeaves;
  __shared__ bool last;
  const int t = threadIdx.x;
  bucket_v(in, blockIdx.x * kLeaves + t, pts + t, opnd + t);
  if (t == 0) bucket_v(in, kTop, top, top + 1);
  __syncthreads();
  // L_b = V_top + (-V_b)
  pts[t].y = fsub(zero<12>(), pts[t].y);
  asm volatile("" ::: "memory");
  pts[t] = jac_add<BrOps>(top[0], pts[t]);
  block_tree(pts, kLeaves / 2, t);
  if (t == 0) {
    scratch[blockIdx.x] = pts[0];
    __threadfence();
    last = atomicAdd(counter, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (t < kBrBlocks) pts[t] = load_jac_cg(scratch + t);
  block_tree(pts, kBrBlocks / 2, t);
  if (t == 0) *out = pts[0];
}

}  // namespace kzg

// scratch: the kBrBlocks block sums, points of 36 words, then the counter
// (one int); out: one point, x then y then z words
extern "C" int kzg_bucket_reduce(const void* ux, const void* uy, const void* uz, const void* ox,
                                 const void* oy, const void* oz, const void* slot,
                                 const void* chunk, const void* valid, void* scratch, void* out,
                                 int nb, int C, void* stream) {
  using namespace kzg;
  if (nb != kTop + 1 || C <= 0) return (int)cudaErrorInvalidValue;
  constexpr int smem = kBrSmemPoints * (int)sizeof(jac_t);
  static const cudaError_t attr = cudaFuncSetAttribute(
      bucket_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  int* counter = (int*)((jac_t*)scratch + kBrBlocks);
  const cudaError_t zeroed = cudaMemsetAsync(counter, 0, sizeof(int), (cudaStream_t)stream);
  if (zeroed != cudaSuccess) return (int)zeroed;
  const BucketIn in{(const u32*)ux, (const u32*)uy,   (const u32*)uz,
                    (const u32*)ox, (const u32*)oy,   (const u32*)oz,
                    (const int*)slot, (const int*)chunk, (const unsigned char*)valid,
                    nb,             C};
  bucket_reduce_kernel<<<kBrBlocks, kLeaves, smem, (cudaStream_t)stream>>>(
      in, (jac_t*)scratch, counter, (jac_t*)out);
  return (int)cudaGetLastError();
}
