// The fixed-base MSM's bucket reduction (stages 6-7): from the fused scan's
// per-digit chunk prefixes U and K4's exclusive chunk offsets O to the one
// Jacobian point sum_b b S_b, in three launches.
//
// Replaces kzg_tpu/ops/pallas_curve.py _run_point_kernel (:260) as
// kzg_tpu/ops/msm.py:610-690 uses it (_fbs_extract_jit, then _fbs_reduce:
// the grid trees, the suffix-weighted sums and the Horner combine), where it
// ran as 36 point-kernel launches with plain tensor glue between them.
//
//   V_b = valid_b ? U[slot_b] + O[c_b] : infinity,  S_b = V_b - V_(b-1)
//   b = 2^10 u + 2^5 v + w:  T1[u, v] = sum_w S_b,  T2[v, w] = sum_u S_b
//   A_u = sum_v T1[u, v],  B_v = sum_u T1[u, v],  C_w = sum_v T2[v, w]
//   W_X = sum_k k X_k = sum_j Tx_j - Tx_0,  Tx_j = sum_(k >= j) X_k
//   result = 2^15 S_top + 2^10 W_A + 2^5 W_B + W_C  (Horner, 5 doublings a step)
//
// Every add takes the operands the plain version (ops/msm.py
// bucket_reduce_plain) gives it, in the same order: g1_add(p, q) and
// g1_add(q, p) give different words for the same point, so this order is
// what makes the output equal the plain version's word for word. A sum of
// 32 is a halving tree: element i adds element i + 16, then i + 8, ..., i + 1
// (msm.tree_reduce's pairing).
//   bucket_v:    one thread a bucket: V_b, to scratch.
//   bucket_grid: a block of 128 threads forms 4 grid sums of 32 (T1 at sum
//                32 u + v, T2 at 1024 + 32 v + w): each thread S_b from
//                V_b and V_(b-1), then the 4 trees packed onto the block's
//                first threads, one level a barrier.
//   bucket_rows: 24 blocks of 4 row sums A, B, C by the same trees; the
//                last block to finish (a counter the first launch zeroes)
//                goes on with the tail: each row's reverse suffix sums in
//                K4's W <= 256 order (at level s element j adds j + s),
//                their tree, minus T_0, on three warps, while a fourth forms
//                S_top and its first 5 doublings; then the Horner on one
//                thread.
//
// Bound on an H100: operations. S telescopes, so sum_b b S_b = 2^15 V_top -
// sum_(b < 2^15) V_b: the function needs at most 2^16 + 1 point adds (8,940
// IMADs each) and 15 doublings, against 24 MB read at the commit's 2^17
// chunks; this route makes about twice those adds. What holds it back is
// latency: the path from input to output is 26 dependent adds and 10
// dependent doublings, each a chain of field multiplies on one thread, and
// the rows and tail run on 24 blocks and one. So every add and doubling calls the out-of-line multiply and square
// (g1.cuh FieldCalled), which a dependent chain runs in under half the time
// of the inlined formulas (instruction fetch); the trees read and write
// their points in shared memory, as K4 does, so that no point outlives an
// add in registers; and each bucket's V is formed once, not in every sum
// that reads it.
#include "g1.cuh"

namespace kzg {

constexpr int kSide = 32;                      // b = 2^10 u + 2^5 v + w
constexpr int kTop = 1 << 15;                  // S_top, the bucket past the grid
constexpr int kGridSums = 2 * kSide * kSide;   // T1[u, v], then T2[v, w]
constexpr int kRowSums = 3 * kSide;            // A_u, B_v, C_w
constexpr int kHornerBits = 5;
constexpr int kBrBlock = 128;
constexpr int kBlockSums = kBrBlock / kSide;   // sums of 32 a block
// scratch, in points: V, the grid sums, the row sums; then one int counter
constexpr int kScratchGrid = kTop + 1;
constexpr int kScratchRows = kScratchGrid + kGridSums;
constexpr int kScratchPoints = kScratchRows + kRowSums;

using BrOps = FieldCalled;

struct BucketIn {
  const u32 *ux, *uy, *uz;  // (12, nb) chunk prefixes, slot-indexed
  const u32 *ox, *oy, *oz;  // (12, C) exclusive chunk offsets
  const int* slot;          // (nb,) U's slot of bucket b
  const int* chunk;         // (nb,) its chunk
  const unsigned char* valid;
  int nb, C;
};

__device__ __forceinline__ jac_t jneg(jac_t p) {
  p.y = fsub(zero<12>(), p.y);
  return p;
}

// S_b = V_b + (-V_(b-1)) into *s, V_(-1) infinity; prev a second slot
__device__ __forceinline__ void bucket_s(const jac_t* V, int b, jac_t* s, jac_t* prev) {
  *prev = b > 0 ? jneg(V[b - 1]) : jac_inf();
  *s = V[b];
  asm volatile("" ::: "memory");
  *s = g1_add<BrOps>(*s, *prev);
}

// kSums halving trees of 32 points in shared memory, sum j at
// pts[32 j, 32 j + 32), in place: at distance s = 16, 8, .., 1 thread
// t < kSums s adds pts[32 j + i + s] into pts[32 j + i] (j = t / s,
// i = t % s; the points it reads are not written at that level); pts[32 j]
// ends with sum j. Every thread of the block must call it.
template <int kSums>
__device__ __forceinline__ void block_trees(jac_t* pts, int t) {
#pragma unroll 1
  for (int lg = 4; lg >= 0; lg--) {
    const int s = 1 << lg;
    __syncthreads();
    if (t < kSums * s) {
      jac_t* p = pts + ((t >> lg) << 5) + (t & (s - 1));
      *p = g1_add<BrOps>(p[0], p[s]);
    }
  }
  __syncthreads();
}

// The same tree over one warp's 32 points, lane i adding i + s.
__device__ __forceinline__ void warp_tree(jac_t* pts, int lane) {
#pragma unroll 1
  for (int s = 16; s >= 1; s >>= 1) {
    __syncwarp();
    if (lane < s) pts[lane] = g1_add<BrOps>(pts[lane], pts[lane + s]);
  }
  __syncwarp();
}

__device__ __forceinline__ jac_t load_jac_cg(const jac_t* p) {
  const u32* w = reinterpret_cast<const u32*>(p);
  jac_t r;
  u32* o = reinterpret_cast<u32*>(&r);
#pragma unroll
  for (int j = 0; j < 36; j++) o[j] = __ldcg(w + j);
  return r;
}

__global__ void __launch_bounds__(kBrBlock) bucket_v_kernel(BucketIn in, jac_t* scratch,
                                                            int* counter) {
  const int b = blockIdx.x * kBrBlock + threadIdx.x;
  if (b == 0) *counter = 0;
  if (b >= in.nb) return;
  jac_t v = jac_inf();
  if (in.valid[b]) {
    const jac_t u = load_jac(in.ux, in.uy, in.uz, in.nb, in.slot[b]);
    const jac_t o = load_jac(in.ox, in.oy, in.oz, in.C, in.chunk[b]);
    v = g1_add<BrOps>(u, o);
  }
  scratch[b] = v;
}

__global__ void __launch_bounds__(kBrBlock) bucket_grid_kernel(jac_t* scratch) {
  __shared__ jac_t pts[kBrBlock], prev[kBrBlock];
  const int t = threadIdx.x;
  const int sum = blockIdx.x * kBlockSums + (t >> 5);
  const int e = t & 31;  // the element of the sum
  // T1 sum 32 u + v reads b = 32 sum + w (w = e); T2 sum 1024 + 32 v + w
  // reads b = 1024 u + 32 v + w (u = e)
  const int b = sum < kSide * kSide ? (sum << 5) + e : (e << 10) + sum - kSide * kSide;
  bucket_s(scratch, b, pts + t, prev + t);
  block_trees<kBlockSums>(pts, t);
  if (t < kBlockSums) scratch[kScratchGrid + blockIdx.x * kBlockSums + t] = pts[t << 5];
}

// The rows, then, in the last block, the tail.
__global__ void __launch_bounds__(kBrBlock) bucket_rows_kernel(jac_t* scratch, int* counter,
                                                               jac_t* out) {
  __shared__ jac_t scan[2][kRowSums], weighted[3], top[2];
  __shared__ bool last;
  jac_t* pts = &scan[0][0];  // the rows' trees: kBrBlock points
  const int t = threadIdx.x;
  const int r = blockIdx.x * kBlockSums + (t >> 5);  // 32 row + i
  const int e = t & 31, row = r >> 5, i = r & 31;
  // A_u (u = i) reads T1[u, v = e]; B_v (v = i) T1[u = e, v]; C_w (w = i)
  // T2[v = e, w]
  const int k = row == 0 ? (i << 5) + e
                         : (row == 1 ? (e << 5) + i : kSide * kSide + (e << 5) + i);
  pts[t] = scratch[kScratchGrid + k];
  block_trees<kBlockSums>(pts, t);
  if (t < kBlockSums) scratch[kScratchRows + blockIdx.x * kBlockSums + t] = pts[t << 5];
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(counter, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int lane = t & 31, w = t >> 5;
  if (w < 3) {
    // T_j = sum_(k >= j) X_k: at level s lane j adds lane j + s, if it exists
    scan[0][t] = load_jac_cg(scratch + kScratchRows + t);
    int cur = 0;
#pragma unroll 1
    for (int s = 1; s < kSide; s <<= 1) {
      __syncwarp();
      const jac_t* src = scan[cur] + (t & ~31);
      scan[cur ^ 1][t] = lane + s < kSide ? g1_add<BrOps>(src[lane], src[lane + s]) : src[lane];
      cur ^= 1;
    }
    __syncwarp();
    jac_t* tree = scan[cur ^ 1] + (t & ~31);  // T in scan[cur]; the tree on a copy
    tree[lane] = scan[cur][t];
    warp_tree(tree, lane);
    if (lane == 0) weighted[w] = g1_add<BrOps>(tree[0], jneg(scan[cur][t]));
  } else if (lane == 0) {
    bucket_s(scratch, kTop, top, top + 1);
#pragma unroll 1
    for (int d = 0; d < kHornerBits; d++) top[0] = g1_double<BrOps>(top[0]);
  }
  __syncthreads();
  if (t != 0) return;
  jac_t acc = top[0];  // 2^5 S_top
#pragma unroll 1
  for (int x = 0; x < 3; x++) {
    if (x) {
#pragma unroll 1
      for (int d = 0; d < kHornerBits; d++) acc = g1_double<BrOps>(acc);
    }
    acc = g1_add<BrOps>(acc, weighted[x]);
  }
  *out = acc;
}

}  // namespace kzg

// scratch: kScratchPoints points of 36 words, then the counter (one int)
namespace {
int* br_counter(void* scratch) {
  return (int*)((kzg::jac_t*)scratch + kzg::kScratchPoints);
}
}  // namespace

extern "C" int kzg_bucket_v(const void* ux, const void* uy, const void* uz, const void* ox,
                            const void* oy, const void* oz, const void* slot, const void* chunk,
                            const void* valid, void* scratch, int nb, int C, void* stream) {
  using namespace kzg;
  if (nb != kTop + 1 || C <= 0) return (int)cudaErrorInvalidValue;
  const BucketIn in{(const u32*)ux, (const u32*)uy,   (const u32*)uz,
                    (const u32*)ox, (const u32*)oy,   (const u32*)oz,
                    (const int*)slot, (const int*)chunk, (const unsigned char*)valid,
                    nb,             C};
  bucket_v_kernel<<<(nb + kBrBlock - 1) / kBrBlock, kBrBlock, 0, (cudaStream_t)stream>>>(
      in, (jac_t*)scratch, br_counter(scratch));
  return (int)cudaGetLastError();
}

extern "C" int kzg_bucket_grid(void* scratch, void* stream) {
  using namespace kzg;
  bucket_grid_kernel<<<kGridSums / kBlockSums, kBrBlock, 0, (cudaStream_t)stream>>>(
      (jac_t*)scratch);
  return (int)cudaGetLastError();
}

// out: one point, x then y then z words
extern "C" int kzg_bucket_rows(void* scratch, void* out, void* stream) {
  using namespace kzg;
  bucket_rows_kernel<<<kRowSums / kBlockSums, kBrBlock, 0, (cudaStream_t)stream>>>(
      (jac_t*)scratch, br_counter(scratch), (jac_t*)out);
  return (int)cudaGetLastError();
}
