// K2b: the batched-affine MSM, sum_i k_i P_i over n affine points, as one
// kernel in one launch (the commit and the proof below the fixed-base
// threshold, and every commit against a list of setup artifacts).
//
// Replaces kzg_tpu/ops/pallas_curve.py _run_point_kernel (:260) as
// kzg_tpu/ops/msm.py:74-85 (msm_batched_affine) uses it: mul_scalar_affine's
// 256-step double-and-add ladder (kzg_tpu/ops/curve.py:228-245), one double
// and one madd launch a step, then tree_reduce (msm.py:30-61), one add
// launch a level. Run that way on this card it took 525 K2 launches at
// n = 8192, each waiting on one point operation's latency, with the bit
// tests and selects between them as plain tensor ops on the host's clock.
//
//   One thread a lane, kLadderThreads lanes a block. Each thread puts its
//   affine P_i and its standard-form scalar words in shared memory and runs
//   the ladder in mul_scalar_affine's order (g1.cuh ladder_step, the step
//   the scalar multiplications of mul_ladder.cu share): acc = 2 acc, then
//   acc + P_i where bit b of k_i is set, b from the top down. Every lane
//   computes every step's madd and keeps it by a select: no branch on the bit. The
//   madd is the 11-multiply one (jac_madd_fast); a lane with acc == P_i needs
//   the doubling instead, and its warp computes that only when one of its
//   lanes needs it (a warp-uniform branch). So each step's output is the
//   exact madd's, acc = infinity and acc = -P_i included. The steps above
//   the block's highest set bit are skipped: there every lane's acc is
//   infinity, whose doubling gives the same zero words. Lanes past n and
//   lanes flagged in inf_mask take the scalar 0: their product is infinity
//   in zero words, as the JAX package's select writes it.
//
//   The sum is the JAX package's tree_reduce pairing: at s = 1, 2, 4, ..,
//   lane j adds lane j + s, j a multiple of 2 s. Within the block, in shared
//   memory (kLadderLevels levels), then the block's sum to scratch; the last
//   block to finish (an atomic counter the entry point zeroes on the stream
//   first) runs the remaining levels over the block sums in scratch, block b's
//   sum standing for lane b kLadderThreads. The JAX package pads the lanes to
//   a power of two with infinity, and its add returns the first operand
//   unchanged when the second is infinity: here a pair whose partner lies
//   past the end is skipped, which gives the same words. So the output
//   equals the plain version's (ops/msm.py msm_batched_plain) and the JAX
//   package's word for word.
//
// Bound on an H100: operations, at every n (a lane reads 128 bytes and does
// up to 256 doublings and 256 mixed adds). What holds it back below a few
// waves of blocks is its chain: up to 256 doublings and 256 madds on one
// thread, then kLadderLevels + ceil(log2(blocks)) adds, each a chain of
// dependent field multiplies. So every point operation calls the
// out-of-line multiply and square (g1.cuh FieldCalled), which a dependent
// chain runs in under half the time of the inlined formulas (instruction
// fetch), and acc, its madd, P_i and k_i live in shared memory, not in
// registers across those calls, as in the bucket reduction.
#include "g1.cuh"

namespace kzg {

constexpr int kLadderThreads = 128;  // lanes a block
constexpr int kLadderLevels = 7;     // log2(kLadderThreads): the block's tree
constexpr int kScalarWords = 8;
static_assert(1 << kLadderLevels == kLadderThreads, "the block's tree has kLadderLevels levels");

using LadderOps = FieldCalled;

struct LadderSmem {
  jac_t acc[kLadderThreads];  // each lane's accumulator, then the block's tree
  jac_t sum[kLadderThreads];  // each lane's madd; the last block's second operands
  fp_t px[kLadderThreads], py[kLadderThreads];
  u32 k[kScalarWords][kLadderThreads];
};

__global__ void __launch_bounds__(kLadderThreads) ladder_msm_kernel(
    const u32* px, const u32* py, const u32* k, const unsigned char* inf_mask, jac_t* scratch,
    int* counter, jac_t* out, int n) {
  extern __shared__ __align__(16) unsigned char ladder_smem[];
  LadderSmem& s = *reinterpret_cast<LadderSmem*>(ladder_smem);
  __shared__ int top;
  __shared__ bool last;
  const int t = threadIdx.x;
  const long long i = (long long)blockIdx.x * kLadderThreads + t;
  const bool live = i < n && (inf_mask == nullptr || !inf_mask[i]);
  if (t == 0) top = -1;
  s.px[t] = i < n ? load<12>(px, n, i) : zero<12>();
  s.py[t] = i < n ? load<12>(py, n, i) : zero<12>();
  int high = -1;  // this lane's highest set bit
#pragma unroll
  for (int w = 0; w < kScalarWords; w++) {
    const u32 kw = live ? k[(long long)w * n + i] : 0u;
    s.k[w][t] = kw;
    if (kw) high = 32 * w + 31 - __clz(kw);
  }
  s.acc[t] = jac_inf();
  __syncthreads();
  if (high >= 0) atomicMax(&top, high);
  __syncthreads();

  const int first = top;
#pragma unroll 1
  for (int b = first; b >= 0; b--)
    ladder_step<LadderOps, false>(s.acc[t], s.sum[t], s.px[t], s.py[t], s.k[b >> 5][t], b);

  // the block's tree: at distance h, thread q adds lane 2 h q + h into 2 h q
#pragma unroll 1
  for (int h = 1; h < kLadderThreads; h <<= 1) {  // kLadderLevels levels
    __syncthreads();
    const int j = 2 * h * t;
    if (j < kLadderThreads) s.acc[j] = jac_add<LadderOps>(s.acc[j], s.acc[j + h]);
  }
  __syncthreads();
  const int blocks = gridDim.x;
  if (blocks == 1) {
    if (t == 0) *out = s.acc[0];
    return;
  }
  if (t == 0) {
    scratch[blockIdx.x] = s.acc[0];
    __threadfence();
    last = atomicAdd(counter, 1) == blocks - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the levels above the blocks, over the block sums in scratch: at
  // distance h, sum j = 2 h q adds sum j + h where that exists, for
  // q = t, t + kLadderThreads, ..
#pragma unroll 1
  for (int h = 1; h < blocks; h <<= 1) {
#pragma unroll 1
    for (long long j = 2LL * h * t; j + h < blocks; j += 2LL * h * kLadderThreads) {
      s.acc[t] = load_jac_cg(scratch + j);
      s.sum[t] = load_jac_cg(scratch + j + h);
      asm volatile("" ::: "memory");
      scratch[j] = jac_add<LadderOps>(s.acc[t], s.sum[t]);
    }
    __threadfence();
    __syncthreads();
  }
  if (t == 0) *out = load_jac_cg(scratch);
}

}  // namespace kzg

// px, py: (12, n) affine Montgomery words; k: (8, n) standard-form scalar
// words; inf_mask: (n,) bytes, or null; scratch: one point a block of
// kLadderThreads lanes (36 words), then the counter (one int); out: one
// point, x then y then z words.
extern "C" int kzg_ladder_msm(const void* px, const void* py, const void* k,
                              const void* inf_mask, void* scratch, void* out, int n,
                              void* stream) {
  using namespace kzg;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  constexpr int smem = (int)sizeof(LadderSmem);
  static const cudaError_t attr = cudaFuncSetAttribute(
      ladder_msm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const int blocks = (n + kLadderThreads - 1) / kLadderThreads;
  int* counter = (int*)((jac_t*)scratch + blocks);
  const cudaError_t zeroed = cudaMemsetAsync(counter, 0, sizeof(int), (cudaStream_t)stream);
  if (zeroed != cudaSuccess) return (int)zeroed;
  ladder_msm_kernel<<<blocks, kLadderThreads, smem, (cudaStream_t)stream>>>(
      (const u32*)px, (const u32*)py, (const u32*)k, (const unsigned char*)inf_mask,
      (jac_t*)scratch, counter, (jac_t*)out, n);
  return (int)cudaGetLastError();
}
