// K2 and K9 as the scalar multiplications use them: [k_i] P_i on every lane
// i in one launch, the double-and-add ladder with mixed adds of each group
// (g1_ladder_kernel over Fp, g2_ladder_kernel over Fp2).
//
// Replaces kzg_tpu/ops/pallas_curve.py _run_point_kernel (:260) as
// kzg_tpu/ops/curve.py:205-245 uses it: mul_scalar_affine's 256-step ladder,
// one double and one madd launch a bit with a select between them, and
// mul_scalar's [r] P of the subgroup check, one double launch a bit and an
// add launch a set bit (G2's formulas are XLA around K1 there; K9's note in
// g2_point.cu). Run that way on this card, the ladder took 512 launches at
// one lane (the verify's x G2 and y G1) and the subgroup check 387 at 2^20
// lanes, each launch waiting on one point operation's latency and moving
// every operand through device memory.
//
// Callers (kzg_torch/ops/curve.py g1_ladder / g2_ladder): mul_scalar_affine,
// one scalar a lane on an affine base (the generator multiplications below
// GENMUL_TABLE_THRESHOLD: the verify's x G2 and y G1, generate_setup below
// 512 points); and mul_scalar with one python-int scalar (the codec's
// [r] P), which the wrapper writes to every lane, the lanes at infinity
// flagged, on the points' (X, Y): their Z is one, so the mixed add gives
// the add's words.
//
//   One thread a lane, kThreads lanes a block. Each thread keeps its acc,
//   the madd's output, its affine base and its scalar words in dynamic
//   shared memory, and only a formula's temporaries in registers. It runs
//   ladder_step (g1.cuh, the batched MSM's step) from the block's highest
//   set bit down: acc = 2 acc, then the 11-multiply madd, its doubling
//   computed only by a warp with a lane at acc == P, kept where the lane's
//   bit is set. A warp none of whose lanes has the bit set skips the madd:
//   with one scalar for every lane, [r] P makes 254 doublings and 133
//   madds. The steps above the block's highest set bit are skipped: every
//   acc there is infinity, whose doubling gives the same zero words. Lanes
//   past n and lanes flagged in inf_mask take the scalar 0 (infinity in zero
//   words); every thread runs every step, so each warp is whole at
//   __any_sync; only lanes below n store. Every point operation calls the
//   out-of-line multiply (g1.cuh FieldCalled; g2.cuh's Fp2Ops over it for
//   G2): a dependent chain runs it in under half the time of the inlined
//   formulas. So the output is the step-by-step route's Jacobian triple word
//   for word: curve.ladder_plain, whose steps are the JAX package's.
//
// Bound on an H100: operations (a lane reads its affine base and 32 bytes of
// scalar and writes one Jacobian point: 8 to 10 of the group's elements,
// against about 255 doublings and 64 to 133 mixed adds). At 2^20 lanes (the
// SRS's decompression) it fills the card: 2^13 blocks of G1. At 1 to 128
// lanes (the verify, a 10-point setup) it runs one thread's chain of up to
// 256 doublings and 256 madds, each a chain of dependent field multiplies.
#include "g2.cuh"

namespace kzg {

constexpr int kG1LadderThreads = 128;  // lanes a block: 53,248 B of shared memory
constexpr int kG2LadderThreads = 64;   // 51,200 B

template <class Ops, int kThreads>
struct MulLadderSmem {
  using El = typename Ops::elem;
  jac_of<El> acc[kThreads];  // each lane's accumulator
  jac_of<El> sum[kThreads];  // each lane's madd
  El px[kThreads], py[kThreads];
  u32 k[8][kThreads];
};

__device__ __forceinline__ void load_elem(fp_t& v, const u32* base, int n, long long i) {
  v = load<12>(base, n, i);
}
__device__ __forceinline__ void load_elem(fp2_t& v, const u32* base, int n, long long i) {
  v = load2(base, n, i);
}
__device__ __forceinline__ void store_elem(u32* base, int n, long long i, const fp_t& v) {
  store<12>(base, n, i, v);
}
__device__ __forceinline__ void store_elem(u32* base, int n, long long i, const fp2_t& v) {
  store2(base, n, i, v);
}

template <class Ops, int kThreads>
__device__ __forceinline__ void mul_ladder(const u32* px, const u32* py, const u32* k,
                                           const unsigned char* inf_mask, u32* ox, u32* oy,
                                           u32* oz, int n, unsigned char* smem, int& top) {
  using Smem = MulLadderSmem<Ops, kThreads>;
  Smem& s = *reinterpret_cast<Smem*>(smem);
  const int t = threadIdx.x;
  const long long i = (long long)blockIdx.x * kThreads + t;
  const bool live = i < n && (inf_mask == nullptr || !inf_mask[i]);
  if (t == 0) top = -1;
  if (i < n) {
    load_elem(s.px[t], px, n, i);
    load_elem(s.py[t], py, n, i);
  } else {
    s.px[t] = Ops::zero();
    s.py[t] = Ops::zero();
  }
  int high = -1;  // this lane's highest set bit
#pragma unroll
  for (int w = 0; w < 8; w++) {
    const u32 kw = live ? k[(long long)w * n + i] : 0u;
    s.k[w][t] = kw;
    if (kw) high = 32 * w + 31 - __clz(kw);
  }
  s.acc[t] = pt_inf<Ops, jac_of<typename Ops::elem>>();
  __syncthreads();
  if (high >= 0) atomicMax(&top, high);
  __syncthreads();

  const int first = top;
#pragma unroll 1
  for (int b = first; b >= 0; b--)
    ladder_step<Ops, true>(s.acc[t], s.sum[t], s.px[t], s.py[t], s.k[b >> 5][t], b);
  if (i < n) {
    store_elem(ox, n, i, s.acc[t].x);
    store_elem(oy, n, i, s.acc[t].y);
    store_elem(oz, n, i, s.acc[t].z);
  }
}

__global__ void __launch_bounds__(kG1LadderThreads) g1_ladder_kernel(
    const u32* px, const u32* py, const u32* k, const unsigned char* inf_mask, u32* ox, u32* oy,
    u32* oz, int n) {
  extern __shared__ __align__(16) unsigned char g1_ladder_smem[];
  __shared__ int top;
  mul_ladder<FieldCalled, kG1LadderThreads>(px, py, k, inf_mask, ox, oy, oz, n, g1_ladder_smem,
                                            top);
}

__global__ void __launch_bounds__(kG2LadderThreads) g2_ladder_kernel(
    const u32* px, const u32* py, const u32* k, const unsigned char* inf_mask, u32* ox, u32* oy,
    u32* oz, int n) {
  extern __shared__ __align__(16) unsigned char g2_ladder_smem[];
  __shared__ int top;
  mul_ladder<Fp2Ops<FieldCalled>, kG2LadderThreads>(px, py, k, inf_mask, ox, oy, oz, n,
                                                    g2_ladder_smem, top);
}

template <class Ops, int kThreads, class Kernel>
int launch_ladder(Kernel kernel, const void* px, const void* py, const void* k,
                  const void* inf_mask, void* ox, void* oy, void* oz, int n, void* stream) {
  if (n <= 0) return 0;
  constexpr int smem = (int)sizeof(MulLadderSmem<Ops, kThreads>);
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<(n + kThreads - 1) / kThreads, kThreads, smem, (cudaStream_t)stream>>>(
      (const u32*)px, (const u32*)py, (const u32*)k, (const unsigned char*)inf_mask, (u32*)ox,
      (u32*)oy, (u32*)oz, n);
  return (int)cudaGetLastError();
}

}  // namespace kzg

// px, py: the affine base, (12, n) (G1) or (12, 2, n) (G2) Montgomery words;
// k: (8, n) standard-form scalar words; inf_mask: (n,) bytes, or null (a
// flagged lane's product is infinity); ox, oy, oz: the Jacobian output, in
// px's layout.
extern "C" int kzg_g1_ladder(const void* px, const void* py, const void* k, const void* inf_mask,
                             void* ox, void* oy, void* oz, int n, void* stream) {
  using namespace kzg;
  return launch_ladder<FieldCalled, kG1LadderThreads>(g1_ladder_kernel, px, py, k, inf_mask, ox,
                                                      oy, oz, n, stream);
}

extern "C" int kzg_g2_ladder(const void* px, const void* py, const void* k, const void* inf_mask,
                             void* ox, void* oy, void* oz, int n, void* stream) {
  using namespace kzg;
  return launch_ladder<Fp2Ops<FieldCalled>, kG2LadderThreads>(g2_ladder_kernel, px, py, k,
                                                              inf_mask, ox, oy, oz, n, stream);
}
