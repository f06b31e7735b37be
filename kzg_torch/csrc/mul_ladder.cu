// K2 and K9 as the scalar multiplications use them: [k_i] P_i on every lane
// i in one launch, for G1 (over Fp) and G2 (over Fp2), in two modes of one
// template each.
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
// Mode A, the signed-digit ladder (g1_ladder_kernel, g2_ladder_kernel;
// kzg_torch/ops/curve.py g1_ladder / g2_ladder): mul_scalar with one
// python-int scalar (the codec's [r] P over 2^16 to 2^20 points, which the
// wrapper runs on the points' (X, Y), their Z being one, the lanes at
// infinity flagged) and mul_scalar_affine on any affine base, a scalar a
// lane. The wrapper recodes each scalar into its non-adjacent form (NAF:
// digits in {-1, 0, 1}, no two adjacent non-zero), as two bit masks of
// kDigitWords words, plus and minus; a shared scalar's masks are one column
// read by every lane (lane stride 0). r has 134 set bits but a NAF weight of
// 60: [r] P is 255 doublings and 59 madds a lane, against the binary
// ladder's 254 and 133, and -P costs nothing on an affine base.
//
//   One thread a lane, kThreads lanes a block. Each thread keeps its acc,
//   the madd's output, its affine base and -y in dynamic shared memory, and
//   only a formula's temporaries in registers; it reads a digit word a
//   step (L1; one address a warp for a shared scalar). The block starts at
//   its highest non-zero digit, where acc is (x, +-y, ONE) (the madd onto
//   infinity) or infinity, then runs g1.cuh naf_step below it: acc = 2 acc,
//   then the 11-multiply madd with (x, y) or (x, -y), its doubling computed
//   only by a warp with a lane at acc == +-P, kept where the digit is not 0;
//   a warp with no non-zero digit at the step skips the madd. A point
//   outside the subgroup reaches acc == P, acc == -P and infinity inside the
//   ladder (a point of order 3 does so every few steps), so the step keeps
//   the exact madd's cases. No endomorphism: phi(P) = lambda P holds only in
//   the subgroup the check tests. Lanes past n and lanes flagged in inf_mask
//   take the digits 0 (infinity in zero words); every thread runs every
//   step, so each warp is whole at __any_sync; only lanes below n store.
//
// Mode B, the generator's scalar split across the threads of a lane
// (g1_gen_ladder_kernel, g2_gen_ladder_kernel; curve.py g1_gen_ladder /
// g2_gen_ladder, reached by genmul.mul_gen_auto below
// GENMUL_TABLE_THRESHOLD: the verify's x G2 and y G1, generate_setup of a
// few points): [k_i] G for a fixed G. Scalar i is cut into kGenPieces
// pieces of kGenPieceBits bits; thread j of lane i's group multiplies the
// constant base [2^(kGenPieceBits j)] G (a table the wrapper caches on the
// device) by piece j with ladder_step (the binary ladder: at 4 bits at most
// 3 doublings and 3 madds), then log2(kGenPieces) levels of exact adds
// (g1.cuh jac_add, its doubling and infinity cases) join the pieces in
// shared memory, piece j + h into piece j, j a multiple of 2 h. The scalar
// is not reduced: the sum of the pieces is [k] G = [k mod r] G. One lane's
// chain falls from about 383-389 dependent point operations to at most
// 2 (kGenPieceBits - 1) + log2(kGenPieces): 12 at 4-bit pieces, two warps
// a lane. 8-bit pieces (one warp a lane, 19) took 26-35 % longer at 1 to
// 64 lanes, 16-bit pieces longer still; at 511 lanes 4-bit pieces are
// 9-11 % slower (scripts/mul_ladder_probe.py).
//
// Every point operation calls the out-of-line multiply (g1.cuh FieldCalled;
// g2.cuh's Fp2Ops over it for G2): a dependent chain runs it in under half
// the time of the inlined formulas. Every step's output is the plain
// formulas' word for word, so each kernel equals its plain version
// (curve.py naf_ladder_plain, gen_ladder_plain), which runs the same steps
// in the same order.
//
// Bound on an H100: operations. Mode A at 2^16 to 2^20 lanes (the subgroup
// checks) fills the card: 2^12 blocks of G1 at 2^20; a lane reads its affine
// base and writes one Jacobian point. G1's 256 threads a block (one block,
// 8 warps, an SM by registers) ran 9 % faster at 2^20 lanes and 23 % at
// 2^16 than 128 (three blocks an SM), 64, or 128 capped at 4 blocks an SM
// (spills), and the inlined multiply ran slower (scripts/mul_ladder_probe.py).
// Mode B at 1 to 511 lanes runs one lane's chain of field multiplies; the
// card is otherwise idle.
#include "g2.cuh"

namespace kzg {

constexpr int kG1LadderThreads = 256;  // Mode A lanes a block: 110,592 B of shared memory
constexpr int kG2LadderThreads = 64;   // 55,296 B
constexpr int kDigitWords = 9;         // a NAF of a 256-bit scalar has up to 257 digits
constexpr int kGenPieceBits = 4;       // Mode B: bits a piece
constexpr int kGenPieces = 256 / kGenPieceBits;  // pieces (threads) a lane
constexpr int kGenThreads = 64;        // Mode B threads a block
static_assert(32 % kGenPieceBits == 0 && kGenThreads % kGenPieces == 0,
              "a piece lies in one scalar word and a block holds whole lanes");

template <class Ops, int kThreads>
struct LadderSmem {
  using El = typename Ops::elem;
  jac_of<El> acc[kThreads];  // each thread's accumulator (Mode B: then the tree)
  jac_of<El> sum[kThreads];  // each thread's madd
  El px[kThreads], py[kThreads];
};

template <class Ops, int kThreads>
struct NafSmem : LadderSmem<Ops, kThreads> {
  typename Ops::elem ny[kThreads];  // -py
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

// acc at the block's top digit: the madd onto infinity gives (x, y, ONE)
// where the lane's digit there is set, and acc stays infinity elsewhere
template <class Ops, class P, class El>
__device__ __forceinline__ P ladder_start(bool set, const El& x, const El& y) {
  P r;
  r.x = Ops::sel(set, x, Ops::zero());
  r.y = Ops::sel(set, y, Ops::zero());
  r.z = Ops::sel(set, Ops::one(), Ops::zero());
  return r;
}

// The block's highest of its threads' top bits (-1 if none), in top.
__device__ __forceinline__ int block_top(int high, int& top) {
  if (threadIdx.x == 0) top = -1;
  __syncthreads();
  if (high >= 0) atomicMax(&top, high);
  __syncthreads();
  return top;
}

// Mode A. plus, minus: the digit masks, word w of lane i at
// [w * n + i * lane_stride] with lane_stride 1 (a scalar a lane), or at [w]
// for every lane with lane_stride 0 (one scalar).
template <class Ops, int kThreads>
__device__ __forceinline__ void naf_ladder(const u32* px, const u32* py, const u32* plus,
                                           const u32* minus, int lane_stride,
                                           const unsigned char* inf_mask, u32* ox, u32* oy,
                                           u32* oz, int n, unsigned char* smem, int& top) {
  using P = jac_of<typename Ops::elem>;
  NafSmem<Ops, kThreads>& s = *reinterpret_cast<NafSmem<Ops, kThreads>*>(smem);
  const int t = threadIdx.x;
  const long long i = (long long)blockIdx.x * kThreads + t;
  const bool live = i < n && (inf_mask == nullptr || !inf_mask[i]);
  if (i < n) {
    load_elem(s.px[t], px, n, i);
    load_elem(s.py[t], py, n, i);
  } else {
    s.px[t] = Ops::zero();
    s.py[t] = Ops::zero();
  }
  s.ny[t] = Ops::sub(Ops::zero(), s.py[t]);
  const long long stride = lane_stride ? n : 1;  // between a lane's digit words
  const u32* pl = plus + (live ? i * lane_stride : 0);
  const u32* mi = minus + (live ? i * lane_stride : 0);
  auto word = [&](const u32* m, int w) { return live ? __ldg(m + w * stride) : 0u; };
  int high = -1;  // this lane's highest non-zero digit
#pragma unroll
  for (int w = 0; w < kDigitWords; w++) {
    const u32 d = word(pl, w) | word(mi, w);
    if (d) high = 32 * w + 31 - __clz(d);
  }
  const int first = block_top(high, top);
  if (first >= 0) {
    const u32 bit = 1u << (first & 31);
    const bool neg = (word(mi, first >> 5) & bit) != 0;
    s.acc[t] = ladder_start<Ops, P>(((word(pl, first >> 5) & bit) != 0) || neg, s.px[t],
                                    neg ? s.ny[t] : s.py[t]);
  } else {
    s.acc[t] = pt_inf<Ops, P>();
  }
#pragma unroll 1
  for (int b = first - 1; b >= 0; b--)
    naf_step<Ops>(s.acc[t], s.sum[t], s.px[t], s.py[t], s.ny[t], word(pl, b >> 5),
                  word(mi, b >> 5), b);
  if (i < n) {
    store_elem(ox, n, i, s.acc[t].x);
    store_elem(oy, n, i, s.acc[t].y);
    store_elem(oz, n, i, s.acc[t].z);
  }
}

// Mode B. bx, by: the affine bases [2^(kGenPieceBits j)] G, j < kGenPieces,
// in the layout of a coordinate of kGenPieces lanes; k: (8, n) standard-form
// scalar words.
template <class Ops, int kThreads>
__device__ __forceinline__ void gen_ladder(const u32* bx, const u32* by, const u32* k, u32* ox,
                                           u32* oy, u32* oz, int n, unsigned char* smem,
                                           int& top) {
  using P = jac_of<typename Ops::elem>;
  LadderSmem<Ops, kThreads>& s = *reinterpret_cast<LadderSmem<Ops, kThreads>*>(smem);
  const int t = threadIdx.x;
  const int j = t % kGenPieces;
  const long long i = (long long)blockIdx.x * (kThreads / kGenPieces) + t / kGenPieces;
  const bool live = i < n;
  load_elem(s.px[t], bx, kGenPieces, j);
  load_elem(s.py[t], by, kGenPieces, j);
  const int lo = kGenPieceBits * j;
  const u32 mask = kGenPieceBits == 32 ? ~0u : (1u << (kGenPieceBits % 32)) - 1u;
  const u32 piece = live ? (k[(long long)(lo >> 5) * n + i] >> (lo & 31)) & mask : 0u;
  const int first = block_top(piece ? 31 - __clz(piece) : -1, top);
  s.acc[t] = ladder_start<Ops, P>(first >= 0 && ((piece >> first) & 1u), s.px[t], s.py[t]);
#pragma unroll 1
  for (int b = first - 1; b >= 0; b--)
    ladder_step<Ops, true>(s.acc[t], s.sum[t], s.px[t], s.py[t], piece, b);
  __syncthreads();
#pragma unroll 1
  for (int h = 1; h < kGenPieces; h *= 2) {
    if (j % (2 * h) == 0) s.acc[t] = jac_add<Ops>(s.acc[t], s.acc[t + h]);
    __syncthreads();
  }
  if (j == 0 && live) {
    store_elem(ox, n, i, s.acc[t].x);
    store_elem(oy, n, i, s.acc[t].y);
    store_elem(oz, n, i, s.acc[t].z);
  }
}

__global__ void __launch_bounds__(kG1LadderThreads) g1_ladder_kernel(
    const u32* px, const u32* py, const u32* plus, const u32* minus, int lane_stride,
    const unsigned char* inf_mask, u32* ox, u32* oy, u32* oz, int n) {
  extern __shared__ __align__(16) unsigned char g1_ladder_smem[];
  __shared__ int top;
  naf_ladder<FieldCalled, kG1LadderThreads>(px, py, plus, minus, lane_stride, inf_mask, ox, oy,
                                            oz, n, g1_ladder_smem, top);
}

__global__ void __launch_bounds__(kG2LadderThreads) g2_ladder_kernel(
    const u32* px, const u32* py, const u32* plus, const u32* minus, int lane_stride,
    const unsigned char* inf_mask, u32* ox, u32* oy, u32* oz, int n) {
  extern __shared__ __align__(16) unsigned char g2_ladder_smem[];
  __shared__ int top;
  naf_ladder<Fp2Ops<FieldCalled>, kG2LadderThreads>(px, py, plus, minus, lane_stride, inf_mask,
                                                    ox, oy, oz, n, g2_ladder_smem, top);
}

__global__ void __launch_bounds__(kGenThreads) g1_gen_ladder_kernel(
    const u32* bx, const u32* by, const u32* k, u32* ox, u32* oy, u32* oz, int n) {
  extern __shared__ __align__(16) unsigned char g1_gen_smem[];
  __shared__ int top;
  gen_ladder<FieldCalled, kGenThreads>(bx, by, k, ox, oy, oz, n, g1_gen_smem, top);
}

__global__ void __launch_bounds__(kGenThreads) g2_gen_ladder_kernel(
    const u32* bx, const u32* by, const u32* k, u32* ox, u32* oy, u32* oz, int n) {
  extern __shared__ __align__(16) unsigned char g2_gen_smem[];
  __shared__ int top;
  gen_ladder<Fp2Ops<FieldCalled>, kGenThreads>(bx, by, k, ox, oy, oz, n, g2_gen_smem, top);
}

// Sets the kernel's dynamic shared memory; returns the CUDA error code.
template <class Kernel>
int smem_attr(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The launchers are static: a function-local static of a template with
// external linkage is one object in the whole process (GNU unique), so a
// second library built from this source (scripts/mul_ladder_probe.py's
// variants) would find the attribute set and launch its own kernel without
// it.
template <class Ops, int kThreads, class Kernel>
static int launch_naf(Kernel kernel, const void* px, const void* py, const void* plus,
               const void* minus, int lane_stride, const void* inf_mask, void* ox, void* oy,
               void* oz, int n, void* stream) {
  if (n <= 0) return 0;
  constexpr int smem = (int)sizeof(NafSmem<Ops, kThreads>);
  static const int attr = smem_attr(kernel, smem);
  if (attr) return attr;
  kernel<<<(n + kThreads - 1) / kThreads, kThreads, smem, (cudaStream_t)stream>>>(
      (const u32*)px, (const u32*)py, (const u32*)plus, (const u32*)minus, lane_stride,
      (const unsigned char*)inf_mask, (u32*)ox, (u32*)oy, (u32*)oz, n);
  return (int)cudaGetLastError();
}

// pieces: the bases' lane count, which the caller chose; a count other
// than kGenPieces is refused (cudaErrorInvalidValue), so that the width
// is set here alone.
template <class Ops, class Kernel>
static int launch_gen(Kernel kernel, const void* bx, const void* by, int pieces, const void* k,
                      void* ox, void* oy, void* oz, int n, void* stream) {
  if (pieces != kGenPieces) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  constexpr int smem = (int)sizeof(LadderSmem<Ops, kGenThreads>);
  constexpr int lanes = kGenThreads / kGenPieces;
  static const int attr = smem_attr(kernel, smem);
  if (attr) return attr;
  kernel<<<(n + lanes - 1) / lanes, kGenThreads, smem, (cudaStream_t)stream>>>(
      (const u32*)bx, (const u32*)by, (const u32*)k, (u32*)ox, (u32*)oy, (u32*)oz, n);
  return (int)cudaGetLastError();
}

}  // namespace kzg

// Mode A. px, py: the affine base, (12, n) (G1) or (12, 2, n) (G2)
// Montgomery words; plus, minus: (kDigitWords, n) NAF masks (lane_stride 1)
// or (kDigitWords,) for every lane (lane_stride 0); inf_mask: (n,) bytes, or
// null (a flagged lane's product is infinity); ox, oy, oz: the Jacobian
// output, in px's layout.
extern "C" int kzg_g1_ladder(const void* px, const void* py, const void* plus, const void* minus,
                             int lane_stride, const void* inf_mask, void* ox, void* oy, void* oz,
                             int n, void* stream) {
  using namespace kzg;
  return launch_naf<FieldCalled, kG1LadderThreads>(g1_ladder_kernel, px, py, plus, minus,
                                                   lane_stride, inf_mask, ox, oy, oz, n, stream);
}

extern "C" int kzg_g2_ladder(const void* px, const void* py, const void* plus, const void* minus,
                             int lane_stride, const void* inf_mask, void* ox, void* oy, void* oz,
                             int n, void* stream) {
  using namespace kzg;
  return launch_naf<Fp2Ops<FieldCalled>, kG2LadderThreads>(g2_ladder_kernel, px, py, plus,
                                                           minus, lane_stride, inf_mask, ox, oy,
                                                           oz, n, stream);
}

// Mode B. bx, by: (12, pieces) (G1) or (12, 2, pieces) (G2) affine
// Montgomery words of [2^(kGenPieceBits j)] G, pieces == kGenPieces; k:
// (8, n) standard-form scalar words; ox, oy, oz: (12, n) or (12, 2, n)
// Jacobian output.
extern "C" int kzg_g1_gen_ladder(const void* bx, const void* by, int pieces, const void* k,
                                 void* ox, void* oy, void* oz, int n, void* stream) {
  using namespace kzg;
  return launch_gen<FieldCalled>(g1_gen_ladder_kernel, bx, by, pieces, k, ox, oy, oz, n, stream);
}

extern "C" int kzg_g2_gen_ladder(const void* bx, const void* by, int pieces, const void* k,
                                 void* ox, void* oy, void* oz, int n, void* stream) {
  using namespace kzg;
  return launch_gen<Fp2Ops<FieldCalled>>(g2_gen_ladder_kernel, bx, by, pieces, k, ox, oy, oz, n,
                                         stream);
}
