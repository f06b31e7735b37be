// K1e and K1d: the opening proof's two scans over Fr, the evaluation P(x)
// and the synthetic division of P by (X - root), each in a fixed number of
// launches whatever the coefficient count n (two and three).
//
// Replace kzg_tpu/ops/poly.py evaluate (:56: powers by an associative scan,
// one batched multiply, a tree sum) and synthetic_divide (:69: an
// associative scan of affine maps), XLA around mont_mul_pallas (K1). Every
// value is canonical, so any grouping of the sums and products gives the
// words of the plain versions (ops/poly.py) and of the JAX package.
//
// Operands are (8, n) limb-major Montgomery words: word j of lane i at
// j * stride + i. A point (x, root) is 8 words.
//
// K1e, fr_eval_kernel: block b owns the tile of T = kPolyBlock * run lanes
// from b T. Thread t runs Horner in X = x^kPolyBlock over the lanes
// b T + t + k kPolyBlock (a warp's loads of one word are 128 contiguous
// bytes), then the block folds its threads' values in a tree, lo + x^w hi,
// to the tile's value S_b = sum_e a_(b T + e) x^e. P(x) = sum_b S_b y^b with
// y = x^T, so a second launch of the same kernel, one block, evaluates the
// tile values at y. Each block squares x up to x^kPolyBlock itself (7
// squares by one thread), and block 0 of the first launch writes y = X^run
// for the second: the powers are worked out on the card.
//
// K1d: the quotient q_i = c_i + root q_(i+1), c_i = p_(i+1), q_(n-1) = 0,
// ascending, is a suffix scan of maps with the one multiplier root, so a run
// of R maps composes to (root^R, the run's total). Reduce, then scan:
//   1. fr_eval_kernel over c at root, run kPolyRun: each tile's total
//      (zero carry-in), and y = root^T.
//   2. fr_div_top_kernel, one block: the exclusive suffix scan of the tile
//      totals with multiplier y (thread runs, a Hillis-Steele scan of the run
//      totals, the runs again): carry[b] = q at the first position of tile
//      b + 1.
//   3. fr_div_down_kernel: each tile staged in shared memory (coalesced),
//      thread t's contiguous run t R .. t R + R - 1: its total, the
//      Hillis-Steele suffix scan of the run totals with root^R and the
//      tile's carry, then the run again from its carry, writing q; the tile
//      goes out coalesced. Block 0 also writes the rebuilt constant
//      -root q_0.
// The kernels index c = p[1:] and write q ascending themselves: no flip, no
// copy of the operand.
//
// Bound on an H100: K1e needs n Fr multiplies (272 IMADs each) over 32 n
// bytes read, about 8.5 IMADs a byte, above the card's ~5: operations.
// K1d needs n - 2 multiplies over 32 n bytes read and 32 (n - 1) written,
// about 4.2 a byte: bytes. Both are chains of dependent multiplies a thread
// (R = 8 in a run, then log2(kPolyBlock) scan levels); the design keeps the
// chains short and the loads coalesced, and does about 1.1 n (K1e) and
// 4 n (K1d: the tile totals, then two passes over each run and the block
// scan's 7 levels a run) multiplies.
#include "field.cuh"

namespace kzg {

typedef Elem<8> fr_t;

constexpr int kLogPolyBlock = 7;
constexpr int kPolyBlock = 1 << kLogPolyBlock;  // threads a block (POLY_BLOCK in ops/poly.py)
constexpr int kLogPolyRun = 3;
constexpr int kPolyRun = 1 << kLogPolyRun;  // K1d's lanes a thread (POLY_RUN)
constexpr int kPolyTile = kPolyBlock * kPolyRun;

// x^e for e >= 0, square-and-multiply from the top set bit.
__device__ __noinline__ fr_t fr_pow(fr_t x, unsigned e) {
  if (e == 0) return one<8>();
  fr_t acc = x;
#pragma unroll 1
  for (int b = 30 - __clz(e); b >= 0; b--) {
    acc = mont_mul<8>(acc, acc);
    if ((e >> b) & 1u) acc = mont_mul<8>(acc, x);
  }
  return acc;
}

// Lanes of the strided run that starts at base: base + k kPolyBlock < n.
__device__ __forceinline__ int strided_count(long long base, int run, long long n) {
  if (base >= n) return 0;
  return (int)min((long long)run, (n - 1 - base) / kPolyBlock + 1);
}

// node[t] holds run t's total s_t, mp[j] = M^(2^j) with M the multiplier
// from one run to the next. Returns the carry into run t's top,
// sum_(t' > t) s_t' M^(t' - t - 1) + M^(kPolyBlock - 1 - t) cin: cin is what
// is carried into the last run. Hillis-Steele: after step j node[t] holds
// the suffix sum over the 2^(j + 1) runs from t. Every thread calls it.
__device__ __forceinline__ fr_t suffix_carry(fr_t* node, const fr_t* mp, int t, const fr_t& cin) {
  __syncthreads();
  if (t == kPolyBlock - 1) node[t] = add<8>(node[t], mont_mul<8>(mp[0], cin));
#pragma unroll 1
  for (int j = 0; j < kLogPolyBlock; j++) {
    __syncthreads();
    fr_t v = node[t];
    if (t + (1 << j) < kPolyBlock) v = add<8>(v, mont_mul<8>(mp[j], node[t + (1 << j)]));
    __syncthreads();
    node[t] = v;
  }
  __syncthreads();
  return t + 1 < kPolyBlock ? node[t + 1] : cin;
}

// vals[b] = sum_e a[b T + e] x^e over block b's T = kPolyBlock * run lanes
// (lanes >= n read as zero); with next set, block 0 writes x^T.
__global__ void __launch_bounds__(kPolyBlock) fr_eval_kernel(const u32* a, int stride, int n,
                                                             int run, const u32* x, u32* vals,
                                                             int g, u32* next) {
  __shared__ fr_t xp[kLogPolyBlock + 1];  // x^(2^l)
  __shared__ fr_t node[kPolyBlock];
  const int t = threadIdx.x;
  if (t == 0) {
    fr_t p = load<8>(x, 1, 0);
    xp[0] = p;
#pragma unroll 1
    for (int l = 1; l <= kLogPolyBlock; l++) {
      p = mont_mul<8>(p, p);
      xp[l] = p;
    }
    if (next != nullptr && blockIdx.x == 0) store<8>(next, 1, 0, fr_pow(p, (unsigned)run));
  }
  __syncthreads();
  const fr_t X = xp[kLogPolyBlock];
  const long long base = (long long)blockIdx.x * kPolyBlock * run + t;
  const int cnt = strided_count(base, run, n);
  fr_t acc = zero<8>();
  if (cnt > 0) acc = load<8>(a, stride, base + (long long)(cnt - 1) * kPolyBlock);
#pragma unroll 1
  for (int k = cnt - 2; k >= 0; k--)
    acc = add<8>(load<8>(a, stride, base + (long long)k * kPolyBlock), mont_mul<8>(acc, X));
  node[t] = acc;
#pragma unroll 1
  for (int l = 0; l < kLogPolyBlock; l++) {
    __syncthreads();
    const int w = 1 << l;
    if ((t & (2 * w - 1)) == 0) node[t] = add<8>(node[t], mont_mul<8>(xp[l], node[t + w]));
  }
  if (t == 0) store<8>(vals, g, blockIdx.x, node[0]);
}

// One block: tot (8, g) the tiles' totals, y = root^T. carry[b] = q at the
// first position of tile b + 1 (0 after the last tile). Thread t takes the
// tiles t rho .. t rho + rho - 1, rho = ceil(g / kPolyBlock).
__global__ void __launch_bounds__(kPolyBlock) fr_div_top_kernel(const u32* tot, int g,
                                                                const u32* y_in, u32* carry) {
  __shared__ fr_t mp[kLogPolyBlock];  // (y^rho)^(2^j)
  __shared__ fr_t node[kPolyBlock];
  const int t = threadIdx.x;
  const int rho = (g + kPolyBlock - 1) / kPolyBlock;
  const fr_t y = load<8>(y_in, 1, 0);
  if (t == 0) {
    fr_t m = fr_pow(y, (unsigned)rho);
#pragma unroll 1
    for (int j = 0; j < kLogPolyBlock; j++) {
      mp[j] = m;
      m = mont_mul<8>(m, m);
    }
  }
  const long long base = (long long)t * rho;
  const int cnt = (int)max(0LL, min((long long)rho, g - base));
  fr_t acc = zero<8>();
#pragma unroll 1
  for (int k = cnt - 1; k >= 0; k--) acc = add<8>(load<8>(tot, g, base + k), mont_mul<8>(y, acc));
  node[t] = acc;
  fr_t c = suffix_carry(node, mp, t, zero<8>());
#pragma unroll 1
  for (int k = cnt - 1; k >= 0; k--) {
    store<8>(carry, g, base + k, c);
    c = add<8>(load<8>(tot, g, base + k), mont_mul<8>(y, c));
  }
}

// Tile b of c (c_i = coeffs[i + 1], i < d = n - 1): q_i for its positions,
// given carry[b] = q at the tile's end. Block 0 also writes -root q_0.
__global__ void __launch_bounds__(kPolyBlock) fr_div_down_kernel(const u32* coeffs, int n,
                                                                 const u32* root_in,
                                                                 const u32* carry, int g, u32* q,
                                                                 u32* rebuilt) {
  // run t at t (R + 1): a warp's runs start in distinct banks
  __shared__ u32 tile[8][kPolyBlock * (kPolyRun + 1)];
  __shared__ fr_t rp[kLogPolyRun + kLogPolyBlock];  // root^(2^l)
  __shared__ fr_t node[kPolyBlock];
  const int t = threadIdx.x;
  const long long d = n - 1;
  const long long first = (long long)blockIdx.x * kPolyTile;
  const fr_t r = load<8>(root_in, 1, 0);
  if (t == 0) {
    fr_t p = r;
#pragma unroll 1
    for (int l = 0; l < kLogPolyRun + kLogPolyBlock; l++) {
      rp[l] = p;
      p = mont_mul<8>(p, p);
    }
  }
#pragma unroll 1
  for (int e = t; e < kPolyTile; e += kPolyBlock) {
    const long long i = first + e;
    const int s = e / kPolyRun * (kPolyRun + 1) + e % kPolyRun;
#pragma unroll
    for (int j = 0; j < 8; j++) tile[j][s] = i < d ? coeffs[j * (long long)n + i + 1] : 0u;
  }
  __syncthreads();
  const int s0 = t * (kPolyRun + 1);
  fr_t v;
#pragma unroll
  for (int j = 0; j < 8; j++) v.w[j] = tile[j][s0 + kPolyRun - 1];
#pragma unroll 1
  for (int k = kPolyRun - 2; k >= 0; k--) {
    fr_t ck;
#pragma unroll
    for (int j = 0; j < 8; j++) ck.w[j] = tile[j][s0 + k];
    v = add<8>(ck, mont_mul<8>(r, v));
  }
  node[t] = v;
  fr_t c = suffix_carry(node, rp + kLogPolyRun, t, load<8>(carry, g, blockIdx.x));
#pragma unroll 1
  for (int k = kPolyRun - 1; k >= 0; k--) {
    fr_t ck;
#pragma unroll
    for (int j = 0; j < 8; j++) ck.w[j] = tile[j][s0 + k];
    c = add<8>(ck, mont_mul<8>(r, c));
#pragma unroll
    for (int j = 0; j < 8; j++) tile[j][s0 + k] = c.w[j];
  }
  if (blockIdx.x == 0 && t == 0) store<8>(rebuilt, 1, 0, sub<8>(zero<8>(), mont_mul<8>(r, c)));
  __syncthreads();
#pragma unroll 1
  for (int e = t; e < kPolyTile; e += kPolyBlock) {
    const long long i = first + e;
    if (i >= d) break;
    const int s = e / kPolyRun * (kPolyRun + 1) + e % kPolyRun;
#pragma unroll
    for (int j = 0; j < 8; j++) q[j * d + i] = tile[j][s];
  }
}

}  // namespace kzg

// vals (8, g) = the values of the tiles of kPolyBlock * run lanes of a
// (8 rows of stride words, n lanes) at x; with next not null, next = x^T.
// g = ceil(n / (kPolyBlock run)).
extern "C" int kzg_fr_eval(const void* a, int stride, int n, int run, const void* x, void* vals,
                           int g, void* next, void* stream) {
  using namespace kzg;
  if (n <= 0 || run <= 0 || g <= 0) return 0;
  fr_eval_kernel<<<g, kPolyBlock, 0, (cudaStream_t)stream>>>(
      (const u32*)a, stride, n, run, (const u32*)x, (u32*)vals, g, (u32*)next);
  return (int)cudaGetLastError();
}

// carry (8, g) from the tile totals tot (8, g) and y = root^T.
extern "C" int kzg_fr_div_top(const void* tot, int g, const void* y, void* carry, void* stream) {
  using namespace kzg;
  if (g <= 0) return 0;
  fr_div_top_kernel<<<1, kPolyBlock, 0, (cudaStream_t)stream>>>((const u32*)tot, g,
                                                                (const u32*)y, (u32*)carry);
  return (int)cudaGetLastError();
}

// q (8, n - 1), the quotient of coeffs (8, n) by (X - root), and rebuilt
// (8) = -root q_0, given the tiles' carries (8, g), g = ceil((n - 1) / T).
extern "C" int kzg_fr_div_down(const void* coeffs, int n, const void* root, const void* carry,
                               int g, void* q, void* rebuilt, void* stream) {
  using namespace kzg;
  if (n < 2 || g <= 0) return 0;
  fr_div_down_kernel<<<g, kPolyBlock, 0, (cudaStream_t)stream>>>(
      (const u32*)coeffs, n, (const u32*)root, (const u32*)carry, g, (u32*)q, (u32*)rebuilt);
  return (int)cudaGetLastError();
}
