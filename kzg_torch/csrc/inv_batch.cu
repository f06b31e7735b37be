// K1's batched inversion: every lane's inverse in Montgomery form, zero
// lanes mapped to zero, in three launches whatever the lane count n.
//
// Replaces kzg_tpu/ops/field.py Field.inv_batch (XLA around K1: two
// associative product scans and one Fermat ladder, each step a batched
// mont_mul_pallas). The inverse is unique and canonical, so any grouping of
// the products gives the words of the plain version (Field.inv_batch_plain).
//
// Montgomery's trick, grouped for the card. Operands are (L, n) limb-major:
// word j of lane i at j * n + i. A block of kInvBlock threads owns
// kInvBlock * run lanes; thread t walks the lanes base + t + j * kInvBlock
// (a warp's loads of one word stay 128 contiguous bytes), zero lanes read
// as one (R mod N).
//   inv_up:   each thread's running products go to the output buffer (not
//             registers); a product tree over the block's run totals in
//             shared memory gives the block total.
//   inv_top:  one block: the same over the block totals, one Fermat ladder
//             (fermat_inv, field.cuh: x^(N-2) in fixed 4-bit windows)
//             on the root by one thread, then back down the tree and the
//             runs: the block totals' inverses, in place.
//   inv_down: each block rebuilds its tree from the run totals (the last
//             running product of each run), puts its total's inverse at the
//             root, walks the tree down to each run's inverse, and each
//             thread walks its run backwards: inv(a_i) = inv(p_i) p_(i-1),
//             inv(p_(i-1)) = inv(p_i) a_i.
// About three multiplies a lane (one up, two down) and one ladder (380
// squares and 105 multiplies for Fp, paid once, in the one-block launch).
//
// Bound on an H100: operations. A lane reads 4L bytes and writes 4L, and
// does 3 multiplies: 3 * 600 IMADs over 96 bytes for Fp, about 19 a byte,
// above the card's ~5 IMADs a byte of HBM bandwidth. The kernel moves more
// than that (the running products go out and come back: 5 * 4L bytes a
// lane), which keeps it near the bytes bound as well.
#include "field.cuh"

namespace kzg {

constexpr int kInvBlock = 256;

template <int L>
__device__ __forceinline__ Elem<L> nonzero_or_one(const Elem<L>& x) {
  const bool z = is_zero<L>(x);
  const Elem<L> o = one<L>();
  Elem<L> r;
#pragma unroll
  for (int j = 0; j < L; j++) r.w[j] = z ? o.w[j] : x.w[j];
  return r;
}

// Lanes of thread t whose first lane is base: base + j * kInvBlock for
// j < run, below n.
__device__ __forceinline__ int run_count(long long base, int run, long long n) {
  if (base >= n) return 0;
  return (int)min((long long)run, (n - 1 - base) / kInvBlock + 1);
}

// pre[lane j] = a_0 ... a_j over the thread's lanes (zero lanes as one);
// returns the run's product (one for an empty run).
template <int L>
__device__ __forceinline__ Elem<L> run_products(const u32* a, u32* pre, long long n,
                                               long long base, int cnt) {
  if (cnt == 0) return one<L>();
  Elem<L> acc = nonzero_or_one<L>(load<L>(a, n, base));
  store<L>(pre, n, base, acc);
#pragma unroll 1
  for (int j = 1; j < cnt; j++) {
    const long long i = base + (long long)j * kInvBlock;
    acc = mont_mul<L>(acc, nonzero_or_one<L>(load<L>(a, n, i)));
    store<L>(pre, n, i, acc);
  }
  return acc;
}

// Given inv = the inverse of the run's product, out[lane] = inv(a_lane) (0
// for a zero lane), last lane first. pre and out may be one buffer, and a and
// out too: lane j reads a_j and pre_(j-1) before out_j is written.
template <int L>
__device__ __forceinline__ void run_inverses(const u32* a, const u32* pre, u32* out, long long n,
                                             long long base, int cnt, Elem<L> inv) {
#pragma unroll 1
  for (int j = cnt - 1; j >= 0; j--) {
    const long long i = base + (long long)j * kInvBlock;
    const Elem<L> x = load<L>(a, n, i);
    const bool z = is_zero<L>(x);
    Elem<L> r = j > 0 ? mont_mul<L>(inv, load<L>(pre, n, i - kInvBlock)) : inv;
    if (j > 0) inv = mont_mul<L>(inv, nonzero_or_one<L>(x));
#pragma unroll
    for (int w = 0; w < L; w++) r.w[w] = z ? 0u : r.w[w];
    store<L>(out, n, i, r);
  }
}

// Product tree in shared memory: node k's children are 2k and 2k + 1, the
// leaves (one per thread) at kInvBlock + t, the root at 1.
template <int L>
__device__ __forceinline__ void tree_up(Elem<L>* node, int t) {
  for (int s = kInvBlock / 2; s >= 1; s >>= 1) {
    __syncthreads();
    if (t < s) node[s + t] = mont_mul<L>(node[2 * (s + t)], node[2 * (s + t) + 1]);
  }
  __syncthreads();
}

// With node[1] the root's inverse: each node's inverse from its parent's
// (inv(l) = inv(lr) r, inv(r) = inv(lr) l), down to the leaves.
template <int L>
__device__ __forceinline__ void tree_down(Elem<L>* node, int t) {
  for (int s = 1; s < kInvBlock; s <<= 1) {
    __syncthreads();
    if (t < s) {
      const int k = s + t;
      const Elem<L> x = node[k];
      const Elem<L> l = node[2 * k];
      const Elem<L> r = node[2 * k + 1];
      node[2 * k] = mont_mul<L>(x, r);
      node[2 * k + 1] = mont_mul<L>(x, l);
    }
  }
  __syncthreads();
}

template <int L>
__global__ void __launch_bounds__(kInvBlock) inv_up_kernel(const u32* a, u32* pre, u32* tot,
                                                          int n, int run, int g) {
  __shared__ Elem<L> node[2 * kInvBlock];
  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * kInvBlock * run + t;
  node[kInvBlock + t] = run_products<L>(a, pre, n, base, run_count(base, run, n));
  tree_up<L>(node, t);
  if (t == 0) store<L>(tot, g, blockIdx.x, node[1]);
}

// One block: tot (L, g) -> the inverses of its g values, in place; pre
// (L, g) is scratch for the running products.
template <int L>
__global__ void __launch_bounds__(kInvBlock) inv_top_kernel(u32* tot, u32* pre, int g) {
  __shared__ Elem<L> node[2 * kInvBlock];
  const int t = threadIdx.x;
  const int run = (g + kInvBlock - 1) / kInvBlock;
  const int cnt = run_count(t, run, g);
  node[kInvBlock + t] = run_products<L>(tot, pre, g, t, cnt);
  tree_up<L>(node, t);
  if (t == 0) node[1] = fermat_inv<L>(node[1]);
  tree_down<L>(node, t);
  run_inverses<L>(tot, pre, tot, g, t, cnt, node[kInvBlock + t]);
}

template <int L>
__global__ void __launch_bounds__(kInvBlock) inv_down_kernel(const u32* a, u32* out,
                                                            const u32* tot_inv, int n, int run,
                                                            int g) {
  __shared__ Elem<L> node[2 * kInvBlock];
  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * kInvBlock * run + t;
  const int cnt = run_count(base, run, n);
  // the run's product is its last running product, left in out by inv_up
  node[kInvBlock + t] =
      cnt > 0 ? load<L>(out, n, base + (long long)(cnt - 1) * kInvBlock) : one<L>();
  tree_up<L>(node, t);
  if (t == 0) node[1] = load<L>(tot_inv, g, blockIdx.x);
  tree_down<L>(node, t);
  run_inverses<L>(a, out, out, n, base, cnt, node[kInvBlock + t]);
}

inline int inv_blocks(int n, int run) {
  const long long lanes = (long long)kInvBlock * run;
  return (int)((n + lanes - 1) / lanes);
}

}  // namespace kzg

// field: 0 = Fp (12 words), 1 = Fr (8 words). a, out: (L, n); tot: (L, g)
// with g = ceil(n / (256 run)). Writes the running products to out and the
// block totals to tot.
extern "C" int kzg_inv_up(const void* a, void* out, void* tot, int n, int run, int field,
                          void* stream) {
  using namespace kzg;
  if (n <= 0 || run <= 0) return 0;
  const int g = inv_blocks(n, run);
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0) {
    inv_up_kernel<12><<<g, kInvBlock, 0, s>>>((const u32*)a, (u32*)out, (u32*)tot, n, run, g);
  } else {
    inv_up_kernel<8><<<g, kInvBlock, 0, s>>>((const u32*)a, (u32*)out, (u32*)tot, n, run, g);
  }
  return (int)cudaGetLastError();
}

// tot (L, g) -> its inverses in place; pre (L, g) scratch.
extern "C" int kzg_inv_top(void* tot, void* pre, int g, int field, void* stream) {
  using namespace kzg;
  if (g <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0) {
    inv_top_kernel<12><<<1, kInvBlock, 0, s>>>((u32*)tot, (u32*)pre, g);
  } else {
    inv_top_kernel<8><<<1, kInvBlock, 0, s>>>((u32*)tot, (u32*)pre, g);
  }
  return (int)cudaGetLastError();
}

// out (holding inv_up's running products) -> the lanes' inverses, given the
// block totals' inverses in tot.
extern "C" int kzg_inv_down(const void* a, void* out, const void* tot, int n, int run, int field,
                            void* stream) {
  using namespace kzg;
  if (n <= 0 || run <= 0) return 0;
  const int g = inv_blocks(n, run);
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0) {
    inv_down_kernel<12><<<g, kInvBlock, 0, s>>>((const u32*)a, (u32*)out, (const u32*)tot, n,
                                                run, g);
  } else {
    inv_down_kernel<8><<<g, kInvBlock, 0, s>>>((const u32*)a, (u32*)out, (const u32*)tot, n,
                                               run, g);
  }
  return (int)cudaGetLastError();
}
