// K2: batched G1 point formulas, one thread per lane.
//
// Replaces kzg_tpu/ops/pallas_curve.py _run_point_kernel (reached by madd,
// add and double). Each coordinate is a (12, n) limb-major int32 array; the
// formulas are the device functions of g1.cuh, which the scan kernels reuse.
//
// Bound on an H100: operations. A madd moves 8 * 48 bytes and needs 7 field
// multiplies and 4 squares (~6,070 IMADs), an add 9 * 48 bytes and 11 + 5
// (~8,940), a double 6 * 48 bytes and 2 + 5 (~3,540): 12 to 21 IMADs per
// byte, above the card's ~5 per byte. The running values stay in registers; the rare P == Q lane
// branches into the doubling instead of every lane computing it.
#include "g1.cuh"

namespace kzg {

__global__ void __launch_bounds__(128) g1_double_kernel(const u32* x, const u32* y, const u32* z,
                                                        u32* ox, u32* oy, u32* oz, int n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store_jac(ox, oy, oz, n, i, jac_double(load_jac(x, y, z, n, i)));
}

__global__ void __launch_bounds__(128) g1_add_kernel(const u32* x1, const u32* y1, const u32* z1,
                                                     const u32* x2, const u32* y2, const u32* z2,
                                                     u32* ox, u32* oy, u32* oz, int n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const jac_t p = load_jac(x1, y1, z1, n, i);
  const jac_t q = load_jac(x2, y2, z2, n, i);
  store_jac(ox, oy, oz, n, i, jac_add(p, q));
}

// need == nullptr: exact madd. Otherwise the 11-mul fast madd, with the
// per-lane needs-double mask written to need.
__global__ void __launch_bounds__(128) g1_madd_kernel(const u32* x1, const u32* y1, const u32* z1,
                                                      const u32* x2, const u32* y2,
                                                      u32* ox, u32* oy, u32* oz, int* need,
                                                      int n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const jac_t p = load_jac(x1, y1, z1, n, i);
  const fp_t qx = load<12>(x2, n, i);
  const fp_t qy = load<12>(y2, n, i);
  if (need == nullptr) {
    store_jac(ox, oy, oz, n, i, jac_madd(p, qx, qy));
  } else {
    bool nd;
    store_jac(ox, oy, oz, n, i, jac_madd_fast(p, qx, qy, nd));
    need[i] = nd ? 1 : 0;
  }
}

}  // namespace kzg

namespace {
constexpr int kThreads = 128;
inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }
}  // namespace

extern "C" int kzg_g1_double(const void* x, const void* y, const void* z, void* ox, void* oy,
                             void* oz, int n, void* stream) {
  using namespace kzg;
  if (n <= 0) return 0;
  g1_double_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const u32*)x, (const u32*)y, (const u32*)z, (u32*)ox, (u32*)oy, (u32*)oz, n);
  return (int)cudaGetLastError();
}

extern "C" int kzg_g1_add(const void* x1, const void* y1, const void* z1, const void* x2,
                          const void* y2, const void* z2, void* ox, void* oy, void* oz, int n,
                          void* stream) {
  using namespace kzg;
  if (n <= 0) return 0;
  g1_add_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const u32*)x1, (const u32*)y1, (const u32*)z1, (const u32*)x2, (const u32*)y2,
      (const u32*)z2, (u32*)ox, (u32*)oy, (u32*)oz, n);
  return (int)cudaGetLastError();
}

extern "C" int kzg_g1_madd(const void* x1, const void* y1, const void* z1, const void* x2,
                           const void* y2, void* ox, void* oy, void* oz, void* need, int n,
                           void* stream) {
  using namespace kzg;
  if (n <= 0) return 0;
  g1_madd_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const u32*)x1, (const u32*)y1, (const u32*)z1, (const u32*)x2, (const u32*)y2, (u32*)ox,
      (u32*)oy, (u32*)oz, (int*)need, n);
  return (int)cudaGetLastError();
}
