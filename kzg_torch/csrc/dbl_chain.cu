// K7: repeated doubling, one thread per lane, in two shapes:
//   - the chain: 2^first P (windows = 1), K7's own interface;
//   - the windows: 2^(first + steps k) P for k < windows, each written to
//     window k's columns (k n + i) of one (12, windows n) Jacobian output.
//     The fixed-base table build runs it once (first 0, 16 steps, 16
//     windows): 240 doublings of 2^20 lanes in one launch, in place of 240
//     g1_double launches that each read and wrote the whole batch (~72 GB
//     in all) and a stack of the 16 windows.
//
// Replaces kzg_tpu/ops/pallas_msm.py double_chain, which runs one doubling
// per grid step with the point held in VMEM scratch. Here a thread loads its
// point once, runs g1.cuh's jac_double (dbl-2009-l, 2M + 5S) in
// registers and writes each window once; any lane count works. With z ==
// nullptr the input is affine and z is the Montgomery one.
//
// Bound on an H100: operations. A lane does 2 Fp multiplies and 5 squares
// (~3,540 32-bit multiply-adds) a doubling and moves 96 or 144 bytes in and 144 bytes a
// window out. The compiler gives the doubling 128 registers a thread (4
// blocks of 128 an SM) without spills.
#include "g1.cuh"

namespace kzg {

constexpr int kChainThreads = 128;

__global__ void __launch_bounds__(kChainThreads) dbl_chain_kernel(const u32* x, const u32* y,
                                                                  const u32* z, u32* ox, u32* oy,
                                                                  u32* oz, int first, int steps,
                                                                  int windows, int n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  jac_t p;
  p.x = load<12>(x, n, i);
  p.y = load<12>(y, n, i);
  p.z = z == nullptr ? fp_one() : load<12>(z, n, i);
  const long long stride = (long long)windows * n;
  for (int s = 0; s < first; s++) p = jac_double(p);
  store_jac(ox, oy, oz, stride, i, p);
  for (int k = 1; k < windows; k++) {
    for (int s = 0; s < steps; s++) p = jac_double(p);
    store_jac(ox, oy, oz, stride, (long long)k * n + i, p);
  }
}

}  // namespace kzg

extern "C" int kzg_dbl_chain(const void* x, const void* y, const void* z, void* ox, void* oy,
                             void* oz, int first, int steps, int windows, int n, void* stream) {
  using namespace kzg;
  if (n <= 0 || windows <= 0) return 0;
  dbl_chain_kernel<<<(n + kChainThreads - 1) / kChainThreads, kChainThreads, 0,
                     (cudaStream_t)stream>>>((const u32*)x, (const u32*)y, (const u32*)z,
                                             (u32*)ox, (u32*)oy, (u32*)oz, first, steps, windows,
                                             n);
  return (int)cudaGetLastError();
}
