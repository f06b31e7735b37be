// K7: 2^steps P per lane, one thread per lane.
//
// Replaces kzg_tpu/ops/pallas_msm.py double_chain, which runs one doubling
// per grid step with the point held in VMEM scratch. Here a thread loads its
// point once, runs `steps` calls of g1.cuh's g1_double (dbl-2009-l, 7 Fp
// multiplies) in registers and writes once; any lane count works.
//
// Bound on an H100: operations. A lane does 7 * steps Fp multiplies
// (~4,200 32-bit multiply-adds a step) and moves 288 bytes.
#include "g1.cuh"

namespace kzg {

__global__ void __launch_bounds__(128) dbl_chain_kernel(const u32* x, const u32* y, const u32* z,
                                                        u32* ox, u32* oy, u32* oz, int steps,
                                                        int n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  jac_t p = load_jac(x, y, z, n, i);
  for (int s = 0; s < steps; s++) p = g1_double(p);
  store_jac(ox, oy, oz, n, i, p);
}

}  // namespace kzg

extern "C" int kzg_dbl_chain(const void* x, const void* y, const void* z, void* ox, void* oy,
                             void* oz, int steps, int n, void* stream) {
  using namespace kzg;
  if (n <= 0) return 0;
  constexpr int kThreads = 128;
  dbl_chain_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      (const u32*)x, (const u32*)y, (const u32*)z, (u32*)ox, (u32*)oy, (u32*)oz, steps, n);
  return (int)cudaGetLastError();
}
