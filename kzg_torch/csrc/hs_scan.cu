// K4: inclusive prefix (or suffix) sums of Jacobian points along the last
// axis of (12, R, W) coordinate arrays, for any W, with K2's exact add.
//
// Replaces kzg_tpu/ops/pallas_msm.py hs_scan_points, which keeps the whole
// row in VMEM and is capped at W <= 4096 on the TPU (msm.py:325). Here:
//   pass 1 (hs_block): each 256-lane block runs Hillis-Steele in shared
//     memory, lane t adding lane t - 2^k at level k, exactly the JAX
//     package's order (state = add(state, partner)); the block's last valid
//     lane is its total.
//   pass 2: the caller scans the block totals (exclusive) with this same
//     function, then hs_offset adds each block's offset to its lanes
//     (state = add(state, offset)).
// For W <= 256 there is one block and no pass 2, so the output equals
// kzg_tpu's _hs_scan_points bit for bit; for wider rows the adds are grouped
// differently and the outputs are equal as group elements. A suffix scan
// (reverse = 1) is the prefix scan in reversed lane order. The exclusive
// shift is data movement and stays in the wrapper.
//
// Bound on an H100: operations (a point add, ~8,940 IMADs, per lane and level against
// 6 * 48 bytes moved per lane). Shared memory holds one block of points
// (256 * 144 bytes = 36 KB); each level is two barriers and one add.
#include "g1.cuh"

namespace kzg {

constexpr int kHsBlock = 256;

__global__ void __launch_bounds__(kHsBlock) hs_block_kernel(const u32* x, const u32* y,
                                                            const u32* z, u32* ox, u32* oy,
                                                            u32* oz, u32* tx, u32* ty, u32* tz,
                                                            int R, int W, int reverse) {
  __shared__ jac_t s[kHsBlock];
  const int b = blockIdx.x;
  const int r = blockIdx.y;
  const int t = threadIdx.x;
  const int nb = gridDim.x;
  const long long g = (long long)b * kHsBlock + t;
  const int nvalid = (int)min((long long)kHsBlock, (long long)W - (long long)b * kHsBlock);
  const long long stride = (long long)R * W;
  const long long phys = (long long)r * W + (reverse ? (W - 1 - g) : g);
  const bool valid = t < nvalid;
  jac_t mine = jac_inf();
  if (valid) mine = load_jac(x, y, z, stride, phys);
  s[t] = mine;
  for (int shift = 1; shift < nvalid; shift <<= 1) {
    __syncthreads();
    const bool active = valid && t >= shift;
    jac_t partner;
    if (active) partner = s[t - shift];
    __syncthreads();
    if (active) {
      mine = g1_add(mine, partner);
      s[t] = mine;
    }
  }
  if (valid) store_jac(ox, oy, oz, stride, phys, mine);
  if (t == nvalid - 1) store_jac(tx, ty, tz, (long long)R * nb, (long long)r * nb + b, mine);
}

__global__ void __launch_bounds__(128) hs_offset_kernel(u32* ox, u32* oy, u32* oz,
                                                        const u32* offx, const u32* offy,
                                                        const u32* offz, int R, int W, int nb,
                                                        int reverse) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (g >= W) return;
  const long long stride = (long long)R * W;
  const long long phys = (long long)r * W + (reverse ? (W - 1 - g) : g);
  const jac_t off = load_jac(offx, offy, offz, (long long)R * nb, (long long)r * nb + g / kHsBlock);
  const jac_t v = load_jac(ox, oy, oz, stride, phys);
  store_jac(ox, oy, oz, stride, phys, g1_add(v, off));
}

}  // namespace kzg

// Block scan: writes the per-block inclusive scans to (ox, oy, oz) and the
// block totals to (tx, ty, tz), shape (12, R, ceil(W / 256)).
extern "C" int kzg_hs_scan_block(const void* x, const void* y, const void* z, void* ox, void* oy,
                                 void* oz, void* tx, void* ty, void* tz, int R, int W,
                                 int reverse, void* stream) {
  using namespace kzg;
  if (R <= 0 || W <= 0) return 0;
  const dim3 grid((W + kHsBlock - 1) / kHsBlock, R);
  hs_block_kernel<<<grid, kHsBlock, 0, (cudaStream_t)stream>>>(
      (const u32*)x, (const u32*)y, (const u32*)z, (u32*)ox, (u32*)oy, (u32*)oz, (u32*)tx,
      (u32*)ty, (u32*)tz, R, W, reverse);
  return (int)cudaGetLastError();
}

// In place: out[r, lane] = add(out[r, lane], off[r, lane / 256]).
extern "C" int kzg_hs_scan_offset(void* ox, void* oy, void* oz, const void* offx,
                                  const void* offy, const void* offz, int R, int W, int reverse,
                                  void* stream) {
  using namespace kzg;
  if (R <= 0 || W <= 0) return 0;
  const int nb = (W + kHsBlock - 1) / kHsBlock;
  const dim3 grid((W + 127) / 128, R);
  hs_offset_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (u32*)ox, (u32*)oy, (u32*)oz, (const u32*)offx, (const u32*)offy, (const u32*)offz, R, W,
      nb, reverse);
  return (int)cudaGetLastError();
}
