// K1: batched Montgomery multiply, a * b * R^-1 mod N, canonical in and out.
//
// Replaces kzg_tpu/ops/pallas_field.py mont_mul_pallas (its three TPU bodies,
// mont_mul_block / _stack / _stack_mxu, are one function). One thread per
// lane, CIOS over 32-bit words (field.cuh). Operands are (L, n) limb-major
// int32 arrays: word j of lane i at j * n + i, so a warp's loads of one word
// are 128 contiguous bytes.
//
// Bound on an H100: bytes. A lane moves 3 * 4L bytes (144 for Fp) and does
// 2 L^2 + L 32x32->64 multiply-adds (two 32-bit IMADs each): 600 IMADs, about
// 4.2 a byte for Fp (2.8 for Fr), below the card's ~5 IMADs a byte of HBM
// bandwidth (16.7 T IMAD/s over 3.35 TB/s). The design keeps every word in
// registers (no shared memory, no spills at L = 12) and launches enough
// 256-thread blocks to fill all SMs.
#include "field.cuh"

namespace kzg {

template <int L>
__global__ void __launch_bounds__(256) mont_mul_kernel(const u32* __restrict__ a,
                                                      const u32* __restrict__ b,
                                                      u32* __restrict__ out, int n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Elem<L> x = load<L>(a, n, i);
  const Elem<L> y = load<L>(b, n, i);
  store<L>(out, n, i, mont_mul<L>(x, y));
}

}  // namespace kzg

// field: 0 = Fp (12 words), 1 = Fr (8 words)
extern "C" int kzg_mont_mul(const void* a, const void* b, void* out, int n, int field,
                            void* stream) {
  using namespace kzg;
  if (n <= 0) return 0;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0) {
    mont_mul_kernel<12><<<blocks, threads, 0, s>>>((const u32*)a, (const u32*)b, (u32*)out, n);
  } else {
    mont_mul_kernel<8><<<blocks, threads, 0, s>>>((const u32*)a, (const u32*)b, (u32*)out, n);
  }
  return (int)cudaGetLastError();
}
