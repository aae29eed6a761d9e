// Fused RMSNorm for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm/kernel.py:
// rmsnorm (body _rms_kernel): y = x * rsqrt(mean(x^2) + eps) * scale,
// computed in f32, stored in x's dtype.
//
// Bound on this card: memory.  Each element is read once and written
// once (2*R*D*bytes + 4*D for the f32 scale) and the arithmetic is a few
// operations per element, far below the ~300 operations per byte at
// which the H100 stops being memory-bound.  At the decode shape (R = 8
// rows of D = 576) the whole call moves ~20 KB and is bounded by launch
// latency instead.
//
// Design: one warp per row, four rows per 128-thread block.  Each lane
// moves 16 bytes at a time (8 bf16, or 2 x 4 f32), neighbouring lanes on
// neighbouring addresses; D = 576 is 72 such chunks, so a row is three
// coalesced sweeps of the warp.  The sum of squares is kept in f32 and
// reduced with warp shuffles; no shared memory, no second kernel.  The
// second sweep re-reads the row, which the first sweep left in cache.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro_torch::load8;
using repro_torch::store8;

constexpr int kWarpsPerBlock = 4;

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ out, int rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together
  const T* xr = x + static_cast<size_t>(row) * d;
  T* yr = out + static_cast<size_t>(row) * d;
  const int chunks = d >> 3;

  float ss = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    float f[8];
    load8(xr + c * 8, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) ss = fmaf(f[i], f[i], ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

  for (int c = lane; c < chunks; c += 32) {
    float f[8], s[8];
    load8(xr + c * 8, f);
    load8(scale + c * 8, s);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = f[i] * r * s[i];
    store8(yr + c * 8, f);
  }
}

template <typename T>
int launch(const void* x, const void* scale, void* out, int rows, int d,
           float eps, cudaStream_t stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  rmsnorm_kernel<T><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<T*>(out), rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32.  d must be a multiple of 8 and every
// pointer 16-byte aligned (the Python wrapper checks both).  Returns the
// cudaError_t of the launch.
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* out,
                              int rows, int d, float eps, int dtype,
                              void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<__nv_bfloat16>(x, scale, out, rows, d, eps, s);
  if (dtype == 1) return launch<float>(x, scale, out, rows, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
