// Fused RMSNorm for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm/kernel.py:
// rmsnorm (body _rms_kernel): y = x * rsqrt(mean(x^2) + eps) * scale,
// computed in f32, stored in x's dtype.  Any row width D.
//
// Bound on this card: memory.  Each element is read once and written
// once (2*R*D*bytes, plus the scale) and the arithmetic is a few
// operations per element, far below the ~300 operations per byte at
// which the H100 stops being memory-bound.  At jamba's prefill shape
// (R = 4096 rows of D = 4096, bf16) that is 67 MB, 0.020 ms at 3.35 TB/s.
// At the decode shapes (R = 8 rows) the whole call moves a few tens of KB
// and is bounded by the launch: there the cost is the host's, which the
// Python wrapper keeps to one ctypes call (kernels/rmsnorm/ops.py).
//
// Design: HBM is read once.  Each row is held in registers between the
// sum of squares and the scaling: the threads of a row hold up to 32
// values each (8 on the narrow path), and a row takes as many warps as that
// needs (one warp up to D = 1024 in bf16, four at D = 4096), its partial
// sums meeting in shared memory.  Blocks of at least 128 threads, so at
// 4096 rows of 4096 the grid is 4096 blocks of one row, ~2 waves of the
// 132 SMs.  A row longer than the registers hold (above 32K elements)
// streams its remainder and reads it again.  A chunk is 16 bytes (8 bf16
// or 4 f32) when D fills whole chunks and x, out and scale are 16-byte
// aligned (the launcher decides from the pointers and D); any other D,
// such as 60, takes the narrow path of one element per chunk.  The scale
// is read in f32 or in x's dtype, so the wrapper never casts it.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMinThreads = 128;   // threads per block, at least
constexpr int kMaxRowThreads = 1024;
constexpr int kHeld = 32;          // f32 values a thread holds of its row

// Chunks of VEC elements a thread holds in registers: 32 values on the
// 16-byte path, 8 on the narrow one (which is for small or odd rows).
template <int VEC>
__host__ __device__ constexpr int held_chunks() {
  return VEC == 1 ? 8 : kHeld / VEC;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float f, float* p) { *p = f; }
__device__ __forceinline__ void from_f(float f, bf16* p) {
  *p = __float2bfloat16_rn(f);
}

// N consecutive elements at p as f32: whole 16-byte words when N elements
// fill them (p then 16-byte aligned), else one element at a time.
template <int N, typename T>
__device__ __forceinline__ void load(const T* p, float (&f)[N]) {
  constexpr int kPer = 16 / sizeof(T);
  if constexpr (N * sizeof(T) % 16 == 0) {
#pragma unroll
    for (int w = 0; w < N / kPer; ++w) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[w];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < kPer; ++j) f[w * kPer + j] = to_f(e[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = to_f(p[j]);
  }
}

template <int N, typename T>
__device__ __forceinline__ void store(T* p, const float (&f)[N]) {
  constexpr int kPer = 16 / sizeof(T);
  if constexpr (N * sizeof(T) % 16 == 0) {
#pragma unroll
    for (int w = 0; w < N / kPer; ++w) {
      uint4 u;
      T* e = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int j = 0; j < kPer; ++j) from_f(f[w * kPer + j], e + j);
      reinterpret_cast<uint4*>(p)[w] = u;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) from_f(f[j], p + j);
  }
}

// Rows of d elements in chunks of VEC; tpr threads (a multiple of 32) per
// row, blockDim.x / tpr rows per block.  Chunk c of a row goes to thread
// c % tpr; the first NREG chunks of each thread stay in registers.
template <typename T, typename S, int VEC>
__global__ void __launch_bounds__(kMaxRowThreads)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ out, int rows, int d, float eps, int tpr) {
  constexpr int NREG = held_chunks<VEC>();
  __shared__ float part[kMaxRowThreads / 32];
  const int tid = threadIdx.x;
  const int lt = tid % tpr;                  // thread within the row
  const int row = blockIdx.x * (blockDim.x / tpr) + tid / tpr;
  const bool live = row < rows;
  const int nvec = d / VEC;
  const T* xr = x + static_cast<size_t>(live ? row : 0) * d;
  T* yr = out + static_cast<size_t>(live ? row : 0) * d;

  float f[NREG][VEC];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NREG; ++i) {
    const int c = lt + i * tpr;
    if (live && c < nvec) {
      load<VEC>(xr + c * VEC, f[i]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) ss = fmaf(f[i][j], f[i][j], ss);
    }
  }
  for (int c = lt + NREG * tpr; live && c < nvec; c += tpr) {
    float g[VEC];
    load<VEC>(xr + c * VEC, g);
#pragma unroll
    for (int j = 0; j < VEC; ++j) ss = fmaf(g[j], g[j], ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (tpr > 32) {          // the row's warps meet in shared memory
    if ((tid & 31) == 0) part[tid >> 5] = ss;
    __syncthreads();
    const int w0 = (tid - lt) >> 5;
    ss = 0.f;
    for (int w = 0; w < tpr / 32; ++w) ss += part[w0 + w];
  }
  if (!live) return;
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

#pragma unroll
  for (int i = 0; i < NREG; ++i) {
    const int c = lt + i * tpr;
    if (c < nvec) {
      float s[VEC];
      load<VEC>(scale + c * VEC, s);
#pragma unroll
      for (int j = 0; j < VEC; ++j) f[i][j] = f[i][j] * r * s[j];
      store<VEC>(yr + c * VEC, f[i]);
    }
  }
  for (int c = lt + NREG * tpr; c < nvec; c += tpr) {
    float g[VEC], s[VEC];
    load<VEC>(xr + c * VEC, g);
    load<VEC>(scale + c * VEC, s);
#pragma unroll
    for (int j = 0; j < VEC; ++j) g[j] = g[j] * r * s[j];
    store<VEC>(yr + c * VEC, g);
  }
}

template <typename T, typename S, int VEC>
int launch(const void* x, const void* scale, void* out, int rows, int d,
           float eps, cudaStream_t stream) {
  const int nvec = d / VEC;
  int tpr = 32;
  while (tpr < kMaxRowThreads && nvec > held_chunks<VEC>() * tpr) tpr *= 2;
  const int threads = tpr > kMinThreads ? tpr : kMinThreads;
  const int per_block = threads / tpr;
  const int blocks = (rows + per_block - 1) / per_block;
  rmsnorm_kernel<T, S, VEC><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(out), rows, d, eps, tpr);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The 16-byte path where D fills whole chunks and every pointer is
// aligned, else the narrow path.
template <typename T, typename S>
int pick(const void* x, const void* scale, void* out, int rows, int d,
         float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (d % kVec == 0 && aligned16(x) && aligned16(out) && aligned16(scale))
    return launch<T, S, kVec>(x, scale, out, rows, d, eps, stream);
  return launch<T, S, 1>(x, scale, out, rows, d, eps, stream);
}

}  // namespace

// x, out: (rows, d) contiguous; scale: (d,).  x_dtype: 0 = bfloat16,
// 1 = float32; scale_dtype: 1 = float32, or 0 = bfloat16 with bf16 x.
// Returns the cudaError_t of the launch.
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* out,
                              int rows, int d, float eps, int x_dtype,
                              int scale_dtype, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && scale_dtype == 1)
    return pick<bf16, float>(x, scale, out, rows, d, eps, s);
  if (x_dtype == 0 && scale_dtype == 0)
    return pick<bf16, bf16>(x, scale, out, rows, d, eps, s);
  if (x_dtype == 1 && scale_dtype == 1)
    return pick<float, float>(x, scale, out, rows, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
