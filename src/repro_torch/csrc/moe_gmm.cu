// Grouped expert matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_gmm/kernel.py:
// moe_gmm (body _gmm_kernel):
//   y[e, c, :] = x[e, c, :] @ w[e]   for c < group_sizes[e], else 0,
// for x (E, C, D), w (E, D, F), y (E, C, F) in x's dtype, with the sums
// kept in f32.
//
// The TPU kernel walks D as a sequential grid axis into an f32 VMEM tile
// and masks the rows past the group size in its epilogue.  Here one block
// owns one (expert, row tile, column tile) and walks D in a loop of its
// own.  A block whose first row is at or past group_sizes[e] writes its
// zeros and stops, and rows past the group size are never read (their
// loads are zero-filled), so an expert's padding costs no product.
//
// bf16: tensor cores through WMMA (mma.sync 16x16x16, f32 accumulators).
// A 256-thread block computes a 128 x 128 tile of y, 32 x 64 per warp,
// from 128 x 32 tiles of x and 32 x 128 tiles of w that cp.async brings
// into shared memory two stages deep (zero-filled past the edges); with
// at most 16 rows per expert (decode) the tile is 16 x 128.  f32:
// the CUDA cores in full f32 (TF32 would miss the reference's 2e-4):
// 64 x 64 tiles, 4 x 4 outputs per thread.
//
// Bound on this card: operations at prefill, bytes at decode.  jamba at
// B=4, S=1024 has C = 640: (16, 640, 4096) x (16, 4096, 28672) is 2.41
// TFLOP, 2.43 ms at 989 TFLOP/s.  A decode step has C <= 8 and reads
// every weight of every expert that has a row: 3.76 GB, 1.12 ms at
// 3.35 TB/s, for the same product.  This kernel uses neither wgmma nor
// TMA, so it stays well above the first bound; it reaches for the second
// by reading each weight tile once per row tile.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// ---- bf16: WMMA ----------------------------------------------------------
constexpr int kBN = 128, kBK = 32;
constexpr int kThreads = 256;               // 8 warps
constexpr int kAs = kBK + 8;                // padded row of the x tile
constexpr int kBs = kBN + 8;                // padded row of the w tile
// Row tiles: 128 rows (8 warps as 4 x 2, 32 x 64 each) for prefill, and
// 16 rows (8 warps as 1 x 8, 16 x 16 each) for decode, whose few rows
// make the product a stream of weights: the small tile keeps its
// registers and shared memory low, so more blocks, and more weight tiles,
// are in flight on each SM.
template <int BM>
struct Tiling {
  static constexpr int kWarpsN = BM >= 128 ? 2 : 8;
  static constexpr int kWarpsM = 8 / kWarpsN;
  static constexpr int kFragM = BM / (16 * kWarpsM);
  static constexpr int kFragN = kBN / (16 * kWarpsN);
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;              // 0: fill the 16 bytes with 0
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T>
__device__ void zero_tile(T* y, int C, int F, int c0, int f0, int bm,
                          int bn) {
  for (int i = threadIdx.x; i < bm * bn; i += blockDim.x) {
    const int r = c0 + i / bn, c = f0 + i % bn;
    if (r < C && c < F) y[static_cast<size_t>(r) * F + c] = T(0.f);
  }
}

template <int kBM>
__global__ void __launch_bounds__(kThreads)
gmm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const int* __restrict__ group_sizes, bf16* __restrict__ y,
                int C, int D, int F) {
  using namespace nvcuda;
  using T = Tiling<kBM>;
  constexpr int kFM = T::kFragM, kFN = T::kFragN;
  __shared__ __align__(128) bf16 As[2][kBM][kAs];
  __shared__ __align__(128) bf16 Bs[2][kBK][kBs];
  // the epilogue stages one 16 x 16 f32 fragment per warp in Bs
  static_assert(sizeof(Bs) >= 8 * 256 * sizeof(float), "");

  const int e = blockIdx.z;
  const int c0 = blockIdx.y * kBM, f0 = blockIdx.x * kBN;
  const int rows = min(C, group_sizes[e]);   // valid rows of this expert
  const bf16* xe = x + static_cast<size_t>(e) * C * D;
  const bf16* we = w + static_cast<size_t>(e) * D * F;
  bf16* ye = y + static_cast<size_t>(e) * C * F;
  if (c0 >= rows) {
    zero_tile(ye, C, F, c0, f0, kBM, kBN);
    return;
  }

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / T::kWarpsN, wn = warp % T::kWarpsN;

  auto load_stage = [&](int st, int k0) {
#pragma unroll
    for (int i = 0; i < (kBM * 4 + kThreads - 1) / kThreads; ++i) {
      const int idx = tid + i * kThreads;    // x tile: 4 chunks a row
      if (kBM * 4 % kThreads && idx >= kBM * 4) break;
      const int r = idx / 4, c = (idx % 4) * 8;
      const bool ok = (c0 + r) < rows && (k0 + c) < D;
      const bf16* src = ok ? xe + static_cast<size_t>(c0 + r) * D + k0 + c
                           : xe;
      cp_async16(&As[st][r][c], src, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {            // w tile: 32 rows x 16 chunks
      const int idx = tid + i * kThreads;
      const int r = idx / 16, c = (idx % 16) * 8;
      const bool ok = (k0 + r) < D && (f0 + c) < F;
      const bf16* src = ok ? we + static_cast<size_t>(k0 + r) * F + f0 + c
                           : we;
      cp_async16(&Bs[st][r][c], src, ok);
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFM][kFN];
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (D + kBK - 1) / kBK;
  load_stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {
      load_stage(st ^ 1, (kt + 1) * kBK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          a[kFM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
          b[kFN];
#pragma unroll
      for (int i = 0; i < kFM; ++i)
        wmma::load_matrix_sync(a[i], &As[st][(wm * kFM + i) * 16][ks], kAs);
#pragma unroll
      for (int j = 0; j < kFN; ++j)
        wmma::load_matrix_sync(b[j], &Bs[st][ks][(wn * kFN + j) * 16], kBs);
#pragma unroll
      for (int i = 0; i < kFM; ++i)
#pragma unroll
        for (int j = 0; j < kFN; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();   // the next iteration's loads overwrite this stage
  }

  // epilogue: each warp stages one 16 x 16 f32 fragment at a time in
  // shared memory (the tiles are free now) and writes it as bf16 rows
  // of 8, zero past the group size
  float* stage = reinterpret_cast<float*>(&Bs[0][0][0]) + warp * 256;
  const int fr = lane / 2, fc = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < kFM; ++i) {
#pragma unroll
    for (int j = 0; j < kFN; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r = c0 + (wm * kFM + i) * 16 + fr;
      const int c = f0 + (wn * kFN + j) * 16 + fc;
      if (r < C && c < F) {
        const bool live = r < rows;
        uint4 u;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float v0 = live ? stage[fr * 16 + fc + 2 * q] : 0.f;
          const float v1 = live ? stage[fr * 16 + fc + 2 * q + 1] : 0.f;
          h[q] = __floats2bfloat162_rn(v0, v1);
        }
        *reinterpret_cast<uint4*>(ye + static_cast<size_t>(r) * F + c) = u;
      }
      __syncwarp();
    }
  }
}

//: at most this many rows per expert take the 16-row tile
constexpr int kDecodeRows = 16;

// ---- f32: CUDA cores -------------------------------------------------------
constexpr int kFM = 64, kFN = 64, kFK = 16;

__global__ void __launch_bounds__(kThreads)
gmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const int* __restrict__ group_sizes, float* __restrict__ y,
               int C, int D, int F) {
  __shared__ __align__(16) float As[kFK][kFM + 4];   // x tile, transposed
  __shared__ __align__(16) float Bs[kFK][kFN + 4];

  const int e = blockIdx.z;
  const int c0 = blockIdx.y * kFM, f0 = blockIdx.x * kFN;
  const int rows = min(C, group_sizes[e]);
  const float* xe = x + static_cast<size_t>(e) * C * D;
  const float* we = w + static_cast<size_t>(e) * D * F;
  float* ye = y + static_cast<size_t>(e) * C * F;
  if (c0 >= rows) {
    zero_tile(ye, C, F, c0, f0, kFM, kFN);
    return;
  }
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < D; k0 += kFK) {
    {   // x: 64 rows x 16 k, one float4 of k per thread
      const int r = tid / 4, k = (tid % 4) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c0 + r < rows && k0 + k < D)
        v = *reinterpret_cast<const float4*>(
            xe + static_cast<size_t>(c0 + r) * D + k0 + k);
      As[k][r] = v.x; As[k + 1][r] = v.y; As[k + 2][r] = v.z;
      As[k + 3][r] = v.w;
    }
    {   // w: 16 k x 64 columns, one float4 of columns per thread
      const int k = tid / 16, c = (tid % 16) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + k < D && f0 + c < F)
        v = *reinterpret_cast<const float4*>(
            we + static_cast<size_t>(k0 + k) * F + f0 + c);
      *reinterpret_cast<float4*>(&Bs[k][c]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = c0 + ty * 4 + i;
    if (r >= C) continue;
    const bool live = r < rows;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = f0 + tx * 4 + j;
      if (c < F) ye[static_cast<size_t>(r) * F + c] = live ? acc[i][j] : 0.f;
    }
  }
}

}  // namespace

// x: (E, C, D), w: (E, D, F), y: (E, C, F), all contiguous and of one
// dtype (0 = bfloat16, 1 = float32), 16-byte aligned; group_sizes: (E,)
// int32 on the device.  D and F must be multiples of 8 (the wrapper
// checks).  Returns the cudaError_t of the launch.
extern "C" int moe_gmm_launch(const void* x, const void* w,
                              const void* group_sizes, void* y, int E, int C,
                              int D, int F, int dtype, void* stream) {
  if (E <= 0 || C <= 0 || F <= 0) return 0;
  if (E > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* gs = static_cast<const int*>(group_sizes);
  if (dtype == 0 && C <= kDecodeRows) {
    const dim3 grid((F + kBN - 1) / kBN, (C + kDecodeRows - 1) / kDecodeRows,
                    E);
    gmm_bf16_kernel<kDecodeRows><<<grid, kThreads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), gs,
        static_cast<bf16*>(y), C, D, F);
  } else if (dtype == 0) {
    const dim3 grid((F + kBN - 1) / kBN, (C + 127) / 128, E);
    gmm_bf16_kernel<128><<<grid, kThreads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), gs,
        static_cast<bf16*>(y), C, D, F);
  } else if (dtype == 1) {
    const dim3 grid((F + kFN - 1) / kFN, (C + kFM - 1) / kFM, E);
    gmm_f32_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), gs,
        static_cast<float*>(y), C, D, F);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
