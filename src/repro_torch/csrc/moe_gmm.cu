// Grouped expert matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_gmm/kernel.py:
// moe_gmm (body _gmm_kernel):
//   y[e, c, :] = x[e, c, :] @ w[e]   for c < group_sizes[e], else 0,
// for x (E, C, D), w (E, D, F), y (E, C, F) in x's dtype, with the sums
// kept in f32.  The TPU kernel walks D as a sequential grid axis into an
// f32 VMEM tile and masks the rows past the group size in its epilogue.
//
// Bound on this card: operations at prefill, bytes at decode.  jamba at
// B=4, S=1024 has C = 640 and about 8,192 of 10,240 rows live:
// (16, 640, 4096) x (16, 4096, 28672) is then 1.92 TFLOP on the live
// rows, 1.95 ms at 989 TFLOP/s, and (16, 640, 14336) x (16, 14336, 4096)
// 0.96 TFLOP.  A decode step has C <= 8 and reads the weights of every
// expert that has a row: up to 3.76 GB, 1.12 ms at 3.35 TB/s.
//
// Three kernels, chosen by a fixed rule in moe_gmm_launch:
//
// bf16, C > 16 (prefill): warp-specialised wgmma fed by TMA.  A persistent
//   grid of one 384-thread block per SM walks only the live tiles
//   (expert, 128-row tile below min(group size, C), 256-column tile), in
//   an order where the blocks running side by side share an expert's x
//   and a column panel of its w in L2, so w is read from device memory
//   about once.  One producer thread (its warpgroup lowered to 40
//   registers with setmaxnreg) issues TMA loads of 128 x 64 tiles of x
//   and 64 x 256 tiles of w (four 64-column boxes: the 128-byte swizzle
//   caps a box row at 64 bf16) into a four-stage ring guarded by full and
//   empty mbarriers.  Two consumer warpgroups (232 registers) each own 64
//   rows and issue wgmma m64n256k16 on the swizzled tiles: x K-major, w
//   F-major through wgmma's transpose-B bit, so the weights are read as
//   they lie.  The tensor maps are 3-D, (E, C, D), (E, D, F) and (E, C,
//   F): a box never crosses an expert, and TMA zero-fills loads and drops
//   stores past C, D or F, so ragged shapes need no code of their own.
//   A warpgroup whose 64 rows all lie at or past the group size skips its
//   products.  The epilogue writes bf16 (zeros at or past the group size)
//   into a swizzled staging tile that one thread stores with TMA, so the
//   warpgroup goes on to its next tile while the store drains; a small
//   kernel launched first zeroes the rows of the groups that are skipped.
//   What still bounds it: every block reads its 48 KB stage from L2 for
//   4.2 MFLOP (87 FLOP per byte), and 128-row tiles compute the padding
//   of each expert's last tile.
// bf16, C <= 16 (decode): WMMA (mma.sync 16x16x16) on 16 x 128 tiles
//   with two cp.async stages: few rows make the product a stream of
//   weights, and small blocks keep many weight tiles in flight per SM.
//   A tile at or past the group size writes its zeros and stops, and
//   rows past it are never read.
// f32: the CUDA cores in full f32 (TF32 would miss the reference's
//   2e-4): 64 x 64 tiles, 4 x 4 outputs per thread.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace sm90 = repro_torch::sm90;

// ---- bf16 prefill: wgmma + TMA, persistent over live tiles ------------------
namespace wg {
constexpr int kBM = 128, kBN = 256, kBK = 64, kStages = 4;
constexpr int kConsumers = 2;                     // warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's
constexpr uint32_t kABytes = kBM * kBK * 2;       // x tile, 16 KB
constexpr uint32_t kPanel = 64 * 64 * 2;          // a 64 x 64 box, 8 KB
constexpr uint32_t kBBytes = kPanel * (kBN / 64); // w tile, 32 KB
constexpr uint32_t kStageBytes = kABytes + kBBytes;
constexpr uint32_t kOutBytes = 2 * kPanel;        // 64 x 128 of y per group
constexpr size_t kSmem = kStages * kStageBytes + kConsumers * kOutBytes +
                         2 * kStages * sizeof(uint64_t) + 1024;  // + align
}  // namespace wg

// The live tiles of all experts in one order: expert by expert; within
// an expert column tile by column tile, row tile fastest, so that the
// blocks running side by side share an expert's x and a column panel of
// its w in L2.  A block visits tiles t = blockIdx.x, blockIdx.x +
// gridDim.x, ... and keeps its place.
struct TileWalk {
  const int* gs;
  int E, C, nt;
  int e = 0, base = 0, cnt = 0;   // expert e owns tiles [base, base + cnt)
  int mt = 0;                      // its row tiles

  __device__ TileWalk(const int* gs_, int E_, int C_, int nt_)
      : gs(gs_), E(E_), C(C_), nt(nt_) {
    enter(0);
  }
  __device__ int rows(int i) const { return max(0, min(C, __ldg(gs + i))); }
  __device__ void enter(int i) {
    mt = (rows(i) + wg::kBM - 1) / wg::kBM;
    cnt = mt * nt;
  }
  // Moves to tile t (t never decreases); false past the last one.
  __device__ bool seek(int t) {
    while (t >= base + cnt) {
      base += cnt;
      if (++e >= E) return false;
      enter(e);
    }
    return true;
  }
  __device__ int m0(int t) const { return (t - base) % mt * wg::kBM; }
  __device__ int n0(int t) const { return (t - base) / mt * wg::kBN; }
};

__device__ __forceinline__ int warp_uniform(int v) {
  return __shfl_sync(0xffffffffu, v, 0);
}

__global__ void __launch_bounds__(wg::kThreads, 1)
gmm_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tmx,
                      const __grid_constant__ CUtensorMap tmw,
                      const __grid_constant__ CUtensorMap tmy,
                      const int* __restrict__ group_sizes, int E, int C,
                      int D, int F) {
  using namespace wg;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  unsigned char* tiles =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* out = tiles + kStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(out + kConsumers * kOutBytes);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);                 // the producer's arrive
      sm90::mbar_init(&empty[s], kConsumers * 4);   // one per consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int nt = (F + kBN - 1) / kBN, nk = (D + kBK - 1) / kBK;
  TileWalk walk(group_sizes, E, C, nt);
  // warp-uniform in the compiler's eyes too, so that the wgmma path is
  // not divergent code (ptxas would serialise its wgmmas)
  const int wgi = warp_uniform(threadIdx.x / 128);

  if (wgi == 0) {
    // ---- producer: one thread keeps the ring full ----
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      sm90::tma_prefetch_desc(&tmx);
      sm90::tma_prefetch_desc(&tmw);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; walk.seek(t); t += gridDim.x) {
        const int m0 = walk.m0(t), n0 = walk.n0(t);
        for (int kt = 0; kt < nk; ++kt) {
          sm90::mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* a = tiles + stage * kStageBytes;
          sm90::mbar_expect_tx(&full[stage], kStageBytes);
          sm90::tma_load_3d(a, &tmx, &full[stage], kt * kBK, m0, walk.e);
#pragma unroll
          for (int p = 0; p < kBN / 64; ++p)
            sm90::tma_load_3d(a + kABytes + p * kPanel, &tmw, &full[stage],
                              n0 + 64 * p, kt * kBK, walk.e);
          if (++stage == kStages) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cg owns rows [64 cg, 64 cg + 64) ----
    sm90::setmaxnreg_inc<232>();
    const int cg = wgi - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const uint32_t ob = sm90::smem_u32(out + cg * kOutBytes);
    float acc[128];
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; warp_uniform(walk.seek(t)); t += gridDim.x) {
      const int m0 = warp_uniform(walk.m0(t)), n0 = warp_uniform(walk.n0(t));
      const int rows = warp_uniform(walk.rows(walk.e));
      // a group whose 64 rows are all at or past the group size only
      // hands the stages back; the zero-row kernel writes its rows
      if (m0 + cg * 64 >= rows) {
        for (int kt = 0; kt < nk; ++kt) {
          sm90::mbar_wait(&full[stage], phase);
          if (lane == 0) sm90::mbar_arrive(&empty[stage]);
          if (++stage == kStages) { stage = 0; phase ^= 1; }
        }
        continue;
      }
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int kt = 0; kt < nk; ++kt) {
        sm90::mbar_wait(&full[stage], phase);
        const uint32_t a = sm90::smem_u32(tiles + stage * kStageBytes) +
                           cg * kPanel;
        const uint32_t b = sm90::smem_u32(tiles + stage * kStageBytes +
                                          kABytes);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          sm90::wgmma_m64n256k16_ss_tb(
              acc, sm90::wgmma_desc(a + 32 * kk, 16, 1024),
              sm90::wgmma_desc(b + 2048 * kk, kPanel, 1024));
        sm90::wgmma_commit();
        // the previous stage's products are done: hand it back
        sm90::wgmma_wait<1>();
        if (prev >= 0 && lane == 0) sm90::mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == kStages) { stage = 0; phase ^= 1; }
      }
      sm90::wgmma_wait<0>();
      if (prev >= 0 && lane == 0) sm90::mbar_arrive(&empty[prev]);
#pragma unroll
      for (int i = 0; i < 128; ++i) sm90::fence_reg(acc[i]);

      // epilogue, 128 columns at a time: bf16 into a 64 x 128 staging tile
      // in the TMA layout (two 64 x 64 boxes, 128-byte swizzle: row r's
      // 16-byte chunk c at c ^ (r % 8)), zeros at or past the group size;
      // one thread stores it with TMA, which drops rows past C and columns
      // past F, and the group goes on to its next tile
      const int r = warp * 16 + lane / 4;      // and r + 8, of the 64
      const bool ok0 = m0 + cg * 64 + r < rows;
      const bool ok1 = m0 + cg * 64 + r + 8 < rows;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (tid == 0) sm90::bulk_wait_read();  // the buffer is free again
        sm90::named_barrier(1 + cg, 128);
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          const int j = 16 * half + jj;
          const uint32_t box = ob + (jj / 8) * kPanel + 4 * (lane % 4);
          const uint32_t c0 = ((jj % 8) ^ (r % 8)) * 16;
          sm90::st_shared_u32(box + r * 128 + c0,
                              ok0 ? sm90::pack_bf16(acc[4 * j],
                                                    acc[4 * j + 1])
                                  : 0u);
          sm90::st_shared_u32(box + (r + 8) * 128 + c0,
                              ok1 ? sm90::pack_bf16(acc[4 * j + 2],
                                                    acc[4 * j + 3])
                                  : 0u);
        }
        sm90::fence_proxy_async();
        sm90::named_barrier(1 + cg, 128);
        if (tid == 0) {
          for (int p = 0; p < 2; ++p)
            sm90::tma_store_3d(&tmy, out + cg * kOutBytes + p * kPanel,
                               n0 + 128 * half + 64 * p, m0 + cg * 64,
                               walk.e);
          sm90::bulk_commit();
        }
      }
    }
    if (tid == 0) sm90::bulk_wait_all();
  }
}

// Rows from min(group size, C) rounded up to 64 to C of every expert as
// zeros, 16 bytes a store (F is a multiple of 8).  The wgmma kernel writes
// the 64-row groups below, their rows past the group size as zeros.
constexpr int kZeroRows = 8;

__global__ void __launch_bounds__(256)
gmm_zero_rows_kernel(const int* __restrict__ group_sizes,
                     bf16* __restrict__ y, int C, int F) {
  const int e = blockIdx.y;
  const int live = (max(0, min(C, group_sizes[e])) + 63) / 64 * 64;
  const int r0 = blockIdx.x * kZeroRows;
  if (r0 + kZeroRows <= live) return;
  const int chunks = F / 8;
  for (int i = threadIdx.x; i < kZeroRows * chunks; i += blockDim.x) {
    const int r = r0 + i / chunks, c = (i % chunks) * 8;
    if (r >= live && r < C)
      *reinterpret_cast<uint4*>(y + (static_cast<size_t>(e) * C + r) * F +
                                c) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// ---- bf16 decode: WMMA on 16-row tiles ------------------------------------
//: at most this many rows per expert take the decode kernel
constexpr int kDecodeRows = 16;
constexpr int kBM = kDecodeRows, kBN = 128, kBK = 32;
constexpr int kThreads = 256;               // 8 warps, 16 x 16 each
constexpr int kAs = kBK + 8;                // padded row of the x tile
constexpr int kBs = kBN + 8;                // padded row of the w tile

template <typename T>
__device__ void zero_tile(T* y, int C, int F, int c0, int f0, int bm,
                          int bn) {
  for (int i = threadIdx.x; i < bm * bn; i += blockDim.x) {
    const int r = c0 + i / bn, c = f0 + i % bn;
    if (r < C && c < F) y[static_cast<size_t>(r) * F + c] = T(0.f);
  }
}

__global__ void __launch_bounds__(kThreads)
gmm_bf16_decode_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       const int* __restrict__ group_sizes,
                       bf16* __restrict__ y, int C, int D, int F) {
  using namespace nvcuda;
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

  auto load_stage = [&](int st, int k0) {
    if (tid < kBM * 4) {                     // x tile: 4 chunks a row
      const int r = tid / 4, c = (tid % 4) * 8;
      const bool ok = (c0 + r) < rows && (k0 + c) < D;
      const bf16* src = ok ? xe + static_cast<size_t>(c0 + r) * D + k0 + c
                           : xe;
      sm90::cp_async16(&As[st][r][c], src, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {            // w tile: 32 rows x 16 chunks
      const int idx = tid + i * kThreads;
      const int r = idx / 16, c = (idx % 16) * 8;
      const bool ok = (k0 + r) < D && (f0 + c) < F;
      const bf16* src = ok ? we + static_cast<size_t>(k0 + r) * F + f0 + c
                           : we;
      sm90::cp_async16(&Bs[st][r][c], src, ok);
    }
    sm90::cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.f);

  const int nk = (D + kBK - 1) / kBK;
  load_stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {
      load_stage(st ^ 1, (kt + 1) * kBK);
      sm90::cp_async_wait<1>();
    } else {
      sm90::cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, &As[st][0][ks], kAs);
      wmma::load_matrix_sync(b, &Bs[st][ks][warp * 16], kBs);
      wmma::mma_sync(acc, a, b, acc);
    }
    __syncthreads();   // the next iteration's loads overwrite this stage
  }

  // epilogue: each warp stages its 16 x 16 f32 fragment in shared memory
  // (the tiles are free now) and writes it as bf16 rows of 8, zero past
  // the group size
  float* stage = reinterpret_cast<float*>(&Bs[0][0][0]) + warp * 256;
  const int fr = lane / 2, fc = (lane % 2) * 8;
  wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
  __syncwarp();
  const int r = c0 + fr;
  const int c = f0 + warp * 16 + fc;
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
}

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

// ---- host side of the wgmma kernel ------------------------------------------

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library links nothing beyond what nvcc links by default.
PFN_cuTensorMapEncodeTiled encode_fn() {
  static PFN_cuTensorMapEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(p);
  }
  return fn;
}

// A 3-D bf16 tensor (n2, n1, n0), n0 contiguous, read in boxes of
// (1, b1, b0) with the 128-byte swizzle; out-of-bounds reads give zeros.
int make_map(CUtensorMap* map, const void* base, uint64_t n0, uint64_t n1,
             uint64_t n2, uint32_t b0, uint32_t b1) {
  PFN_cuTensorMapEncodeTiled encode = encode_fn();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cuuint64_t dims[3] = {n0, n1, n2};
  cuuint64_t strides[2] = {n0 * 2, n0 * n1 * 2};   // bytes, of dims 1, 2
  cuuint32_t box[3] = {b0, b1, 1};
  cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
      dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

int launch_wgmma(const bf16* x, const bf16* w, const int* gs, bf16* y,
                 int E, int C, int D, int F, cudaStream_t st) {
  CUtensorMap tmx, tmw, tmy;
  int err = make_map(&tmx, x, D, C, E, wg::kBK, wg::kBM);
  if (err == 0) err = make_map(&tmw, w, F, D, E, 64, wg::kBK);
  if (err == 0) err = make_map(&tmy, y, F, C, E, 64, 64);
  if (err != 0) return err;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        gmm_bf16_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(wg::kSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  // one block per SM, or fewer if there are fewer tiles
  const long long tiles = static_cast<long long>(E) *
                          ((C + wg::kBM - 1) / wg::kBM) *
                          ((F + wg::kBN - 1) / wg::kBN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  gmm_zero_rows_kernel<<<dim3((C + kZeroRows - 1) / kZeroRows, E), 256, 0,
                         st>>>(gs, y, C, F);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  gmm_bf16_wgmma_kernel<<<grid, wg::kThreads, wg::kSmem, st>>>(
      tmx, tmw, tmy, gs, E, C, D, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (E, C, D), w: (E, D, F), y: (E, C, F), all contiguous and of one
// dtype (0 = bfloat16, 1 = float32), 16-byte aligned; group_sizes: (E,)
// int32 on the device.  D and F must be multiples of 8 (the wrapper
// checks).  Kernel by rule: bf16 with C <= 16 the decode kernel, bf16
// otherwise the wgmma kernel (after its zero-row kernel), f32 the CUDA-core
// kernel.  Returns the cudaError_t of the launch.
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
    gmm_bf16_decode_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), gs,
        static_cast<bf16*>(y), C, D, F);
  } else if (dtype == 0) {
    return launch_wgmma(static_cast<const bf16*>(x),
                        static_cast<const bf16*>(w), gs,
                        static_cast<bf16*>(y), E, C, D, F, st);
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
