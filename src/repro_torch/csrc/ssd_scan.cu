// Mamba selective scan for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py:
// ssd_scan (body _ssd_kernel).  For every batch row b and channel d, over
// the sequence t = 0..S-1, with the state h (N values) starting at zero:
//   h[n] = exp(dt[b,t,d] * A[d,n]) * h[n] + (dt[b,t,d] * x[b,t,d]) * B[b,t,n]
//   y[b,t,d] = sum_n h[n] * C[b,t,n]
// x and dt are bf16 or f32, A, B and C f32, the arithmetic and y f32.
//
// The TPU kernel walks the sequence as a sequential ("arbitrary") grid
// axis of chunks and carries the (d_block, N) state in VMEM scratch from
// one chunk to the next.  Blocks on this card run in no order, so the
// carry stays in registers instead: a group of N/4 neighbouring lanes owns
// one (b, d) pair, each lane four of its N states and the matching four
// values of A, and the group walks the whole sequence.  Nothing crosses
// blocks, and the output does not depend on the chunking the caller
// names, which only selects the reference's shape checks.  The partial
// sums of y meet through warp shuffles.
//
// Bound on this card: bytes, then the special-function unit.  At B=4,
// S=1024, Din=8192, N=16 (jamba prefill) the call reads x (bf16) and dt
// (f32) and writes y (f32): ~336 MB, 0.100 ms at 3.35 TB/s; it also needs
// B*S*Din*N = 537 M exponentials, which the MUFU (16 per clock per SM,
// 132 SMs, ~1.98 GHz) computes in no less than ~0.13 ms.  The exponential
// is one ex2.approx with log2(e) folded into A.  Only B*Din/P blocks of
// four warps exist (1024 at the jamba shape, ~8 per SM), so each block
// keeps the next chunk's x, dt, B and C rows in flight with cp.async
// while it computes the current one from shared memory; a first version
// that loaded every step's values from device memory waited one memory
// round trip per step and took 2.3x as long.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct Strides {  // element strides of (B, S) for one (B, S, *) tensor
  long long b, s;
};

// cp.async of 16 bytes into shared memory; src_bytes = 0 fills zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0));
}

// N states per (b, d) pair, four per lane: G = N / 4 lanes per pair,
// P = 128 / G pairs per block.  The sequence goes in chunks of L steps
// (L * P = 1024) that cp.async stages in shared memory two deep: the x
// and dt rows of the block's P channels and the B and C rows, which all
// of its pairs share.
template <int N, typename TX, typename TD>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const TX* __restrict__ x, const TD* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, float* __restrict__ y, int S,
                int Din, Strides sx, Strides sdt) {
  constexpr int G = N / 4;
  constexpr int P = kThreads / G;
  constexpr int L = 1024 / P;
  constexpr int kXc = P * sizeof(TX) / 16;   // 16-byte chunks per x row
  constexpr int kDc = P * sizeof(TD) / 16;
  constexpr int kBc = L * N / 4;             // 16-byte chunks of B rows
  __shared__ __align__(16) TX xs[2][L][P];
  __shared__ __align__(16) TD ds[2][L][P];
  __shared__ __align__(16) float bs[2][L][N];
  __shared__ __align__(16) float cs[2][L][N];

  const int tid = threadIdx.x;
  const int sub = tid % G, pair = tid / G;
  const int d0 = blockIdx.x * P;
  const int d = d0 + pair;
  const int b = blockIdx.y;
  const bool valid = d < Din;

  float a2[4], h[4];
  const float4 av = valid
      ? *reinterpret_cast<const float4*>(A + static_cast<size_t>(d) * N +
                                         sub * 4)
      : make_float4(0.f, 0.f, 0.f, 0.f);
  a2[0] = av.x * kLog2e; a2[1] = av.y * kLog2e;
  a2[2] = av.z * kLog2e; a2[3] = av.w * kLog2e;
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = 0.f;

  const TX* xb = x + b * sx.b + d0;
  const TD* db = dt + b * sdt.b + d0;
  const float* bb = Bm + static_cast<size_t>(b) * S * N;
  const float* cb = Cm + static_cast<size_t>(b) * S * N;
  float* yp = y + static_cast<size_t>(b) * S * Din + d;

  auto load = [&](int st, int t0) {
    for (int i = tid; i < L * kXc; i += kThreads) {
      const int r = i / kXc, c = (i % kXc) * (16 / sizeof(TX));
      const bool ok = t0 + r < S && d0 + c < Din;
      cp_async16(&xs[st][r][c], ok ? xb + (t0 + r) * sx.s + c : xb, ok);
    }
    for (int i = tid; i < L * kDc; i += kThreads) {
      const int r = i / kDc, c = (i % kDc) * (16 / sizeof(TD));
      const bool ok = t0 + r < S && d0 + c < Din;
      cp_async16(&ds[st][r][c], ok ? db + (t0 + r) * sdt.s + c : db, ok);
    }
    for (int i = tid; i < 2 * kBc; i += kThreads) {
      const int j = i % kBc, r = j / (N / 4), c = (j % (N / 4)) * 4;
      const bool ok = t0 + r < S;
      const float* src = (i < kBc ? bb : cb) + static_cast<size_t>(t0 + r) * N;
      float* dst = i < kBc ? &bs[st][r][c] : &cs[st][r][c];
      cp_async16(dst, ok ? src + c : bb, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  const int chunks = (S + L - 1) / L;
  load(0, 0);
  for (int ci = 0; ci < chunks; ++ci) {
    const int st = ci & 1, t0 = ci * L;
    if (ci + 1 < chunks) {
      load(st ^ 1, t0 + L);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const int steps = min(L, S - t0);
    for (int r = 0; r < steps; ++r) {
      const float xv = to_f(xs[st][r][pair]);
      const float dv = to_f(ds[st][r][pair]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[st][r][sub * 4]);
      const float4 cv = *reinterpret_cast<const float4*>(&cs[st][r][sub * 4]);
      const float bx[4] = {bv.x, bv.y, bv.z, bv.w};
      const float cx[4] = {cv.x, cv.y, cv.z, cv.w};
      const float dx = dv * xv;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        h[i] = fmaf(ex2(dv * a2[i]), h[i], dx * bx[i]);
        acc = fmaf(h[i], cx[i], acc);
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (valid && sub == 0) yp[static_cast<size_t>(t0 + r) * Din] = acc;
    }
    __syncthreads();   // the next load overwrites this stage
  }
}

template <int N, typename TX, typename TD>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, int B, int S, int Din, Strides sx,
           Strides sdt, cudaStream_t stream) {
  constexpr int kPairs = kThreads / (N / 4);
  const dim3 grid((Din + kPairs - 1) / kPairs, B);
  ssd_scan_kernel<N, TX, TD><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TD*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y), S, Din, sx,
      sdt);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int by_dtype(const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, void* y, int B, int S, int Din, Strides sx,
             Strides sdt, int x_dtype, int dt_dtype, cudaStream_t st) {
  using bf = __nv_bfloat16;
  if (x_dtype == 0 && dt_dtype == 0)
    return launch<N, bf, bf>(x, dt, A, Bm, Cm, y, B, S, Din, sx, sdt, st);
  if (x_dtype == 0 && dt_dtype == 1)
    return launch<N, bf, float>(x, dt, A, Bm, Cm, y, B, S, Din, sx, sdt, st);
  if (x_dtype == 1 && dt_dtype == 0)
    return launch<N, float, bf>(x, dt, A, Bm, Cm, y, B, S, Din, sx, sdt, st);
  if (x_dtype == 1 && dt_dtype == 1)
    return launch<N, float, float>(x, dt, A, Bm, Cm, y, B, S, Din, sx, sdt,
                                   st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, dt: (B, S, Din) with unit stride along Din and element strides
// (x_b, x_s), (dt_b, dt_s); A: (Din, N) contiguous f32; Bm, Cm: (B, S, N)
// contiguous f32; y: (B, S, Din) contiguous f32.  N is 4, 8 or 16.
// x_dtype, dt_dtype: 0 = bfloat16, 1 = float32.  Returns the cudaError_t
// of the launch.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y,
                               int B, int S, int Din, int N, long long x_b,
                               long long x_s, long long dt_b, long long dt_s,
                               int x_dtype, int dt_dtype, void* stream) {
  if (B <= 0 || S <= 0 || Din <= 0) return 0;
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides sx{x_b, x_s}, sdt{dt_b, dt_s};
  if (N == 16)
    return by_dtype<16>(x, dt, A, Bm, Cm, y, B, S, Din, sx, sdt, x_dtype,
                        dt_dtype, st);
  if (N == 8)
    return by_dtype<8>(x, dt, A, Bm, Cm, y, B, S, Din, sx, sdt, x_dtype,
                       dt_dtype, st);
  if (N == 4)
    return by_dtype<4>(x, dt, A, Bm, Cm, y, B, S, Din, sx, sdt, x_dtype,
                       dt_dtype, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
