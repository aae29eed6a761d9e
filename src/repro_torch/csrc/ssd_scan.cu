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
// carry stays in registers instead: one lane owns one (b, d) channel and
// all N of its states, and walks the whole sequence.  Nothing crosses
// blocks, and the output does not depend on the chunking the caller
// names, which only selects the reference's shape checks.
//
// What bounds it, at B=4, S=1024, Din=8192, N=16 (jamba prefill; x bf16,
// dt f32, y f32):
// - bytes: x and dt read once and y written once, ~336 MB, 0.100 ms at
//   3.35 TB/s;
// - the special-function unit: B*S*Din*N = 537 M exponentials, which the
//   MUFU (16 per clock per SM, 132 SMs, 1.98 GHz) computes in no less
//   than 0.128 ms;
// - issue: a sub-partition issues one warp instruction per clock.  Each
//   state-step needs five (dt*a, the exponential, dx*b, the h FMA, the y
//   FMA), and each step of a lane about 20 more (its x, dt, B and C loads
//   from shared memory, dt*x, the store, its share of the copies).
//
// What the design does about each:
// - A lane holds all N states of its channel, so its loads, dt*x and the
//   store are paid once per N states (the kernel this one replaced gave
//   each lane 4 states and paid them, and a two-shuffle reduction of y,
//   once per 4).  No shuffle is left, and a warp stores 128 contiguous
//   bytes of y per step.  Only B*Din/32 warps exist (1,024 at jamba's
//   shape, ~2 per sub-partition): latency is hidden by the N independent
//   state chains of each lane.  Two lanes per channel (twice the warps,
//   the per-step work paid once per 8 states, y reduced by shuffles)
//   measured slower at every share below, and were taken out.
// - Each warp stages its own 32 x and dt columns and the B and C rows in
//   a ring of 4 chunks of kSteps steps in shared memory, with cp.async 3
//   chunks ahead.  No warp waits on another: a __syncwarp per chunk is
//   the only barrier.  kSteps is a compile-time constant, so the step
//   loop unrolls and the exponentials of later steps issue ahead of the
//   h chain (one FMA deep per step).
// - The exponential is 2^(dt * A*log2(e)).  The last state of each half
//   of a channel's 16 computes it on the FMA pipe (exp2_poly: a degree-5
//   polynomial and an exponent add, ~11 instructions), the other 14 with
//   ex2.approx.ftz on the MUFU: at 14 of 16 the MUFU's 112 clocks per
//   warp-step sit under the ~130 issue slots, where all 16 on the MUFU
//   would need 128 (kPolyShare; scripts/ssd_probe.py times 0, 2 and 4
//   of 16 in copies of this source).
// - Order of accumulation: y = fma(h[N-1], C[N-1], ... fma(h[1], C[1],
//   h[0] * C[0])), n in order.  ref.ssd_scan_kernel_order mirrors this
//   order and the states given to exp2_poly in plain PyTorch.
// On an H100 at jamba's shape it takes ~0.18 ms, 55% of the byte bound:
// a sub-partition's two warps issue ~74% of the clocks (one warp alone
// takes 0.117 ms, however few channels there are).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;              // per block
constexpr int kThreads = kWarps * 32;
constexpr int kSteps = 16;             // steps per staged chunk
constexpr int kStages = 4;             // chunks in a warp's ring
// Exponentials on the FMA pipe per 32 states: N * kPolyShare / 32 in each
// half of a channel's states, its last ones (1 of 8 at N = 16, none at
// N = 8 or 4).  ref.POLY_SHARE holds the same number.
constexpr int kPolyShare = 2;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;      // the launch path's per-device flags

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 2^z on the FMA pipe.  z is clamped to [-127, 127] and split as j + f,
// j = rint(z), f in [-0.5, 0.5]; 2^f = 1 + f*q(f), q the degree-4 minimax
// fit of the relative error on [-0.5, 0.5], evaluated by Horner in f32
// (largest relative error 1.90e-7 over every f32 f, against 6.8e-8 for
// the fit in exact arithmetic); j is then added into the exponent bits.
// 2^f lies in [0.707, 1.415] and is 1 exactly at f = 0, so the exponent
// never wraps: for z in [-126, 127] the result is a normal float, for z
// below -126 it lies in [0, 2^-126), and it is exactly 0 for z <= -127.
__device__ __forceinline__ float exp2_poly(float z) {
  z = fminf(fmaxf(z, -127.f), 127.f);
  // 1.5 * 2^23: the sum's last place is 1, so it rounds z to j, which it
  // holds in its low mantissa bits: its bits are 0x4B400000 + j
  const float t = z + 12582912.f;
  const float f = z - (t - 12582912.f);
  float q = 0.0013202981790527701f;
  q = fmaf(q, f, 0.009674952365458012f);
  q = fmaf(q, f, 0.05551047623157501f);
  q = fmaf(q, f, 0.24022187292575836f);
  q = fmaf(q, f, 0.6931467056274414f);
  const float p = fmaf(q, f, 1.f);
  // (0x4B400000 + j) << 23 is j << 23 modulo 2^32
  return __uint_as_float(__float_as_uint(p) + (__float_as_uint(t) << 23));
}

struct Strides {  // element strides of (B, S) for one (B, S, *) tensor
  long long b, s;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of 16 bytes to a shared address; pred false reads nothing and
// fills zeros.  .cg (L2 only) for x and dt, read once; .ca for the B and
// C rows, which every warp of the batch row reads.
__device__ __forceinline__ void cp_async_cg(unsigned smem, const void* gmem,
                                            bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem),
               "l"(gmem), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_ca(unsigned smem, const void* gmem,
                                            bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem),
               "l"(gmem), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

// One warp's ring: kStages chunks of kSteps rows of its 32 channels' x and
// dt and of the batch row's B and C.
template <int N, typename TX, typename TD>
struct Ring {
  TX x[kStages][kSteps][32];
  TD dt[kStages][kSteps][32];
  float b[kStages][kSteps][N];
  float c[kStages][kSteps][N];
};

template <int N, typename TX, typename TD>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const TX* __restrict__ x, const TD* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, float* __restrict__ y, int S,
                int Din, Strides sx, Strides sdt) {
  constexpr int kHalf = N / 2;
  constexpr int kPoly = N * kPolyShare / 32;  // per half, its last
  constexpr int kXe = 16 / sizeof(TX), kDe = 16 / sizeof(TD);  // per 16 B
  constexpr int kXc = 32 / kXe, kDc = 32 / kDe;  // 16-byte chunks per row
  constexpr int kBc = N / 4;
  // steps unrolled: ptxas spaces the MUFU instructions evenly with the
  // whole chunk unrolled for bf16 x, and clusters them for f32 x unless
  // the unroll stops at 8 (scripts/ssd_probe.py times both)
  constexpr int kUnroll = sizeof(TX) == 4 ? 8 : kSteps;
  static_assert(kPoly <= kHalf && N % 4 == 0, "layout");
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Ring<N, TX, TD>& ring = reinterpret_cast<Ring<N, TX, TD>*>(smem)[warp];
  const int d0 = (blockIdx.x * kWarps + warp) * 32;
  if (d0 >= Din) return;   // the whole warp: no block-wide barrier follows
  const int b = blockIdx.y;
  const int d = d0 + lane;
  const bool valid = d < Din;   // Din % 8 == 0: 16-byte chunks are whole

  float a2[N], h[N];
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 av = valid
        ? reinterpret_cast<const float4*>(A + static_cast<size_t>(d) * N)[i]
        : make_float4(0.f, 0.f, 0.f, 0.f);
    a2[4 * i] = av.x * kLog2e;     a2[4 * i + 1] = av.y * kLog2e;
    a2[4 * i + 2] = av.z * kLog2e; a2[4 * i + 3] = av.w * kLog2e;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) h[i] = 0.f;

  const TX* xb = x + b * sx.b + d0;
  const TD* db = dt + b * sdt.b + d0;
  const float* bb = Bm + static_cast<size_t>(b) * S * N;
  const float* cb = Cm + static_cast<size_t>(b) * S * N;

  // Stage chunk ci: each lane issues its share of the 16-byte copies.
  // Rows past S are zero-filled (dt = 0 leaves h as it is, and their y
  // is not stored), as are columns past Din.
  auto load = [&](int ci) {
    const int st = ci % kStages, t0 = ci * kSteps;
#pragma unroll
    for (int i = lane; i < kSteps * kXc; i += 32) {
      const int r = i / kXc, c = (i % kXc) * kXe;
      const bool ok = t0 + r < S && d0 + c < Din;
      cp_async_cg(smem_addr(&ring.x[st][r][c]),
                  ok ? xb + (t0 + r) * sx.s + c : xb, ok);
    }
#pragma unroll
    for (int i = lane; i < kSteps * kDc; i += 32) {
      const int r = i / kDc, c = (i % kDc) * kDe;
      const bool ok = t0 + r < S && d0 + c < Din;
      cp_async_cg(smem_addr(&ring.dt[st][r][c]),
                  ok ? db + (t0 + r) * sdt.s + c : db, ok);
    }
#pragma unroll
    for (int i = lane; i < 2 * kSteps * kBc; i += 32) {
      const int j = i % (kSteps * kBc), r = j / kBc, c = (j % kBc) * 4;
      const bool ok = t0 + r < S, is_b = i < kSteps * kBc;
      const float* src = (is_b ? bb : cb) + static_cast<size_t>(t0 + r) * N;
      cp_async_ca(smem_addr(is_b ? &ring.b[st][r][c] : &ring.c[st][r][c]),
                  ok ? src + c : bb, ok);
    }
  };

  const int chunks = (S + kSteps - 1) / kSteps;
#pragma unroll
  for (int ci = 0; ci < kStages - 1; ++ci) {
    if (ci < chunks) load(ci);
    cp_async_commit();   // empty groups keep the count uniform
  }
  float* yp = y + static_cast<size_t>(b) * S * Din + d;
  for (int ci = 0; ci < chunks; ++ci) {
    cp_async_wait<kStages - 2>();   // this lane's copies of chunk ci
    __syncwarp();   // ... and every lane's; chunk ci - 1 is read by all
    if (ci + kStages - 1 < chunks) load(ci + kStages - 1);
    cp_async_commit();
    const int st = ci % kStages, t0 = ci * kSteps, rem = S - t0;
#pragma unroll kUnroll
    for (int r = 0; r < kSteps; ++r) {
      const float dv = to_f(ring.dt[st][r][lane]);
      const float dx = dv * to_f(ring.x[st][r][lane]);
      float bv[N], cv[N];
#pragma unroll
      for (int i = 0; i < N / 4; ++i) {
        const float4 b4 = reinterpret_cast<const float4*>(ring.b[st][r])[i];
        const float4 c4 = reinterpret_cast<const float4*>(ring.c[st][r])[i];
        bv[4 * i] = b4.x; bv[4 * i + 1] = b4.y;
        bv[4 * i + 2] = b4.z; bv[4 * i + 3] = b4.w;
        cv[4 * i] = c4.x; cv[4 * i + 1] = c4.y;
        cv[4 * i + 2] = c4.z; cv[4 * i + 3] = c4.w;
      }
      // h[n]*C[n] summed in order by fused multiply-adds
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float z = dv * a2[i];
        const float e = i % kHalf < kHalf - kPoly ? ex2(z) : exp2_poly(z);
        h[i] = fmaf(e, h[i], dx * bv[i]);
        acc = i == 0 ? h[0] * cv[0] : fmaf(h[i], cv[i], acc);
      }
      if (valid && r < rem) yp[static_cast<size_t>(t0 + r) * Din] = acc;
    }
  }
  cp_async_wait<0>();
}

template <int N, typename TX, typename TD>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, int B, int S, int Din, Strides sx,
           Strides sdt, cudaStream_t stream) {
  constexpr int kSmem = kWarps * sizeof(Ring<N, TX, TD>);
  auto kernel = ssd_scan_kernel<N, TX, TD>;
  // above 48 KB only after this, once per device and instantiation
  if constexpr (kSmem > 48 * 1024) {
    static bool smem_set[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess && dev >= kMaxDevices) err = cudaErrorInvalidDevice;
    if (err == cudaSuccess && !smem_set[dev])
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev] = true;
  }
  const dim3 grid((Din + kWarps * 32 - 1) / (kWarps * 32), B);
  kernel<<<grid, kThreads, kSmem, stream>>>(
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
// contiguous f32; y: (B, S, Din) contiguous f32.  N is 4, 8 or 16, Din a
// multiple of 8.  x_dtype, dt_dtype: 0 = bfloat16, 1 = float32.  Returns
// the cudaError_t of the launch.
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
