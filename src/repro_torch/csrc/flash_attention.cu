// Flash attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py: flash_attention (body
// _attn_kernel): blockwise online-softmax attention with GQA, causal and
// sliding-window masks from global positions; m, l and the accumulator
// in f32, output in q's dtype.  Layout as the reference kernel:
//   q (BH, G, Sq, Dh), k (BH, Skv, Dh), v (BH, Skv, Dv) -> o (BH, G, Sq, Dv)
// with BH = batch * kv_heads and G the query heads per kv head.
//
// Bound on this card: at the serving prefill shape (B=4, S=1024, 9 heads
// over 3 kv heads, Dh=64, causal) the work is 4.8 GFLOP and 12.6 MB, i.e.
// 4.9 us at the bf16 tensor-core peak and 3.8 us at the memory rate: the
// tensor cores bound it.  This first version does not reach them.  It
// keeps the FlashAttention dataflow -- nothing quadratic leaves the SM,
// each k/v tile is read from device memory once per query tile -- and
// computes on the f32 CUDA cores, where shared-memory bandwidth is the
// limit.  wgmma, TMA and warp specialisation are later work.
//
// Design.  Grid (BH*G, ceil(Sq/64)); one 64-thread block owns 64 query
// rows of one query head, one thread per row.  The q tile is staged once
// in shared memory as f32 (rows padded by 4 floats, so each thread's
// float4 reads of its own row are free of bank conflicts).  k/v tiles of
// 32 keys stream through a two-stage ring in shared memory, filled with
// cp.async so the next tile is in flight while the current one is used.
// A bf16 tile is widened to f32 once, by the whole block, into a tile of
// its own, so the inner loops read f32 alone whatever the input type;
// every thread reads the same k/v element at a time (a broadcast).
// Scores for the 32 keys of a tile and the Dv accumulators live in
// registers.  Masks come from global positions: kpos <= qpos (causal),
// kpos > qpos - window, kpos < Skv; the ragged Sq and Skv edges are
// masked here rather than asserted away.  Tiles wholly outside the causal
// window are skipped.  A row that sees no key at all produces zeros.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

using repro_torch::load8;
using repro_torch::store8;

constexpr int kBQ = 64;     // query rows per block (one thread each)
constexpr int kBK = 32;     // keys per k/v tile
constexpr int kStages = 2;  // k/v ring depth

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Widen n elements (a multiple of 8) of a shared-memory tile to f32.
template <typename T>
__device__ __forceinline__ void widen_tile(const T* src, float* dst, int n) {
  for (int c = threadIdx.x * 8; c < n; c += kBQ * 8) {
    float f[8];
    load8(src + c, f);
    store8(dst + c, f);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  // src-size 0 zero-fills the 16 bytes (rows past Skv).
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

template <typename T, int DH, int DV>
__device__ __forceinline__ void load_kv_tile(
    const T* __restrict__ kb, const T* __restrict__ vb, T* kd, T* vd,
    int kstart, int Skv) {
  constexpr int E = 16 / sizeof(T);        // elements per 16-byte chunk
  constexpr int KCH = DH / E, VCH = DV / E;
  for (int c = threadIdx.x; c < kBK * KCH; c += kBQ) {
    const int r = c / KCH, e = (c % KCH) * E;
    const bool ok = kstart + r < Skv;
    cp_async16(kd + r * DH + e,
               kb + static_cast<size_t>(ok ? kstart + r : 0) * DH + e, ok);
  }
  for (int c = threadIdx.x; c < kBK * VCH; c += kBQ) {
    const int r = c / VCH, e = (c % VCH) * E;
    const bool ok = kstart + r < Skv;
    cp_async16(vd + r * DV + e,
               vb + static_cast<size_t>(ok ? kstart + r : 0) * DV + e, ok);
  }
  cp_async_commit();
}

template <typename T, int DH, int DV>
__global__ void __launch_bounds__(kBQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int G, int Sq,
                 int Skv, int causal, int window, float scale) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int QS = DH + 4;                       // padded q row (floats)
  float* qs = reinterpret_cast<float*>(smem_raw);  // [kBQ][QS]
  T* ks = reinterpret_cast<T*>(qs + kBQ * QS);     // [kStages][kBK][DH]
  T* vs = ks + kStages * kBK * DH;                 // [kStages][kBK][DV]
  float* kf = reinterpret_cast<float*>(vs + kStages * kBK * DV);  // bf16:
  float* vf = kf + kBK * DH;                       // the widened tile

  const int bhg = blockIdx.x;                      // (b*KVH + h)*G + g
  const int bh = bhg / G;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int qpos = q0 + tid;
  const T* qb = q + static_cast<size_t>(bhg) * Sq * DH;
  const T* kb = k + static_cast<size_t>(bh) * Skv * DH;
  const T* vb = v + static_cast<size_t>(bh) * Skv * DV;
  T* ob = o + static_cast<size_t>(bhg) * Sq * DV;

  // Stage the q tile as f32 (coalesced 16-byte loads; rows past Sq are 0).
  for (int c = tid; c < kBQ * (DH / 8); c += kBQ) {
    const int r = c / (DH / 8), e = (c % (DH / 8)) * 8;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (q0 + r < Sq) load8(qb + static_cast<size_t>(q0 + r) * DH + e, f);
    float* dst = qs + r * QS + e;
    *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(f[4], f[5], f[6], f[7]);
  }

  // Key range this query tile can see; tiles outside it are skipped.
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int k_hi = causal ? min(Skv, q_last + 1) : Skv;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / kBK;
  const int t_hi = k_hi > k_lo ? (k_hi + kBK - 1) / kBK : t_lo;

  float m = -INFINITY, l = 0.f;
  float acc[DV];
#pragma unroll
  for (int i = 0; i < DV; ++i) acc[i] = 0.f;

  if (t_lo < t_hi)
    load_kv_tile<T, DH, DV>(kb, vb, ks, vs, t_lo * kBK, Skv);

  for (int t = t_lo; t < t_hi; ++t) {
    const int stage = (t - t_lo) & 1;
    if (t + 1 < t_hi) {
      load_kv_tile<T, DH, DV>(kb, vb, ks + (stage ^ 1) * kBK * DH,
                              vs + (stage ^ 1) * kBK * DV, (t + 1) * kBK,
                              Skv);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = kf;
    const float* vt = vf;
    if constexpr (kF32) {
      kt = ks + stage * kBK * DH;
      vt = vs + stage * kBK * DV;
    } else {
      widen_tile(ks + stage * kBK * DH, kf, kBK * DH);
      widen_tile(vs + stage * kBK * DV, vf, kBK * DV);
      __syncthreads();
    }

    float s[kBK];
#pragma unroll
    for (int j = 0; j < kBK; ++j) s[j] = 0.f;
    const float* qrow = qs + tid * QS;
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
      for (int j = 0; j < kBK; ++j) {
        const float4 kv = ld4(kt + j * DH + d);
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
        s[j] = fmaf(qv.z, kv.z, s[j]);
        s[j] = fmaf(qv.w, kv.w, s[j]);
      }
    }

    const int kbase = t * kBK;
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const int kpos = kbase + j;
      const bool ok = kpos < Skv && (!causal || kpos <= qpos) &&
                      (window <= 0 || kpos > qpos - window);
      s[j] = ok ? s[j] * scale : -INFINITY;
      mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float corr = __expf(m - m_use);
    float lsum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      s[j] = __expf(s[j] - m_use);
      lsum += s[j];
    }
    l = l * corr + lsum;
#pragma unroll
    for (int i = 0; i < DV; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = s[j];
#pragma unroll
      for (int d = 0; d < DV; d += 4) {
        const float4 vv = ld4(vt + j * DV + d);
        acc[d] = fmaf(p, vv.x, acc[d]);
        acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
      }
    }
    m = m_new;
    __syncthreads();  // the next prefetch overwrites this stage
  }

  if (qpos < Sq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* orow = ob + static_cast<size_t>(qpos) * DV;
#pragma unroll
    for (int d = 0; d < DV; d += 8) {
      float f[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = acc[d + i] * inv;
      store8(orow + d, f);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int G, int Sq, int Skv, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t widened = std::is_same<T, float>::value ? 0 : kBK * (D + D);
  const size_t smem = kBQ * (D + 4) * sizeof(float) +
                      kStages * kBK * (D + D) * sizeof(T) +
                      widened * sizeof(float);
  auto kern = flash_fwd_kernel<T, D, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(BH * G, (Sq + kBQ - 1) / kBQ);
  kern<<<grid, kBQ, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), G, Sq, Skv, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, void* o,
             int BH, int G, int Sq, int Skv, int causal, int window,
             float scale, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, BH, G, Sq, Skv, causal, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, BH, G, Sq, Skv, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, BH, G, Sq, Skv, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, BH, G, Sq, Skv, causal, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32.  Dh == Dv in {16, 32, 64, 128};
// window <= 0 means no sliding window.  Pointers 16-byte aligned and
// contiguous in the layout above (the Python wrapper checks).  Returns
// the cudaError_t of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int BH, int G,
                                      int Sq, int Skv, int dh, int dv,
                                      int causal, int window, float scale,
                                      int dtype, void* stream) {
  if (BH <= 0 || G <= 0 || Sq <= 0) return 0;
  if (dh != dv) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<__nv_bfloat16>(dh, q, k, v, o, BH, G, Sq, Skv, causal,
                                   window, scale, s);
  if (dtype == 1)
    return dispatch<float>(dh, q, k, v, o, BH, G, Sq, Skv, causal, window,
                           scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
