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
// Head dims: any Dh == Dv up to 128 whose rows are whole 16-byte chunks
// (the wrapper pads any other to the next such width in a copy).  Each
// kernel is built for a width DH in {16, 32, 64, 80, 128} and reads rows
// of dh <= DH elements: the chunks past dh are zero-filled in shared
// memory and in the q fragments (a cp.async of source size 0), so they add
// nothing to q k^T, and the output columns past dh are not stored.  dh 80
// (stablelm-3b) runs at its own width: five k16 steps of q k^T, ten n8
// tiles of P v, 176-byte padded rows that keep ldmatrix free of bank
// conflicts; dh 120 (h2o-danube) at 128, 6% of its work on zeros.
//
// Bound on this card: the tensor cores.  At smollm's prefill shape (B=4,
// S=1024, 9 heads over 3 kv heads, Dh=64, causal) the work is 4.8 GFLOP
// and 12.6 MB: 4.9 us at the bf16 peak, 3.8 us at the memory rate.  At
// jamba's (32 over 8 heads, Dh=128) it is 34.4 GFLOP, 35 us.
//
// bf16: FlashAttention-2 on mma.sync m16n8k16 (bf16 in, f32 out).  Grid
// (BH*G, ceil(Sq/64)), the G query heads of one kv head side by side so
// their k/v reads meet in L2, the last (costliest causal) query tiles
// first.  A block of 4 warps owns 64 query rows of one head, 16 per warp;
// each warp keeps its q fragments in registers for the whole block.  k/v
// tiles of 64 keys stream through a two-stage cp.async ring in shared
// memory, rows padded by 16 bytes so that ldmatrix reads are free of bank
// conflicts; v is read with ldmatrix.trans.  S = q k^T lands in f32
// registers; the online softmax runs there, in base 2 with scale*log2(e)
// folded into one multiply, row max and sum reduced over the four lanes
// that share a row.  P is rounded to bf16 in registers and used as the A
// operand of P v as it lies (the m16n8 accumulator layout is the m16n8k16
// A layout), so nothing quadratic leaves the registers.  That rounding of
// P (<= 2^-9 relative, P in [0, 1]) is the one the reference does not
// make (it keeps p in f32 for p v).  Masks come from global positions:
// kpos <= qpos (causal), kpos > qpos - window, kpos < Skv, applied only
// to the tiles that cross them; tiles wholly outside the causal window
// are skipped; rows past Sq and keys past Skv are zero-filled; a row that
// sees no key gives zeros.  What still bounds it: each warp reads the
// whole k/v tile from shared memory for its 16 rows, and at Dh 128 the
// registers leave room for two blocks per SM; wgmma, TMA and warp
// specialisation (FlashAttention-3) are the next step.
//
// f32: the CUDA cores in full f32 (TF32 would miss the reference's
// 2e-4).  Grid as above; a 64-thread block owns 64 query rows, one thread
// each, q staged once as f32, k/v tiles of 32 keys in a two-stage
// cp.async ring read as broadcasts.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace sm90 = repro_torch::sm90;

// ---- bf16: mma.sync ----------------------------------------------------------
constexpr int kTQ = 64;        // query rows per block, 16 per warp
constexpr int kTK = 64;        // keys per k/v tile
constexpr int kTWarps = 4;
constexpr int kTStages = 2;    // k/v ring depth

template <int DH>
__device__ __forceinline__ void load_kv_bf16(const bf16* __restrict__ kb,
                                             const bf16* __restrict__ vb,
                                             bf16* kd, bf16* vd, int kstart,
                                             int Skv, int dh) {
  constexpr int LD = DH + 8, CH = DH / 8;   // 16-byte chunks per row
  for (int c = threadIdx.x; c < kTK * CH; c += kTWarps * 32) {
    const int r = c / CH, e = (c % CH) * 8;
    const bool ok = kstart + r < Skv && e < dh;
    const size_t src = ok ? static_cast<size_t>(kstart + r) * dh + e : 0;
    sm90::cp_async16(kd + r * LD + e, kb + src, ok);
    sm90::cp_async16(vd + r * LD + e, vb + src, ok);
  }
  sm90::cp_async_commit();
}

template <int DH>
__global__ void __launch_bounds__(kTWarps * 32)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int G,
                  int Sq, int Skv, int dh, int causal, int window,
                  float scale_log2) {
  constexpr int LD = DH + 8;                  // padded smem row (elements)
  constexpr int KD = DH / 16;                 // k16 steps over the head dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);      // [stages][kTK][LD]
  bf16* vs = ks + kTStages * kTK * LD;               // [stages][kTK][LD]

  const int bhg = blockIdx.x;                        // (b*KVH + h)*G + g
  const int bh = bhg / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row0 = q0 + warp * 16 + g;               // and row0 + 8
  const bf16* qb = q + static_cast<size_t>(bhg) * Sq * dh;
  const bf16* kb = k + static_cast<size_t>(bh) * Skv * dh;
  const bf16* vb = v + static_cast<size_t>(bh) * Skv * dh;
  bf16* ob = o + static_cast<size_t>(bhg) * Sq * dh;

  // Key range this query tile can see; tiles outside it are skipped.
  const int q_last = min(q0 + kTQ, Sq) - 1;
  const int k_hi = causal ? min(Skv, q_last + 1) : Skv;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / kTK;
  const int t_hi = k_hi > k_lo ? (k_hi + kTK - 1) / kTK : t_lo;
  // the ring: tile t_lo + i in stage i % kTStages, kTStages - 1 tiles ahead
  // (a group is committed for every slot, empty past the last tile)
#pragma unroll
  for (int i = 0; i < kTStages - 1; ++i) {
    if (t_lo + i < t_hi)
      load_kv_bf16<DH>(kb, vb, ks + i * kTK * LD, vs + i * kTK * LD,
                       (t_lo + i) * kTK, Skv, dh);
    else
      sm90::cp_async_commit();
  }

  // q fragments (A of m16n8k16) straight from device memory, once
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + 8 * (i & 1), c = 16 * kk + 8 * (i >> 1) + 2 * t4;
      qf[kk][i] = r < Sq && c < dh ? *reinterpret_cast<const uint32_t*>(
                                         qb + static_cast<size_t>(r) * dh + c)
                                   : 0u;
    }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  // ldmatrix row addresses: lane l gives row l % 8 of matrix l / 8
  const int lr = lane % 8, lm = lane / 8;
  for (int t = t_lo; t < t_hi; ++t) {
    const int stage = (t - t_lo) % kTStages;
    const int ahead = (t - t_lo + kTStages - 1) % kTStages;
    if (t + kTStages - 1 < t_hi)
      load_kv_bf16<DH>(kb, vb, ks + ahead * kTK * LD, vs + ahead * kTK * LD,
                       (t + kTStages - 1) * kTK, Skv, dh);
    else
      sm90::cp_async_commit();
    sm90::cp_async_wait<kTStages - 1>();   // tile t has landed
    __syncthreads();
    const uint32_t kt = sm90::smem_u32(ks + stage * kTK * LD);
    const uint32_t vt = sm90::smem_u32(vs + stage * kTK * LD);

    // S (16 x 64 per warp) = q k^T: matrices (keys +0/+8) x (dims +0/+8)
    float s[kTK / 8][4];
#pragma unroll
    for (int j = 0; j < kTK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int jj = 0; jj < kTK / 16; ++jj) {
        uint32_t b[4];
        const int key = 16 * jj + lr + 8 * (lm >> 1);
        const int dim = 16 * kk + 8 * (lm & 1);
        sm90::ldmatrix_x4(b, kt + (key * LD + dim) * 2);
        sm90::mma_16816(s[2 * jj], qf[kk], b[0], b[1]);
        sm90::mma_16816(s[2 * jj + 1], qf[kk], b[2], b[3]);
      }

    // masks, only on tiles that cross an edge
    const int kbase = t * kTK;
    const bool edge = kbase + kTK > Skv ||
                      (causal && kbase + kTK - 1 > q0) ||
                      (window > 0 && kbase <= q0 + kTQ - 1 - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < kTK / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kpos = kbase + 8 * j + 2 * t4 + (i & 1);
          const int qpos = row0 + 8 * (i >> 1);
          const bool ok = kpos < Skv && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          if (!ok) s[j][i] = -INFINITY;
        }
    }

    // online softmax in base 2: rows row0 (i < 2) and row0 + 8 (i >= 2)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kTK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
    float m_use[2], corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h] * scale_log2);
      m_use[h] = m_new == -INFINITY ? 0.f : m_new;
      corr[h] = sm90::ex2(m[h] - m_use[h]);
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int j = 0; j < kTK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[j][i] = sm90::ex2(fmaf(s[j][i], scale_log2, -m_use[i >> 1]));
        l[i >> 1] += s[j][i];
      }
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] *= corr[i >> 1];

    // O += P v: P as bf16 A fragments; v tiles (keys +0/+8) x (dims +0/+8)
#pragma unroll
    for (int kk = 0; kk < kTK / 16; ++kk) {
      const uint32_t a[4] = {
          sm90::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          sm90::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          sm90::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          sm90::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dd = 0; dd < DH / 16; ++dd) {
        uint32_t b[4];
        const int key = 16 * kk + lr + 8 * (lm & 1);
        const int dim = 16 * dd + 8 * (lm >> 1);
        sm90::ldmatrix_x4_trans(b, vt + (key * LD + dim) * 2);
        sm90::mma_16816(acc[2 * dd], a, b[0], b[1]);
        sm90::mma_16816(acc[2 * dd + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // the next prefetch overwrites this stage
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.f / fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    const int c = 8 * n + 2 * t4;
    if (c >= dh) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      if (r < Sq)
        *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r) * dh + c) =
            sm90::pack_bf16(acc[n][2 * h] * inv[h],
                            acc[n][2 * h + 1] * inv[h]);
    }
  }
}

// ---- f32: CUDA cores ---------------------------------------------------------
constexpr int kBQ = 64;     // query rows per block (one thread each)
constexpr int kBK = 32;     // keys per k/v tile
constexpr int kStages = 2;  // k/v ring depth

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int DH>
__device__ __forceinline__ void load_kv_f32(const float* __restrict__ kb,
                                            const float* __restrict__ vb,
                                            float* kd, float* vd, int kstart,
                                            int Skv, int dh) {
  constexpr int CH = DH / 4;                 // 16-byte chunks per row
  for (int c = threadIdx.x; c < kBK * CH; c += kBQ) {
    const int r = c / CH, e = (c % CH) * 4;
    const bool ok = kstart + r < Skv && e < dh;
    const size_t src = ok ? static_cast<size_t>(kstart + r) * dh + e : 0;
    sm90::cp_async16(kd + r * DH + e, kb + src, ok);
    sm90::cp_async16(vd + r * DH + e, vb + src, ok);
  }
  sm90::cp_async_commit();
}

template <int DH>
__global__ void __launch_bounds__(kBQ)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int G,
                 int Sq, int Skv, int dh, int causal, int window,
                 float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int QS = DH + 4;                       // padded q row (floats)
  float* qs = reinterpret_cast<float*>(smem_raw);  // [kBQ][QS]
  float* ks = qs + kBQ * QS;                       // [kStages][kBK][DH]
  float* vs = ks + kStages * kBK * DH;             // [kStages][kBK][DH]

  const int bhg = blockIdx.x;                      // (b*KVH + h)*G + g
  const int bh = bhg / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int tid = threadIdx.x;
  const int qpos = q0 + tid;
  const float* qb = q + static_cast<size_t>(bhg) * Sq * dh;
  const float* kb = k + static_cast<size_t>(bh) * Skv * dh;
  const float* vb = v + static_cast<size_t>(bh) * Skv * dh;
  float* ob = o + static_cast<size_t>(bhg) * Sq * dh;

  // Stage the q tile (coalesced 16-byte loads; rows past Sq and columns
  // past dh are 0).
  for (int c = tid; c < kBQ * (DH / 4); c += kBQ) {
    const int r = c / (DH / 4), e = (c % (DH / 4)) * 4;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq && e < dh)
      f = ld4(qb + static_cast<size_t>(q0 + r) * dh + e);
    *reinterpret_cast<float4*>(qs + r * QS + e) = f;
  }

  // Key range this query tile can see; tiles outside it are skipped.
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int k_hi = causal ? min(Skv, q_last + 1) : Skv;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / kBK;
  const int t_hi = k_hi > k_lo ? (k_hi + kBK - 1) / kBK : t_lo;

  float m = -INFINITY, l = 0.f;
  float acc[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) acc[i] = 0.f;

  if (t_lo < t_hi) load_kv_f32<DH>(kb, vb, ks, vs, t_lo * kBK, Skv, dh);

  for (int t = t_lo; t < t_hi; ++t) {
    const int stage = (t - t_lo) & 1;
    if (t + 1 < t_hi) {
      load_kv_f32<DH>(kb, vb, ks + (stage ^ 1) * kBK * DH,
                      vs + (stage ^ 1) * kBK * DH, (t + 1) * kBK, Skv, dh);
      sm90::cp_async_wait<1>();
    } else {
      sm90::cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = ks + stage * kBK * DH;
    const float* vt = vs + stage * kBK * DH;

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
    for (int i = 0; i < DH; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = s[j];
#pragma unroll
      for (int d = 0; d < DH; d += 4) {
        const float4 vv = ld4(vt + j * DH + d);
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
    float* orow = ob + static_cast<size_t>(qpos) * dh;
#pragma unroll
    for (int d = 0; d < DH; d += 4)
      if (d < dh)
        *reinterpret_cast<float4*>(orow + d) =
            make_float4(acc[d] * inv, acc[d + 1] * inv, acc[d + 2] * inv,
                        acc[d + 3] * inv);
  }
}

// ---- launch ----------------------------------------------------------------

template <typename Kern>
int set_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int BH,
                int G, int Sq, int Skv, int dh, int causal, int window,
                float scale, cudaStream_t stream) {
  const size_t smem = 2 * kTStages * kTK * (D + 8) * sizeof(bf16);
  auto kern = flash_bf16_kernel<D>;
  if (int e = set_smem(kern, smem)) return e;
  const dim3 grid(BH * G, (Sq + kTQ - 1) / kTQ);
  kern<<<grid, kTWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), G, Sq, Skv, dh,
      causal, window, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int BH,
               int G, int Sq, int Skv, int dh, int causal, int window,
               float scale, cudaStream_t stream) {
  const size_t smem = (kBQ * (D + 4) + kStages * kBK * 2 * D) * sizeof(float);
  auto kern = flash_f32_kernel<D>;
  if (int e = set_smem(kern, smem)) return e;
  const dim3 grid(BH * G, (Sq + kBQ - 1) / kBQ);
  kern<<<grid, kBQ, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), G, Sq, Skv, dh,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           int BH, int G, int Sq, int Skv, int dh, int causal, int window,
           float scale, cudaStream_t s) {
  if (dh > D || dh * (dtype == 0 ? 2 : 4) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_bf16<D>(q, k, v, o, BH, G, Sq, Skv, dh, causal, window,
                          scale, s);
  if (dtype == 1)
    return launch_f32<D>(q, k, v, o, BH, G, Sq, Skv, dh, causal, window,
                         scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32.  Rows of dh elements (Dh == Dv, whole
// 16-byte chunks), computed at the built width `width` >= dh, one of
// {16, 32, 64, 80, 128} (kernels/flash_attention/ops.py: kernel_dims);
// window <= 0 means no sliding window.  Pointers 16-byte aligned and
// contiguous in the layout above (the Python wrapper checks).  Returns
// the cudaError_t of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int BH, int G,
                                      int Sq, int Skv, int dh, int width,
                                      int causal, int window, float scale,
                                      int dtype, void* stream) {
  if (BH <= 0 || G <= 0 || Sq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 16: return launch<16>(dtype, q, k, v, o, BH, G, Sq, Skv, dh, causal, window, scale, s);
    case 32: return launch<32>(dtype, q, k, v, o, BH, G, Sq, Skv, dh, causal, window, scale, s);
    case 64: return launch<64>(dtype, q, k, v, o, BH, G, Sq, Skv, dh, causal, window, scale, s);
    case 80: return launch<80>(dtype, q, k, v, o, BH, G, Sq, Skv, dh, causal, window, scale, s);
    case 128: return launch<128>(dtype, q, k, v, o, BH, G, Sq, Skv, dh, causal, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
