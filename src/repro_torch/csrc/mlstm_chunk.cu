// mLSTM chunkwise forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mlstm_chunk/kernel.py:
// mlstm_chunk (body _mlstm_kernel) and its layout wrapper ops.py:
// mlstm_chunk.  Per head, over the sequence in chunks of L steps:
//   F = cumsum(log_sigmoid(f)),  D[t,s] = F_t - F_s + i_s  (s <= t),
//   m_t = max(m_prev + F_t, max_s D[t,s])        (exact running max),
//   w = (q k^T / sqrt(Dh)) * exp(D - m_t),
//   y = (w v + (q C) e^{m_prev+F_t-m_t}) /
//       (max(|sum_s w + (q n) e^{m_prev+F_t-m_t}|, e^{-m_t}) + 1e-6),
// then the rank-L update of the matrix memory C (Dh x Dh), the
// normaliser n (Dh) and m.  Inputs bf16 or f32, arithmetic and output f32.
//
// The TPU kernel walks the chunks in order on one core with C (576 KiB
// of f32 at Dh = 384) in VMEM.  Here the work is cut in two passes, as in
// the chunkwise-parallel ("tiled flash linear attention") kernels:
//
// 1. State pass, grid (Dh/64 x Dh/64 tiles of C, B*H): a block owns one
//    64 x 64 tile of C in registers and walks the chunks, C = decay C +
//    (k upd)^T v, writing the state that enters each chunk (C, n and m)
//    to a scratch buffer.  The product of each chunk depends on no state;
//    only the elementwise combine is sequential.  The last chunk's update
//    is never needed.
// 2. Output pass, grid (Dh/64 column tiles, chunks, B*H): every chunk at
//    once.  A block computes the L x L scores q k^T and q C over head-dim
//    slices of 32, then the weights in registers (no scores in device
//    memory), the denominators, and w v, for 64 columns of the output.
//
// Chunk L = 64: a block's L x L weights are 16 x 64 per warp in registers.
// The states cost B*H*(S/L)*Dh^2 f32 written once and read once: 138 MB
// each way at the xlstm prefill (B=4, S=1024, H=4, Dh=384), about 0.08 ms
// at 3.35 TB/s; L = 128 would halve that but double the L x L work and the
// weights' registers.  Because m is the exact running max in any
// chunking, the output does not depend on L beyond rounding.  A ragged
// last chunk is masked.
//
// Every product runs on the tensor cores as TF32 mma.sync m16n8k8 with
// f32 accumulation.  bf16 inputs are exact in TF32.  An operand that is
// not (C, the weights w, k*upd, and every f32 input) is split into a TF32
// high part and a TF32 remainder and multiplied as hi*hi + hi*lo + lo*hi:
// single TF32 rounding of those operands puts the xlstm prefill output
// 2.4-7.4x outside the reference's 2e-3 (scripts/mlstm_tf32_error.py);
// the split keeps ~2^-22.
//
// Bound on this card: at B=4, S=1024, H=4, Dh=384 the inputs and output
// move ~63 MB (0.019 ms at 3.35 TB/s) and the chunkwise algorithm does
// ~10.5 GFLOP (0.011 ms at the bf16 peak).  The split products and the
// state traffic are what this design pays above that.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace sm90 = repro_torch::sm90;

constexpr int kL = 64;          // time steps per chunk
constexpr int kT = 64;          // C tile edge; output columns per block
constexpr int kDK = 32;         // head-dim slice of the output pass
constexpr int kThreads = 128;   // 4 warps, 16 rows of a 64-row tile each
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

struct Strides {            // element strides of (B, S, H) for one tensor
  long long b, s, h;
};

// x as a TF32 high part and the TF32 rounding of the remainder: the pair
// carries x to about 2^-23.  An exact operand (SPLIT false) has no
// remainder.
template <bool SPLIT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (SPLIT) {
    hi = sm90::tf32_rna(x);
    lo = sm90::tf32_rna(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

template <bool SPLIT, int N>
__device__ __forceinline__ void frag(const float (&x)[N], uint32_t (&hi)[N],
                                     uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split<SPLIT>(x[i], hi[i], lo[i]);
}

// c += a b with the remainders of the split operands: small terms first.
template <bool SA, bool SB>
__device__ __forceinline__ void mma(float c[4], const uint32_t ah[4],
                                    const uint32_t al[4], const uint32_t bh[2],
                                    const uint32_t bl[2]) {
  if constexpr (SA) sm90::mma_1688_tf32(c, al, bh);
  if constexpr (SB) sm90::mma_1688_tf32(c, ah, bl);
  sm90::mma_1688_tf32(c, ah, bh);
}

// Rows [0, rows) (at most kL) of a (S, dp) operand with row stride rs,
// columns [c0, c0 + W), into shared memory rows of LD elements, 16 bytes
// per cp.async; chunks past the rows or past column dp are zeroed.
template <typename T, int W, int LD>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long rs,
                                          int rows, int c0, int dp) {
  constexpr int kPer = 16 / sizeof(T), CH = W / kPer;
  for (int e = threadIdx.x; e < kL * CH; e += kThreads) {
    const int r = e / CH, col = (e % CH) * kPer;
    const bool ok = r < rows && c0 + col < dp;
    sm90::cp_async16(dst + r * LD + col,
                     ok ? src + r * rs + c0 + col : src, ok);
  }
}

// The gates of one chunk, by one warp, two steps per lane: the raw
// pre-activations (loaded ahead of use), then F (inclusive cumsum of
// log_sigmoid(f)) and, with m_prev, the running max m_t.  Steps at or
// past lc get i = 0 and log f = 0.
struct RawGates {
  float i0, i1, f0, f1;
};

struct Gates {
  float F0, F1, i0, i1, m0, m1;
};

template <typename T>
__device__ __forceinline__ RawGates load_gates(const T* ib, const T* fb,
                                               long long gs, int t0, int lc) {
  const int s0 = 2 * (threadIdx.x & 31), s1 = s0 + 1;
  RawGates r;
  r.i0 = s0 < lc ? to_f(ib[(t0 + s0) * gs]) : 0.f;
  r.i1 = s1 < lc ? to_f(ib[(t0 + s1) * gs]) : 0.f;
  r.f0 = s0 < lc ? to_f(fb[(t0 + s0) * gs]) : 0.f;
  r.f1 = s1 < lc ? to_f(fb[(t0 + s1) * gs]) : 0.f;
  return r;
}

__device__ __forceinline__ Gates chunk_gates(const RawGates& g, int lc,
                                             float m_prev) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int s0 = 2 * lane, s1 = s0 + 1;
  Gates r;
  r.i0 = g.i0;
  r.i1 = g.i1;
  const float a0 = s0 < lc ? log_sigmoid(g.f0) : 0.f;
  const float a1 = s1 < lc ? log_sigmoid(g.f1) : 0.f;
  float s = a0 + a1;
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(full, s, off);
    if (lane >= off) s += o;
  }
  float excl = __shfl_up_sync(full, s, 1);
  if (lane == 0) excl = 0.f;
  r.F0 = excl + a0;
  r.F1 = r.F0 + a1;
  // prefix max of i_s - F_s gives max_s D[t,s] = F_t + that
  const float p0 = r.i0 - r.F0, p1 = r.i1 - r.F1;
  float pm = fmaxf(p0, p1);
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(full, pm, off);
    if (lane >= off) pm = fmaxf(pm, o);
  }
  float pex = __shfl_up_sync(full, pm, 1);
  if (lane == 0) pex = kNeg;
  const float pm0 = fmaxf(pex, p0), pm1 = fmaxf(pm0, p1);
  r.m0 = fmaxf(m_prev + r.F0, r.F0 + pm0);
  r.m1 = fmaxf(m_prev + r.F1, r.F1 + pm1);
  return r;
}

// ---- pass 1: the state entering every chunk ---------------------------------
// grid (nt * nt, B*H), nt = dpad / kT.  States: C (B*H, NC, dpad, dpad),
// n (B*H, NC, dpad), m (B*H, NC).  Warp w owns rows dk0 + 16w .. + 15 of
// the tile.  The gates of chunk c + 1 are loaded while chunk c's update
// runs and scanned by warp 0 after it, so the next update finds them
// ready.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ ip, const T* __restrict__ fp,
                   float* __restrict__ Cst, float* __restrict__ nst,
                   float* __restrict__ mst, int S, int H, int dp, int dpad,
                   Strides sx, Strides sg, float inv_sqrt_dh) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int LD = kT + 8;    // conflict-free fragment reads, 16 B rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);        // [2][kL][LD]
  T* vs = ks + 2 * kL * LD;                      // [2][kL][LD]
  float* gu = reinterpret_cast<float*>(vs + 2 * kL * LD);  // [2][kL] upd
  float* gscal = gu + 2 * kL;                    // [2]: decay, m_new

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int nt = dpad / kT;
  const int dk0 = (blockIdx.x / nt) * kT, dv0 = (blockIdx.x % nt) * kT;
  const bool owns_n = blockIdx.x % nt == 0, owns_m = blockIdx.x == 0;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const T* kb = k + b * sx.b + h * sx.h;
  const T* vb = v + b * sx.b + h * sx.h;
  const T* ib = ip + b * sg.b + h * sg.h;
  const T* fb = fp + b * sg.b + h * sg.h;
  const int NC = (S + kL - 1) / kL;
  const int ra = 16 * warp + g;

  float acc[kT / 8][4];   // rows dk0 + ra (+8), columns dv0 + 8n + 2t4
#pragma unroll
  for (int n = 0; n < kT / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  float n_lo = 0.f, n_hi = 0.f;   // n at rows dk0 + ra, + 8
  float m_prev = kNeg;

  auto load_chunk = [&](int c) {
    const long long off = static_cast<long long>(c) * kL * sx.s;
    load_rows<T, kT, LD>(ks + (c & 1) * kL * LD, kb + off, sx.s, kL, dk0, dp);
    load_rows<T, kT, LD>(vs + (c & 1) * kL * LD, vb + off, sx.s, kL, dv0, dp);
    sm90::cp_async_commit();
  };
  // warp 0: the update weights of chunk c (whole: chunks before the last)
  auto gates = [&](const RawGates& raw, int c, float mp) {
    const Gates gt = chunk_gates(raw, kL, mp);
    const float F_last = __shfl_sync(0xffffffffu, gt.F1, 31);
    const float m_new = __shfl_sync(0xffffffffu, gt.m1, 31);
    float* u = gu + (c & 1) * kL;
    u[2 * lane] = expf(F_last - gt.F0 + gt.i0 - m_new) * inv_sqrt_dh;
    u[2 * lane + 1] = expf(F_last - gt.F1 + gt.i1 - m_new) * inv_sqrt_dh;
    if (lane == 0) {
      gscal[2 * (c & 1)] = expf(mp + F_last - m_new);
      gscal[2 * (c & 1) + 1] = m_new;
    }
  };
  if (NC > 1) {
    load_chunk(0);
    if (warp == 0) gates(load_gates(ib, fb, sg.s, 0, kL), 0, kNeg);
  }

  for (int c = 0; c < NC; ++c) {
    const size_t sc = static_cast<size_t>(bh) * NC + c;
    float* Cc = Cst + sc * dpad * dpad;
#pragma unroll
    for (int n = 0; n < kT / 8; ++n) {
      const int r = dk0 + ra, col = dv0 + 8 * n + 2 * t4;
      *reinterpret_cast<float2*>(Cc + static_cast<size_t>(r) * dpad + col) =
          make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(Cc + static_cast<size_t>(r + 8) * dpad +
                                 col) = make_float2(acc[n][2], acc[n][3]);
    }
    if (owns_n && t4 == 0) {
      nst[sc * dpad + dk0 + ra] = n_lo;
      nst[sc * dpad + dk0 + ra + 8] = n_hi;
    }
    if (owns_m && tid == 0) mst[sc] = m_prev;
    if (c == NC - 1) break;
    // chunks before the last are whole
    const bool next = c + 1 < NC - 1;
    if (next) load_chunk(c + 1);
    else sm90::cp_async_commit();
    RawGates raw;
    if (warp == 0 && next) raw = load_gates(ib, fb, sg.s, (c + 1) * kL, kL);
    sm90::cp_async_wait<1>();   // chunk c has landed
    __syncthreads();
    const float decay = gscal[2 * (c & 1)];
    m_prev = gscal[2 * (c & 1) + 1];
    const T* kt = ks + (c & 1) * kL * LD;
    const T* vt = vs + (c & 1) * kL * LD;
    const float* u = gu + (c & 1) * kL;
#pragma unroll
    for (int n = 0; n < kT / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] *= decay;
    // C += (k upd)^T v: A[dk][s] = k[s][dk] upd[s], B[s][dv] = v[s][dv];
    // n += sum_s A[dk][s] from the same fragments
    float s_lo = 0.f, s_hi = 0.f;
#pragma unroll 2
    for (int s0 = 0; s0 < kL; s0 += 8) {
      const float u0 = u[s0 + t4], u1 = u[s0 + t4 + 4];
      const float a[4] = {to_f(kt[(s0 + t4) * LD + ra]) * u0,
                          to_f(kt[(s0 + t4) * LD + ra + 8]) * u0,
                          to_f(kt[(s0 + t4 + 4) * LD + ra]) * u1,
                          to_f(kt[(s0 + t4 + 4) * LD + ra + 8]) * u1};
      s_lo += a[0] + a[2];
      s_hi += a[1] + a[3];
      uint32_t ah[4], al[4];
      frag<true>(a, ah, al);
#pragma unroll
      for (int n = 0; n < kT / 8; ++n) {
        const float bb[2] = {to_f(vt[(s0 + t4) * LD + 8 * n + g]),
                             to_f(vt[(s0 + t4 + 4) * LD + 8 * n + g])};
        uint32_t bh2[2], bl[2];
        frag<kF32>(bb, bh2, bl);
        mma<true, kF32>(acc[n], ah, al, bh2, bl);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      s_lo += __shfl_xor_sync(0xffffffffu, s_lo, off);
      s_hi += __shfl_xor_sync(0xffffffffu, s_hi, off);
    }
    n_lo = fmaf(decay, n_lo, s_lo);
    n_hi = fmaf(decay, n_hi, s_hi);
    if (warp == 0 && next) gates(raw, c + 1, m_prev);
    __syncthreads();   // the next prefetch overwrites this chunk's stage
  }
}

// ---- pass 2: the output of every chunk ----------------------------------------
// grid (dpad / kT column tiles, NC, B*H); y (B, S, H, dh) f32.
//
// Over the head-dim slices, warp w computes the scores of rows 16w .. +15
// (against the keys up to its last row) and, in a 2 x 2 arrangement of
// the warps, q C for rows 32(w/2) .. +31 and columns 32(w%2) .. +31, so
// that each C fragment, which must be split, serves two row tiles.  The
// weights then go through shared memory, split once, as the A operand of
// w v in the 2 x 2 arrangement.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_out_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ ip,
                 const T* __restrict__ fp, const float* __restrict__ Cst,
                 const float* __restrict__ nst, const float* __restrict__ mst,
                 float* __restrict__ y, int S, int H, int dh, int dp,
                 int dpad, Strides sx, Strides sg, float inv_sqrt_dh) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int QLD = kDK + (kF32 ? 4 : 8);  // q/k slice row (elements)
  constexpr int CLD = kT + 8;                // C slice row (floats)
  constexpr int VLD = kT + 8;                // v tile row (elements)
  constexpr int WLD = kL + 4;                // weights row (words)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* vs = reinterpret_cast<T*>(smem_raw);              // [kL][VLD]
  T* qs = vs + kL * VLD;                               // [2][kL][QLD]
  T* ksm = qs + 2 * kL * QLD;                          // [2][kL][QLD]
  float* Cs = reinterpret_cast<float*>(ksm + 2 * kL * QLD);  // [2][kDK][CLD]
  float* ns = Cs + 2 * kDK * CLD;                      // [2][kDK]
  float* gF = ns + 2 * kDK;                            // [kL] each:
  float* gi = gF + kL;
  float* gm = gi + kL;
  float* gdec = gm + kL;
  float* gqn = gdec + kL;
  float* gden = gqn + kL;
  // after the slices: the weights, split, over the q/k/C stages
  uint32_t* whi = reinterpret_cast<uint32_t*>(qs);     // [kL][WLD]
  uint32_t* wlo = whi + kL * WLD;                      // [kL][WLD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = warp >> 1, wc = warp & 1;
  const int dv0 = blockIdx.x * kT, c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / H, h = bh % H;
  const int NC = gridDim.y, t0 = c * kL, lc = min(kL, S - t0);
  const long long row0 = b * sx.b + h * sx.h + t0 * sx.s;
  const T* qb = q + row0;
  const T* kb = k + row0;
  const size_t sc = static_cast<size_t>(bh) * NC + c;
  const float* Cc = Cst + sc * dpad * dpad;
  const float* nc = nst + sc * dpad;
  const int n_slices = (dp + kDK - 1) / kDK;

  auto load_slice = [&](int sl) {
    const int st = sl & 1, d0 = sl * kDK;
    load_rows<T, kDK, QLD>(qs + st * kL * QLD, qb, sx.s, lc, d0, dp);
    load_rows<T, kDK, QLD>(ksm + st * kL * QLD, kb, sx.s, lc, d0, dp);
    // C rows d0.., columns dv0..: inside the padded state, always whole
    for (int e = tid; e < kDK * (kT / 4); e += kThreads) {
      const int r = e / (kT / 4), col = (e % (kT / 4)) * 4;
      sm90::cp_async16(Cs + (st * kDK + r) * CLD + col,
                       Cc + static_cast<size_t>(d0 + r) * dpad + dv0 + col,
                       true);
    }
    if (tid < kDK / 4)
      sm90::cp_async16(ns + st * kDK + 4 * tid, nc + d0 + 4 * tid, true);
    sm90::cp_async_commit();
  };
  load_rows<T, kT, VLD>(vs, v + row0, sx.s, lc, dv0, dp);
  load_slice(0);                        // one group with v

  if (warp == 0) {
    const float m_prev = mst[sc];
    const Gates gt = chunk_gates(
        load_gates(ip + b * sg.b + h * sg.h, fp + b * sg.b + h * sg.h, sg.s,
                   t0, lc), lc, m_prev);
    gF[2 * lane] = gt.F0;
    gF[2 * lane + 1] = gt.F1;
    gi[2 * lane] = gt.i0;
    gi[2 * lane + 1] = gt.i1;
    gm[2 * lane] = gt.m0;
    gm[2 * lane + 1] = gt.m1;
    gdec[2 * lane] = expf(m_prev + gt.F0 - gt.m0);
    gdec[2 * lane + 1] = expf(m_prev + gt.F1 - gt.m1);
  }

  float sc_[kL / 8][4];   // scores: rows 16 warp + g (+8), keys 8j + 2t4
  float acc[2][kT / 16][4];   // rows 32wr + 16mt + g (+8), cols 32wc + 8n
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < kL / 8; ++j) sc_[j][i] = 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int n = 0; n < kT / 16; ++n) acc[mt][n][i] = 0.f;
  }
  float qn = 0.f;
  const int ra = 16 * warp + g;         // score rows
  const int jmax = 2 * warp + 1;        // last key tile those rows see
  const int rc = 32 * wr + g;           // q C rows (and + 8, + 16, + 24)
  const int cc = 32 * wc + g;           // q C columns of the B fragments

  for (int sl = 0; sl < n_slices; ++sl) {
    if (sl + 1 < n_slices) load_slice(sl + 1);
    else sm90::cp_async_commit();
    sm90::cp_async_wait<1>();           // slice sl (and v) have landed
    __syncthreads();
    const T* qt = qs + (sl & 1) * kL * QLD;
    const T* kt = ksm + (sl & 1) * kL * QLD;
    const float* Ct = Cs + (sl & 1) * kDK * CLD;
#pragma unroll
    for (int kk = 0; kk < kDK / 8; ++kk) {
      const int d = 8 * kk + t4;
      {   // scores += q k^T
        const float a[4] = {to_f(qt[ra * QLD + d]),
                            to_f(qt[(ra + 8) * QLD + d]),
                            to_f(qt[ra * QLD + d + 4]),
                            to_f(qt[(ra + 8) * QLD + d + 4])};
        uint32_t ah[4], al[4];
        frag<kF32>(a, ah, al);
#pragma unroll
        for (int j = 0; j < kL / 8; ++j) {
          if (j > jmax) break;
          const float bb[2] = {to_f(kt[(8 * j + g) * QLD + d]),
                               to_f(kt[(8 * j + g) * QLD + d + 4])};
          uint32_t bh2[2], bl[2];
          frag<kF32>(bb, bh2, bl);
          mma<kF32, kF32>(sc_[j], ah, al, bh2, bl);
        }
      }
      // acc += q C
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = rc + 16 * mt;
        const float a[4] = {to_f(qt[r * QLD + d]), to_f(qt[(r + 8) * QLD + d]),
                            to_f(qt[r * QLD + d + 4]),
                            to_f(qt[(r + 8) * QLD + d + 4])};
        frag<kF32>(a, ah[mt], al[mt]);
      }
#pragma unroll
      for (int n = 0; n < kT / 16; ++n) {
        const float bb[2] = {Ct[d * CLD + cc + 8 * n],
                             Ct[(d + 4) * CLD + cc + 8 * n]};
        uint32_t bh2[2], bl[2];
        frag<true>(bb, bh2, bl);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma<kF32, true>(acc[mt][n], ah[mt], al[mt], bh2, bl);
      }
    }
    {   // q . n: two threads per row, 16 dims each
      const int r = tid >> 1, d0 = (tid & 1) * (kDK / 2);
      const float* nt = ns + (sl & 1) * kDK;
#pragma unroll
      for (int d = 0; d < kDK / 2; ++d)
        qn = fmaf(to_f(qt[r * QLD + d0 + d]), nt[d0 + d], qn);
    }
    __syncthreads();   // the next prefetch overwrites this stage
  }
  qn += __shfl_xor_sync(0xffffffffu, qn, 1);
  if ((tid & 1) == 0) gqn[tid >> 1] = qn;
  __syncwarp();        // row r's pair of threads is in the warp owning row r

  // weights w = scores / sqrt(Dh) * exp(D - m_t), split into shared
  // memory, their row sums and the denominators
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kL / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = ra + 8 * (i >> 1), s = 8 * j + 2 * t4 + (i & 1);
      const float w = (j <= jmax && s <= t)
          ? sc_[j][i] * inv_sqrt_dh * expf(gF[t] - gF[s] + gi[s] - gm[t])
          : 0.f;
      uint32_t wh, wl;
      split<true>(w, wh, wl);
      whi[t * WLD + s] = wh;
      wlo[t * WLD + s] = wl;
      rs[i >> 1] += w;
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
    rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
    const int t = ra + 8 * hh;
    if (t4 == 0)
      gden[t] = fmaxf(fabsf(rs[hh] + gqn[t] * gdec[t]), expf(-gm[t])) + 1e-6f;
  }
  __syncthreads();

  // acc = acc * decay + w v, rows rc (+8, +16, +24), keys up to the last
  // of them
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const float d0 = gdec[rc + 16 * mt], d1 = gdec[rc + 16 * mt + 8];
#pragma unroll
    for (int n = 0; n < kT / 16; ++n) {
      acc[mt][n][0] *= d0;
      acc[mt][n][1] *= d0;
      acc[mt][n][2] *= d1;
      acc[mt][n][3] *= d1;
    }
  }
  const int jw = 4 * wr + 3;
#pragma unroll
  for (int j = 0; j < kL / 8; ++j) {
    if (j > jw) break;
    const int s = 8 * j + t4;
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = rc + 16 * mt;
      ah[mt][0] = whi[r * WLD + s];
      ah[mt][1] = whi[(r + 8) * WLD + s];
      ah[mt][2] = whi[r * WLD + s + 4];
      ah[mt][3] = whi[(r + 8) * WLD + s + 4];
      al[mt][0] = wlo[r * WLD + s];
      al[mt][1] = wlo[(r + 8) * WLD + s];
      al[mt][2] = wlo[r * WLD + s + 4];
      al[mt][3] = wlo[(r + 8) * WLD + s + 4];
    }
#pragma unroll
    for (int n = 0; n < kT / 16; ++n) {
      const float bb[2] = {to_f(vs[s * VLD + cc + 8 * n]),
                           to_f(vs[(s + 4) * VLD + cc + 8 * n])};
      uint32_t bh2[2], bl[2];
      frag<kF32>(bb, bh2, bl);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        mma<true, kF32>(acc[mt][n], ah[mt], al[mt], bh2, bl);
    }
  }

  const long long ystep = static_cast<long long>(H) * dh;
  float* yb = y + (static_cast<long long>(b) * S + t0) * ystep +
              static_cast<long long>(h) * dh;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = rc + 16 * mt + 8 * hh;
      if (t >= lc) continue;
      const float inv = 1.f / gden[t];
      float* yr = yb + t * ystep;
#pragma unroll
      for (int n = 0; n < kT / 16; ++n) {
        const int col = dv0 + 32 * wc + 8 * n + 2 * t4;
        if (col < dh) yr[col] = acc[mt][n][2 * hh] * inv;
        if (col + 1 < dh) yr[col + 1] = acc[mt][n][2 * hh + 1] * inv;
      }
    }
}

template <typename Kern>
int set_smem(Kern kern, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* ip,
           const void* fp, float* scratch, void* y, int B, int S, int H,
           int dh, int dp, Strides sx, Strides sg, cudaStream_t stream) {
  constexpr bool kF32 = sizeof(T) == 4;
  const int dpad = (dp + kT - 1) / kT * kT, nt = dpad / kT;
  const int NC = (S + kL - 1) / kL, BH = B * H;
  float* Cst = scratch;
  float* nst = Cst + static_cast<size_t>(BH) * NC * dpad * dpad;
  float* mst = nst + static_cast<size_t>(BH) * NC * dpad;
  const float inv_sqrt_dh = 1.f / sqrtf(static_cast<float>(dh));

  const size_t smem1 =
      4 * kL * (kT + 8) * sizeof(T) + (2 * kL + 4) * sizeof(float);
  if (int e = set_smem(mlstm_state_kernel<T>, smem1)) return e;
  mlstm_state_kernel<T><<<dim3(nt * nt, BH), kThreads, smem1, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(ip), static_cast<const T*>(fp), Cst, nst, mst, S,
      H, dp, dpad, sx, sg, inv_sqrt_dh);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);

  constexpr int QLD = kDK + (kF32 ? 4 : 8), VLD = kT + 8;
  const size_t smem2 = (4 * kL * QLD + kL * VLD) * sizeof(T) +
                       (2 * kDK * (kT + 8) + 2 * kDK + 6 * kL) * sizeof(float);
  if (int e = set_smem(mlstm_out_kernel<T>, smem2)) return e;
  mlstm_out_kernel<T><<<dim3(nt, NC, BH), kThreads, smem2, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(ip),
      static_cast<const T*>(fp), Cst, nst, mst, static_cast<float*>(y), S, H,
      dh, dp, dpad, sx, sg, inv_sqrt_dh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: (B, S, H, *) rows of dp >= dh readable elements (dp a whole
// number of 16-byte chunks; elements past dh are zero), unit stride along
// the row and element strides qkv_b, qkv_s, qkv_h (the same for all three,
// multiples of 16 bytes, 16-byte aligned data); i_pre, f_pre: (B, S, H)
// with strides g_b, g_s, g_h; scratch: B*H*ceil(S/64) * (dpad^2 + dpad +
// 1) f32 with dpad = dp rounded up to 64, the states C, n and m entering
// every chunk; y: (B, S, H, dh) contiguous f32.  dtype: 0 = bfloat16, 1 = float32
// (all five inputs).  Launches the state pass and then the output pass on
// the stream; returns the first cudaError_t.
extern "C" int mlstm_chunk_launch(const void* q, const void* k,
                                  const void* v, const void* i_pre,
                                  const void* f_pre, void* scratch, void* y,
                                  int B, int S, int H, int dh, int dp,
                                  long long qkv_b, long long qkv_s,
                                  long long qkv_h, long long g_b,
                                  long long g_s, long long g_h, int dtype,
                                  void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || dh <= 0) return 0;
  if (dp < dh || B * H > 65535 || (S + kL - 1) / kL > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides sx{qkv_b, qkv_s, qkv_h}, sg{g_b, g_s, g_h};
  float* scr = static_cast<float*>(scratch);
  if (dtype == 0)
    return launch<bf16>(q, k, v, i_pre, f_pre, scr, y, B, S, H, dh, dp, sx,
                        sg, st);
  if (dtype == 1)
    return launch<float>(q, k, v, i_pre, f_pre, scr, y, B, S, H, dh, dp, sx,
                         sg, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
