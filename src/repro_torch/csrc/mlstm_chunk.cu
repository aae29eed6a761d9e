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
// The TPU kernel keeps the whole f32 C in VMEM: at Dh = 384 that is
// 576 KiB, and an SM has at most 227 KB of shared memory.  So block
// (j, b*H + h) of the main kernel owns the column slice
// C[:, 32j : 32j+32] (48 KiB at Dh = 384) and walks the whole sequence
// for that slice, with n and m, which every slice needs, recomputed in
// each block (Dh and 1 values per step: cheap).  The raw L x L scores
// q k^T of every chunk depend on no state, so a first kernel computes
// them once per chunk, all chunks in parallel, into a scratch buffer
// (B*H*S*L f32, 4 MiB at the prefill shape) that the column blocks read.
//
// Because m is the exact running max in any chunking, the output does not
// depend on the chunk length beyond rounding; the kernel uses L = 64
// whatever chunk the model asks for, and masks a ragged last chunk.
//
// Bound on this card: operations in f32, bytes in bf16.  At B=4, S=1024,
// H=4, Dh=384 the inputs and output move ~63 MB (0.019 ms at 3.35 TB/s)
// and the chunkwise algorithm does ~10.5 GFLOP.  This version runs on the
// f32 CUDA cores: register tiles of 4 rows x 2 columns fed by 16-byte
// shared-memory loads, head-dim tiles of 32 prefetched into registers
// while the previous tile is multiplied.  Tensor cores (mma.sync / wgmma)
// are the next step.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kL = 64;          // time steps per chunk
constexpr int kVt = 32;         // columns of C per block
constexpr int kDk = 32;         // head-dim rows per streamed tile
constexpr int kThreads = 256;
constexpr int kQt = kL + 4;     // row of the transposed q tile (16 B rows)
constexpr int kKs = kDk + 4;    // row of the k tile (16 B rows)
constexpr int kWt = kL + 4;     // row of the transposed weights
constexpr int kSp = kDk + 1;    // padded tile row in the scores kernel
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

struct Strides {            // element strides of (B, S, H) for one tensor
  long long b, s, h;
};

// Shared-memory floats of the main kernel at head dim dh (94 KiB at
// dh = 384, so two blocks fit on an SM; above dh ~ 1400 the launch is
// refused and the wrapper raises).
inline int smem_floats(int dh) {
  const int dp = (dh + kDk - 1) / kDk * kDk;
  return dp * kVt + dp + kDk * kQt + kL * kKs + kL * kVt + kL * kWt +
         8 * kL + 4;
}

// One 64 x 32 tile of a (S, dh) operand, rows t0.., columns d0.., as 8
// values per thread: element e = tid + 256 r is row e / 32, column e % 32
// (neighbouring threads on neighbouring columns).  Zero past the edges.
template <typename T>
__device__ __forceinline__ void load_tile(const T* base, long long row_stride,
                                          int t0, int lc, int d0, int dh,
                                          float (&r)[8]) {
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int e = threadIdx.x + kThreads * u;
    const int s = e >> 5, d = d0 + (e & 31);
    r[u] = (s < lc && d < dh)
               ? to_f(base[static_cast<long long>(t0 + s) * row_stride + d])
               : 0.f;
  }
}

// ---- kernel 1: raw scores P = q k^T of every chunk ------------------------
// grid (chunks, B*H); P is (B*H, chunks*kL, kL) f32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_scores_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    float* __restrict__ P, int S, int H, int dh,
                    Strides sx) {
  __shared__ float qs[kL * kSp];
  __shared__ float ks[kL * kSp];
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kL, lc = min(kL, S - t0);
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const T* qb = q + b * sx.b + h * sx.h;
  const T* kb = k + b * sx.b + h * sx.h;
  const int ty = tid >> 4, tx = tid & 15;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float rq[8], rk[8];
  for (int d0 = 0; d0 < dh; d0 += kDk) {
    load_tile(qb, sx.s, t0, lc, d0, dh, rq);
    load_tile(kb, sx.s, t0, lc, d0, dh, rk);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = tid + kThreads * u;
      qs[(e >> 5) * kSp + (e & 31)] = rq[u];
      ks[(e >> 5) * kSp + (e & 31)] = rk[u];
    }
    __syncthreads();
#pragma unroll 8
    for (int d = 0; d < kDk; ++d) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * kSp + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = ks[(tx + 16 * j) * kSp + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
  }
  float* pb = P + (static_cast<long long>(blockIdx.y) * gridDim.x * kL + t0) * kL;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pb[(ty + 16 * i) * kL + tx + 16 * j] = acc[i][j];
}

// ---- kernel 2: the recurrence, one 32-column slice of C per block ----------
// grid (ceil(dh / 32), B*H).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
mlstm_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ ip,
                   const T* __restrict__ fp, const float* __restrict__ P,
                   float* __restrict__ y, int S, int H, int dh, Strides sx,
                   Strides sg, float inv_sqrt_dh) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dp = (dh + kDk - 1) / kDk * kDk;
  float* Cs = smem;                   // (dp, kVt) slice of C
  float* ns = Cs + dp * kVt;          // (dp) normaliser
  float* qsT = ns + dp;               // (kDk, kQt) q tile, transposed
  float* ks = qsT + kDk * kQt;        // (kL, kKs) k tile times upd
  float* vs = ks + kL * kKs;          // (kL, kVt) v slice of the chunk
  float* wsT = vs + kL * kVt;         // (kL, kWt) weights, transposed
  float* gi = wsT + kL * kWt;         // input gate pre-activations
  float* gF = gi + kL;                // cumulative log forget gate
  float* gm = gF + kL;                // stabiliser m_t
  float* gdec = gm + kL;              // inter-chunk decay
  float* gden = gdec + kL;            // denominators
  float* gupd = gden + kL;            // state-update weights
  float* grs = gupd + kL;             // row sums of the weights
  float* gqn = grs + kL;              // q . n
  float* scal = gqn + kL;             // m_prev, decay_all, m_new

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = blockIdx.x * kVt;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const T* qb = q + b * sx.b + h * sx.h;
  const T* kb = k + b * sx.b + h * sx.h;
  const T* vb = v + b * sx.b + h * sx.h;
  const T* ib = ip + b * sg.b + h * sg.h;
  const T* fb = fp + b * sg.b + h * sg.h;
  const int n_chunks = (S + kL - 1) / kL;
  const float* pb = P + static_cast<long long>(blockIdx.y) * n_chunks * kL * kL;
  // y is (B, S, H, dh) contiguous
  float* yb = y + (static_cast<long long>(b) * S * H + h) * dh;
  const long long ys = static_cast<long long>(H) * dh;

  for (int e = tid; e < dp * kVt; e += kThreads) Cs[e] = 0.f;
  for (int e = tid; e < dp; e += kThreads) ns[e] = 0.f;
  if (tid == 0) scal[0] = kNeg;

  // (tg, cp): output rows 4tg..4tg+3, columns 2cp, 2cp+1 of the slice
  const int tg = tid >> 4, cp = tid & 15;
  // (ty, tx): score rows ty + 16i, columns tx + 16j
  const int ty = tid >> 4, tx = tid & 15;
  // (rr, part): one row in four parts, for q . n
  const int rr = tid >> 2, part = tid & 3;
  float pre[8];

  for (int t0 = 0; t0 < S; t0 += kL) {
    const int lc = min(kL, S - t0);
    __syncthreads();  // the previous chunk is done with vs, wsT, gates
    if (tid < kL) {
      const bool ok = tid < lc;
      const long long o = static_cast<long long>(t0 + tid) * sg.s;
      gi[tid] = ok ? to_f(ib[o]) : 0.f;
      gF[tid] = ok ? log_sigmoid(to_f(fb[o])) : 0.f;
    }
    for (int e = tid; e < kL * kVt; e += kThreads) {
      const int s = e / kVt, c = e % kVt, col = col0 + c;
      vs[e] = (s < lc && col < dh)
                  ? to_f(vb[static_cast<long long>(t0 + s) * sx.s + col])
                  : 0.f;
    }
    float praw[4][4];  // this chunk's raw scores, consumed in phase B
    {
      const float* pc = pb + static_cast<long long>(t0) * kL;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          praw[i][j] = pc[(ty + 16 * i) * kL + tx + 16 * j];
    }
    load_tile(qb, sx.s, t0, lc, 0, dh, pre);
    __syncthreads();

    // ---- gates: warp 0 scans the chunk, two steps per lane -------------
    if (warp == 0) {
      const unsigned full = 0xffffffffu;
      const float m_prev = scal[0];
      const float a0 = gF[2 * lane], a1 = gF[2 * lane + 1];
      float s = a0 + a1;
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(full, s, off);
        if (lane >= off) s += o;
      }
      float excl = __shfl_up_sync(full, s, 1);
      if (lane == 0) excl = 0.f;
      const float F0 = excl + a0, F1 = F0 + a1;
      // prefix max of i_s - F_s gives max_s D[t,s] = F_t + that
      const float p0 = gi[2 * lane] - F0, p1 = gi[2 * lane + 1] - F1;
      float pm = fmaxf(p0, p1);
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(full, pm, off);
        if (lane >= off) pm = fmaxf(pm, o);
      }
      float pex = __shfl_up_sync(full, pm, 1);
      if (lane == 0) pex = kNeg;
      const float pm0 = fmaxf(pex, p0), pm1 = fmaxf(pm0, p1);
      const float m0 = fmaxf(m_prev + F0, F0 + pm0);
      const float m1 = fmaxf(m_prev + F1, F1 + pm1);
      gF[2 * lane] = F0;
      gF[2 * lane + 1] = F1;
      gm[2 * lane] = m0;
      gm[2 * lane + 1] = m1;
      gdec[2 * lane] = expf(m_prev + F0 - m0);
      gdec[2 * lane + 1] = expf(m_prev + F1 - m1);
      __syncwarp();
      const float F_last = gF[lc - 1], m_new = gm[lc - 1];
      for (int u = 0; u < 2; ++u) {
        const int s2 = 2 * lane + u;
        gupd[s2] = s2 < lc
            ? expf(F_last - gF[s2] + gi[s2] - m_new) * inv_sqrt_dh : 0.f;
      }
      if (lane == 0) {
        scal[1] = expf(m_prev + F_last - m_new);
        scal[2] = m_new;
      }
    }

    // ---- phase A: q C (64 x 32) and q . n over head-dim tiles -----------
    float acc[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
    float qn = 0.f;
    for (int d0 = 0; d0 < dp; d0 += kDk) {
      __syncthreads();
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = tid + kThreads * u;
        qsT[(e & 31) * kQt + (e >> 5)] = pre[u];
      }
      __syncthreads();
      if (d0 + kDk < dp) load_tile(qb, sx.s, t0, lc, d0 + kDk, dh, pre);
#pragma unroll 8
      for (int d = 0; d < kDk; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(qsT + d * kQt + 4 * tg);
        const float2 c = *reinterpret_cast<const float2*>(Cs + (d0 + d) * kVt + 2 * cp);
        acc[0][0] = fmaf(a.x, c.x, acc[0][0]);
        acc[0][1] = fmaf(a.x, c.y, acc[0][1]);
        acc[1][0] = fmaf(a.y, c.x, acc[1][0]);
        acc[1][1] = fmaf(a.y, c.y, acc[1][1]);
        acc[2][0] = fmaf(a.z, c.x, acc[2][0]);
        acc[2][1] = fmaf(a.z, c.y, acc[2][1]);
        acc[3][0] = fmaf(a.w, c.x, acc[3][0]);
        acc[3][1] = fmaf(a.w, c.y, acc[3][1]);
      }
#pragma unroll
      for (int d = part; d < kDk; d += 4)
        qn = fmaf(qsT[d * kQt + rr], ns[d0 + d], qn);
    }
    qn += __shfl_xor_sync(0xffffffffu, qn, 1);
    qn += __shfl_xor_sync(0xffffffffu, qn, 2);
    if (part == 0) gqn[rr] = qn;

    // ---- phase B: weights, denominators, output -------------------------
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = ty + 16 * i;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = tx + 16 * j;
        const float w = s <= t
            ? praw[i][j] * inv_sqrt_dh * expf(gF[t] - gF[s] + gi[s] - gm[t])
            : 0.f;
        wsT[s * kWt + t] = w;
        rs += w;
      }
      // the 16 lanes tx = 0..15 of this row are neighbours in one warp
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      rs += __shfl_xor_sync(0xffffffffu, rs, 8);
      if (tx == 0) grs[t] = rs;
    }
    __syncthreads();
    if (tid < kL)
      gden[tid] = fmaxf(fabsf(grs[tid] + gqn[tid] * gdec[tid]),
                        expf(-gm[tid])) + 1e-6f;
    __syncthreads();
    {
      float o[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 8
      for (int s = 0; s < kL; ++s) {
        const float4 a = *reinterpret_cast<const float4*>(wsT + s * kWt + 4 * tg);
        const float2 c = *reinterpret_cast<const float2*>(vs + s * kVt + 2 * cp);
        o[0][0] = fmaf(a.x, c.x, o[0][0]);
        o[0][1] = fmaf(a.x, c.y, o[0][1]);
        o[1][0] = fmaf(a.y, c.x, o[1][0]);
        o[1][1] = fmaf(a.y, c.y, o[1][1]);
        o[2][0] = fmaf(a.z, c.x, o[2][0]);
        o[2][1] = fmaf(a.z, c.y, o[2][1]);
        o[3][0] = fmaf(a.w, c.x, o[3][0]);
        o[3][1] = fmaf(a.w, c.y, o[3][1]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = 4 * tg + r;
        if (t >= lc) continue;
        float* yr = yb + static_cast<long long>(t0 + t) * ys;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int col = col0 + 2 * cp + u;
          if (col < dh)
            yr[col] = (o[r][u] + acc[r][u] * gdec[t]) / gden[t];
        }
      }
    }

    // ---- phase C: C = decay C + (k upd)^T v,  n = decay n + sum k upd ---
    const float decay = scal[1];
    const int c = lane, dq = warp;  // rows 4dq..4dq+3 of the tile, column c
    load_tile(kb, sx.s, t0, lc, 0, dh, pre);
    for (int d0 = 0; d0 < dp; d0 += kDk) {
      __syncthreads();
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = tid + kThreads * u;
        ks[(e >> 5) * kKs + (e & 31)] = pre[u] * gupd[e >> 5];
      }
      __syncthreads();
      if (d0 + kDk < dp) load_tile(kb, sx.s, t0, lc, d0 + kDk, dh, pre);
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int s = 0; s < kL; ++s) {
        const float4 kk = *reinterpret_cast<const float4*>(ks + s * kKs + 4 * dq);
        const float vv = vs[s * kVt + c];
        a[0] = fmaf(kk.x, vv, a[0]);
        a[1] = fmaf(kk.y, vv, a[1]);
        a[2] = fmaf(kk.z, vv, a[2]);
        a[3] = fmaf(kk.w, vv, a[3]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float* cptr = Cs + (d0 + 4 * dq + r) * kVt + c;
        *cptr = fmaf(decay, *cptr, a[r]);
      }
      // n for the same four rows: lane l sums steps l and l + 32
      const float4 k0 = *reinterpret_cast<const float4*>(ks + lane * kKs + 4 * dq);
      const float4 k1 =
          *reinterpret_cast<const float4*>(ks + (lane + 32) * kKs + 4 * dq);
      float sn[4] = {k0.x + k1.x, k0.y + k1.y, k0.z + k1.z, k0.w + k1.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sn[r] += __shfl_xor_sync(0xffffffffu, sn[r], off);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (lane == r) {
          float* nptr = ns + d0 + 4 * dq + r;
          *nptr = fmaf(decay, *nptr, sn[r]);
        }
    }
    if (tid == 0) scal[0] = scal[2];
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* ip,
           const void* fp, void* scratch, void* y, int B, int S, int H,
           int dh, Strides sx, Strides sg, cudaStream_t stream) {
  const int n_chunks = (S + kL - 1) / kL;
  mlstm_scores_kernel<T><<<dim3(n_chunks, B * H), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<float*>(scratch), S, H, dh, sx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = sizeof(float) * smem_floats(dh);
  err = cudaFuncSetAttribute(mlstm_chunk_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((dh + kVt - 1) / kVt, B * H);
  mlstm_chunk_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(ip),
      static_cast<const T*>(fp), static_cast<const float*>(scratch),
      static_cast<float*>(y), S, H, dh, sx, sg,
      1.f / sqrtf(static_cast<float>(dh)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: (B, S, H, dh) with unit stride along dh and element strides
// qkv_b, qkv_s, qkv_h (the same for all three); i_pre, f_pre: (B, S, H)
// with strides g_b, g_s, g_h; scratch: B*H*ceil(S/64)*64*64 f32 for the
// raw scores; y: (B, S, H, dh) contiguous f32.  dtype: 0 = bfloat16,
// 1 = float32 (all five inputs).  Launches the scores kernel and then the
// recurrence on the stream; returns the first cudaError_t.
extern "C" int mlstm_chunk_launch(const void* q, const void* k,
                                  const void* v, const void* i_pre,
                                  const void* f_pre, void* scratch, void* y,
                                  int B, int S, int H, int dh,
                                  long long qkv_b, long long qkv_s,
                                  long long qkv_h, long long g_b,
                                  long long g_s, long long g_h, int dtype,
                                  void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || dh <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides sx{qkv_b, qkv_s, qkv_h}, sg{g_b, g_s, g_h};
  if (dtype == 0)
    return launch<__nv_bfloat16>(q, k, v, i_pre, f_pre, scratch, y, B, S, H,
                                 dh, sx, sg, st);
  if (dtype == 1)
    return launch<float>(q, k, v, i_pre, f_pre, scratch, y, B, S, H, dh, sx,
                         sg, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
